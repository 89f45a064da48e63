#!/usr/bin/env python3
"""Time one checkout's ``decode_accum`` kernel at the service's codec shape,
with ``chip_smoke.py``'s payloads, checks, bound and timing.

    python3 scripts/time_decode_accum.py                   # this checkout's kernel
    python3 scripts/time_decode_accum.py --tree OTHER      # another checkout's kernel

At C = 1, 4 and 64 compressed RoBERTa-base rows, on each payload kind of
``chip_smoke.DECODE_KINDS``: the kernel against its plain version, whether
two calls give the same bits, and its eager and CUDA-graph times beside the
bound and the write floor; one JSON object per C and kind, then the card's
``nvidia-smi`` name and power limit.  Needs a CUDA card; run two trees in
turns in one command to compare them on one card.
"""
import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=ROOT)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_decode_accum: no CUDA device", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    # --tree's package first: chip_smoke's imports of repro_torch then find it
    sys.path.insert(0, os.path.join(tree, "src"))
    import repro_torch  # noqa: F401
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    card = cs.nvidia_smi()
    print(f"decode_accum from {cs.decode_accum.__code__.co_filename}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    size, block = cs.N_ROBERTA, cs.CODEC_BLOCK
    floor = cs.decode_floor(card)
    for C in (1, 4, 64):
        for kind in cs.DECODE_KINDS:
            a = cs.payloads_on_card(C, size, block, cs.CODEC_KB, gen, topk=kind == "top-k")
            err, rel = cs.decode_error(cs.decode_accum(*a, size=size, block=block),
                                       cs.decode_accum_plain(*a, size=size, block=block))
            same = cs.decode_repeats(a, size, block)
            torch.cuda.empty_cache()
            print(json.dumps(dict(tree=tree, C=C, payload=kind, acc_max_abs_err=err,
                                  sq_max_rel_err=rel, bitwise_repeat=same,
                                  write_floor_ms=floor, **cs.decode_time(a, kind, card))))
            del a
            torch.cuda.empty_cache()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
