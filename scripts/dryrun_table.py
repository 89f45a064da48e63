#!/usr/bin/env python3
"""Print a markdown table of dry-run artifacts, partitioned beside an older
(unpartitioned) run of the same cells.

    python3 scripts/dryrun_table.py NEW_DIR [OLD_DIR]

``NEW_DIR`` and ``OLD_DIR`` hold ``python -m repro_torch.launch.dryrun ...
--out DIR`` artifacts (``<arch>__<shape>__<mesh>[__<strategy>].json``);
``OLD_DIR`` is typically a parent tree's run, unpacked with ``git archive``.
A row for each artifact of ``NEW_DIR``: FLOPs a chip, the three roofline
terms (compute, memory, collective) in ms, the collective bytes a chip by
axis, the peak a slot, the traced grid and its seconds; and, where
``OLD_DIR`` has the same cell, its FLOPs a chip, memory term and peak.
These are counts of the meta device's trace (``utils.op_counts``) at the
H100's constants (``utils.roofline``), not times measured on a card."""
import json
import os
import sys


def load(d):
    out = {}
    for name in sorted(os.listdir(d)):
        if name.endswith(".json"):
            res = json.load(open(os.path.join(d, name)))
            if res.get("ok"):
                out[name] = res
    return out


def main(argv):
    new = load(argv[1])
    old = load(argv[2]) if len(argv) > 2 else {}
    print("| arch | shape | mesh | traced (s) | FLOPs/chip | compute ms | memory ms | "
          "collective ms | collective GB/chip by axis | peak GiB/slot | unpartitioned "
          "FLOPs/chip | memory ms | peak GiB |")
    print("|" + "---|" * 13)
    for name, r in new.items():
        roof, t, mem = r["roofline"], r["traced"], r["memory_analysis"]
        axes = ", ".join(f"{a} {sum(k['bytes_per_slot'] for k in kinds.values()) / 1e9:.3g}"
                         for a, kinds in r["collectives"]["by_axis"].items())
        grid = "x".join(str(n) for n in t["grid"].values())
        o = old.get(name)
        tail = (f"{o['roofline']['flops_per_chip']:.4g} | {o['roofline']['memory_s'] * 1e3:.3f} | "
                f"{o['memory_analysis']['peak_memory_in_bytes'] / 2**30:.2f}" if o else "- | - | -")
        print(f"| {r['arch']} | {r['shape']} | {r.get('mesh')} {r.get('strategy', 'sync')} | "
              f"{grid} ({t['trace_s']:.1f}) | {roof['flops_per_chip']:.4g} | "
              f"{roof['compute_s'] * 1e3:.3f} | {roof['memory_s'] * 1e3:.3f} | "
              f"{roof['collective_s'] * 1e3:.3f} | {axes} | "
              f"{mem['peak_memory_in_bytes'] / 2**30:.2f} | {tail} |")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
