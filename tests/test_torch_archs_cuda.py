"""Reduced archs of the MoE slice on the card against the CPU (whose path
``tests/test_torch_archs.py`` holds against the JAX package).  Imports
neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_archs_cuda.py

Each test skips without a card.  Tolerances (f32): logits within 1e-4
absolute (the kernels sum in another order than the CPU's plain version;
``chip_smoke.py``'s small-model bound); greedy tokens equal.  The reduced
MoE config has capacity_factor = E / k, so no token drops.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models.transformer import forward_lm, init_lm
from repro_torch.serve.engine import Engine
from repro_torch.utils.pytree import tree_map


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch,d_model", [
    ("granite-moe-1b-a400m", 128),
    ("mixtral-8x7b", 128),
    ("stablelm-12b", 640),    # 4 heads of 160: stablelm-12b's head_dim on the card
    ("granite-20b", 128),     # one kv head
])
def test_reduced_arch_engine_on_the_card_matches_the_cpu(arch, d_model):
    dev = _card()
    cfg = reduce_config(get_config(arch), d_model=d_model)
    params = init_lm(cfg, torch.Generator().manual_seed(5), device="cpu")
    prompts = np.random.default_rng(6).integers(3, cfg.vocab_size, (3, 12))
    out = {}
    for where in ("cpu", "cuda"):
        p = tree_map(lambda x: x.to(where), params)
        tfa.reset_launches()
        res = Engine(cfg, p, max_len=32).generate(prompts, max_new_tokens=16)
        routes = dict(tfa.flash_attention.launches_by_route)
        with torch.inference_mode():
            lg, aux, _ = forward_lm(cfg, p, torch.as_tensor(res.tokens, device=where))
        out[where] = (res.tokens, lg.cpu(), float(aux), routes)
    assert dev.type == "cuda"
    np.testing.assert_array_equal(out["cpu"][0], out["cuda"][0])
    assert (out["cpu"][1] - out["cuda"][1]).abs().max().item() <= 1e-4
    assert out["cuda"][2] == pytest.approx(out["cpu"][2], rel=1e-4)
    # f32 prefill on the FMA route, one launch per layer; decode one per layer and step
    n = cfg.num_layers
    assert out["cuda"][3] == {"prefill_fma": n, "prefill_tc": 0, "decode": n * 15,
                              "decode_combine": n * 15, "decode_partial": 0, "decode_merge": 0}
    assert out["cpu"][3] == dict.fromkeys(out["cuda"][3], 0)
