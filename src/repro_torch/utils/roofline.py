"""Roofline terms of a step on an NVIDIA H100 (port of
``repro.utils.roofline``, whose constants are a TPU v5e's).

The dataclass, its properties and ``as_dict``'s keys are the reference's.
``compute_s`` divides by the peak of the step's compute dtype: the port
trains in f32 without TF32 (the CUDA cores' 67 TFLOP/s) and serves in bf16
(the tensor cores' 989).  ``bound_of`` is the least time one kernel could
take for its work, the larger of its bytes at the memory rate and its
operations at the peak, the ``bound_ms`` of every kernel's ``[time]`` line.

The constants are an H100 SXM5 80GB's, dense, from the NVIDIA H100 Tensor
Core GPU datasheet (SXM5 column).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

HBM_BW = 3.35e12          # bytes/s: HBM3 bandwidth (datasheet, SXM5)
BF16_FLOPS = 989e12       # FLOP/s: bf16 tensor cores, dense (datasheet: 1,979 with sparsity)
F32_FLOPS = 67e12         # FLOP/s: FP32 on the CUDA cores (datasheet)
NVLINK_BW = 450e9         # bytes/s a direction: NVLink 4, 900 GB/s total (datasheet)


def peak_flops(dtype) -> float:
    """FLOP/s of operations in ``dtype`` (a ``torch.dtype`` or its name,
    e.g. ``"bfloat16"``): bf16 on the tensor cores, anything else (f32
    without TF32) on the CUDA cores."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS


def bound_of(nbytes: float, flops: float, peak: float = F32_FLOPS) -> Tuple[float, str]:
    """``(bound_ms, bound_by)``: the larger of ``nbytes`` at ``HBM_BW`` and
    ``flops`` at ``peak`` (f32's unless given), and which of the two it is
    (``"bytes"`` or ``"operations"``)."""
    b, o = nbytes / HBM_BW * 1e3, flops / peak * 1e3
    return max(b, o), "bytes" if b >= o else "operations"


@dataclass
class Roofline:
    """All quantities are per-chip, per-step."""

    flops: float              # FLOPs one chip executes (utils.op_counts)
    hbm_bytes: float          # bytes one chip moves (utils.op_counts)
    collective_bytes: float   # bytes crossing one chip's links
    model_flops: float        # 6·N(_active)·D tokens-math, per chip
    chips: int
    dtype: str = "bfloat16"   # the step's compute dtype: which peak compute_s divides by

    @property
    def peak(self) -> float:
        return peak_flops(self.dtype)

    @property
    def compute_s(self) -> float:
        return self.flops / self.peak

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs — catches recomputation and waste."""
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def step_time_s(self) -> float:
        """Roofline-model step time: max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization implied by the roofline step time."""
        t = self.step_time_s
        return (self.model_flops / self.peak) / t if t else 0.0

    def as_dict(self) -> Dict:
        return {
            "flops_per_chip": self.flops,
            "hbm_bytes_per_chip": self.hbm_bytes,
            "collective_bytes_per_chip": self.collective_bytes,
            "model_flops_per_chip": self.model_flops,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_step_s": self.step_time_s,
            "roofline_mfu": self.mfu,
            "dtype": self.dtype,
            "peak_flops": self.peak,
        }


def model_flops_per_step(n_params_active: int, tokens: int, *, training: bool) -> float:
    """6·N·D for a train step (fwd+bwd); 2·N·D for inference."""
    c = 6.0 if training else 2.0
    return c * n_params_active * tokens
