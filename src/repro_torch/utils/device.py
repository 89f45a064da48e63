"""Where the port runs.  Entry points take ``device="cuda"`` by default and
never fall back to the CPU on their own: the CPU is used only when the
caller asks for it."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    return dev
