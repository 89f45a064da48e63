"""Launch a built kernel on the current stream of a tensor's card."""
from __future__ import annotations

import threading
from typing import Callable

import torch

# the wrappers bump their ``launches`` counters under this lock: a serving
# worker's request, scheduler and follower threads and the daemon launch
# kernels concurrently, and ``x += 1`` on a function attribute is not atomic
COUNT_LOCK = threading.Lock()


def launch_on(t: torch.Tensor, fn: Callable[..., int], *args) -> int:
    """``fn(*args, stream)``, where ``stream`` is the raw handle of the
    current stream of ``t``'s card, with that card made current only when
    it is not already: a kernel's C entry point takes the handle last and
    returns its CUDA error.  ``torch.cuda.current_stream()`` builds a Stream
    object, about 9 us a call on an H100 host against 0.1 us for the raw
    handle, and entering ``torch.cuda.device`` costs a few microseconds
    more; the decode path makes one call per layer and step."""
    index = t.get_device()
    if index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
