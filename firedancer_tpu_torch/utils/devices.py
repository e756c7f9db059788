"""Device resolution for the port's entry points.

Every entry point takes `device=None`, which means the CUDA card.  The CPU
runs only when the caller names it (`device="cpu"`, as the tests do); on a
host with no CUDA a call that names no device raises instead of quietly
running on the CPU.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """`None` -> torch.device("cuda"); anything else as torch.device.

    Raises RuntimeError when the resolved device is CUDA and this host has
    no CUDA device."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device on this host; pass device='cpu' to run the "
            "plain versions on the CPU"
        )
    return dev


def as_tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """numpy array or tensor -> contiguous tensor of `dtype` on `device`."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x)
    return x.to(device=device, dtype=dtype).contiguous()


def local_device_count(default: int = 1) -> int:
    """Local CUDA inventory for "auto" device specs (the verify pool, the
    bench's N-card mode): torch.cuda.device_count(), or `default` on a host
    with no card, so host-only configs never fail on a missing card.

    The counterpart of firedancer_tpu/utils/hostdev.py's
    local_device_count.  Its `enable_compilation_cache` needs no
    counterpart: utils/kbuild.py keeps every built kernel in _build/, keyed
    on the source, headers and flags, and reuses it."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return n if n > 0 else default
