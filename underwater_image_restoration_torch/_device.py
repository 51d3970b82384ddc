"""Device resolution for the port's entry points.

Entry points run on CUDA by default.  The CPU is used only when the caller
asks for it (``device="cpu"``), as the CPU tests do: a missing GPU is an
error, never a silent fallback.
"""
from __future__ import annotations

import torch


class CudaUnavailableError(RuntimeError):
    """Raised when an entry point needs CUDA and none is available."""


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the first CUDA device; it raises without one.  An
    explicit device is returned as given (a CUDA one is still checked)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise CudaUnavailableError(
            "CUDA is not available (torch.cuda.is_available() is False): "
            "this entry point runs on an NVIDIA GPU by default; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev
