"""Backend and device resolution for the port's kernels.

"cuda"  — the hand-written CUDA kernel (CUDA tensors only)
"torch" — the plain PyTorch version of the same function; the CPU path, and
          on the card only the yardstick ``chip_smoke.py`` holds a kernel
          against
"auto"  — "cuda" for CUDA tensors, "torch" for CPU tensors

There is no fallback: a kernel that fails to build or launch raises, and
nothing retries it on the plain version.
"""
from __future__ import annotations

import torch

VALID_BACKENDS = ("auto", "cuda", "torch")


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point places its tensors on. The card is the
    default; without one the caller must ask for the CPU explicitly."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; 'cuda' or 'cpu'")
    if dev.type == "cuda" and dev.index is None:
        # tensors report "cuda:N"; compare like with like
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def resolve_backend(backend: str, device) -> str:
    if backend not in VALID_BACKENDS:
        raise ValueError(f"backend must be one of {VALID_BACKENDS}, "
                         f"got {backend!r}")
    dev = torch.device(device)
    if backend == "auto":
        return "cuda" if dev.type == "cuda" else "torch"
    if backend == "cuda" and dev.type != "cuda":
        raise ValueError("backend='cuda' needs CUDA tensors; the operands "
                         f"live on {dev}")
    return backend
