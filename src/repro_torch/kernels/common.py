"""Backend and device resolution for the port's kernels, and the checks and
launch helpers their wrappers share.

"cuda"  — the hand-written CUDA kernel (CUDA tensors only)
"torch" — the plain PyTorch version of the same function; the CPU path, and
          on the card only the yardstick ``chip_smoke.py`` holds a kernel
          against
"auto"  — "cuda" for CUDA tensors, "torch" for CPU tensors

A kernel wrapper never falls back by itself: a kernel that fails to build
or launch raises. The only fall is the guard's ladder in
``repro_torch.sparse.resilience`` (torch -> dense, on the CPU only), which
counts every fall and records it as a ``fallback`` trace event; on the card
the guard counts a kernel's failure, quarantines it and raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Iterable

import torch

VALID_BACKENDS = ("auto", "cuda", "torch")


def check_operands(name: str, tensors: Dict[str, torch.Tensor],
                   ints: Iterable[str], aligned: Iterable[str]) -> None:
    """Raise unless every tensor shares the first one's device, the names
    in ``ints`` are int32 and the rest float32, all are contiguous, and the
    names in ``aligned`` start on 16 bytes (the kernels load them with
    16-byte vector loads)."""
    ints = tuple(ints)
    dev = next(iter(tensors.values())).device
    for key, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, "
                             f"expected {dev}")
        want = torch.int32 if key in ints else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name}: {key} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    for key in aligned:
        if tensors[key].data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned")


def launch_stream(dev: torch.device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``dev``, as the kernels' C interface
    takes it."""
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def raise_on_launch_error(name: str, err: int) -> None:
    """The C entry points return ``cudaGetLastError()`` after the launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


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
