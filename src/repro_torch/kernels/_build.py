"""Build and load the port's CUDA sources.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is compiled
with ``nvcc`` for ``sm_90a`` into ``build/repro_torch/<name>-<hash>.so``
under the repository root, the hash taken over the source and the flags,
and loaded with ``ctypes``. Nothing is compiled at import time: the CPU
tests import every module on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

from ..obs import trace as obs_trace

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on first "
                       "use and need the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless the hashed library exists; the
    library is written to a temporary name and renamed into place, so
    concurrent builders never load a half-written file."""
    return _build(name)[0]


def _build(name: str) -> Tuple[Path, bool]:
    """(the library, whether nvcc ran for it)."""
    out = library_path(name)
    if out.exists():
        return out, False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=out.name + ".", suffix=".tmp",
                               dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, True


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use. The
    first use in a process is a ``compile`` span: ``key`` the library's
    name, ``built`` whether nvcc ran (else the hashed ``.so`` was found)
    and the ``seconds`` it took."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            t0 = time.monotonic()
            with obs_trace.span("compile", name, key=name) as ev:
                path, built = _build(name)
                lib = _LIBS[name] = ctypes.CDLL(str(path))
                ev.update(built=built, seconds=time.monotonic() - t0)
        return lib


def function(source: str, name: str, argtypes):
    """The C entry point ``name`` of ``csrc/<source>.cu`` with its argument
    types set; it returns the launch's ``cudaGetLastError()``."""
    fn = getattr(load(source), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn
