"""Build the port's CUDA kernels with nvcc and call them through ctypes.

Each ``csrc/*.cu`` file has a plain C interface and compiles on its own
into ``_build/<name>-<hash>.so`` (``.gitignore`` lists ``_build/``) the
first time one of its kernels is launched, or all together through
:func:`build_all`. The hash covers the source, the shared ``*.cuh``
headers and the flags, so an edited source or header is rebuilt. Nothing
here runs at import time: the CPU-only test host has no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
# --fmad=false: no multiply-add contraction, so each kernel rounds its
# arithmetic exactly as the plain PyTorch version beside it does.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _target(source: str) -> Path:
    src = CSRC / source
    h = hashlib.sha256()
    for part in (src, *sorted(CSRC.glob("*.cuh"))):
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:12]}.so"


def _compile_cmd(source: str, out: Path) -> list[str]:
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / source)]


def build_all(sources: list[str] | None = None) -> dict[str, float]:
    """Compile every kernel source at once (one nvcc each, in parallel).

    Returns the seconds each build took; sources already built take 0.
    """
    sources = sources or sorted(p.name for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(exist_ok=True)
    procs, times = {}, {}
    t0 = time.perf_counter()
    for s in sources:
        target = _target(s)
        if target.exists():
            times[s] = 0.0
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        procs[s] = (subprocess.Popen(
            _compile_cmd(s, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        ), tmp, target)
    failed = []
    for s, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        times[s] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{s}:\n{out}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return times


def _load(source: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            target = _target(source)
            if not target.exists():
                build_all([source])
            lib = ctypes.CDLL(str(target))
            lib.spe_error_string.argtypes = [ctypes.c_int]
            lib.spe_error_string.restype = ctypes.c_char_p
            _libs[source] = lib
        return lib


class Kernel:
    """One exported C launcher of a ``csrc`` source, with its launch count.

    ``launches`` counts successful launches only; :meth:`launch` raises
    when the C function reports a CUDA error.
    """

    def __init__(self, name: str, source: str, argtypes: list):
        self.name = name
        self.source = source
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def _function(self):
        if self._fn is None:
            fn = getattr(_load(self.source), self.name)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        """Call the launcher on the current device's current stream. The raw
        stream handle is read directly, not through the ``torch.cuda.Stream``
        object that ``torch.cuda.current_stream()`` builds on every call."""
        fn = self._function()
        err = fn(*args, torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice()))
        if err != 0:
            msg = _load(self.source).spe_error_string(err).decode()
            raise RuntimeError(f"{self.name}: CUDA error {err} ({msg})")
        self.launches += 1


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_cuda_tensor(name: str, t: torch.Tensor, dtype, shape_len: int | None = None):
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype``. (``is_cuda``
    rather than ``device.type``: it builds no device object, on every launch.)"""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: expected dtype in {dtypes}, got {t.dtype}")
    if shape_len is not None and t.dim() != shape_len:
        raise ValueError(f"{name}: expected {shape_len} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def check_word_aligned(name: str, t: torch.Tensor) -> None:
    """Raise unless ``t`` starts on a 4-byte boundary: the int8 kernels load
    4 channels of an activation as one 32-bit word."""
    if t.data_ptr() % 4:
        raise ValueError(f"{name}: expected a tensor starting on a 4-byte boundary")
