"""Build, load and count the hand-written CUDA kernels of ``csrc/``.

The sources are compiled with ``nvcc`` for ``sm_90a`` (H100) at first use,
one ``nvcc -c`` per source started together, then linked into one shared
library with a plain C interface and loaded with ``ctypes``. The library is
cached under ``build/torch_kernels/`` beside the package, named by a hash of
the sources and flags, so an edited source is rebuilt.

Each wrapper (``ops/sweep_cuda.py``, ``ops/resample_cuda.py``,
``ops/denoise_cuda.py``) adds to ``LAUNCHES[name]`` the kernel launches it
makes, and nowhere else, so a run can show that the main path went through
the kernels.
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

import torch

SOURCES = ("sweep.cu", "resample.cu", "tvl1.cu")
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
# -fmad=false: no FMA contraction, so each kernel rounds every operation as
# its plain version does. The sweep's sub-plane refinement and 200 TV-L1
# iterations amplify rounding differences far past the parity tolerances
# (csrc/sweep.cu, csrc/tvl1.cu).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC",
)

# launches per kernel; plain integers, reset with reset_launches()
LAUNCHES = {"sweep": 0, "resample_rows": 0, "resample_cols": 0, "tvl1": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "remode_sweep": [_P] * 9 + [_I] * 5 + [_F, _I, _P],
    "remode_sweep_lanes": [_P] * 9 + [_I] * 5 + [_F, _I, _P, _P],
    "remode_resample_rows": [_P] * 3 + [_I] * 4 + [_P],
    "remode_resample_cols": [_P] * 3 + [_I] * 4 + [_P],
    "remode_tvl1": [_P] * 10 + [_I] * 3 + [_F] * 4 + [_P, _P],
}

_lib = None
_lib_lock = threading.Lock()  # the node's worker thread launches TV-L1
build_seconds = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    path = shutil.which("nvcc")
    if path is None and CUDA_HOME is not None:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
    if path is None or not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _library_path(csrc: Path, build_dir: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((csrc / name).read_bytes())
    return build_dir / f"libremode_kernels_{h.hexdigest()[:16]}.so"


def _build(csrc: Path, target: Path) -> None:
    nvcc = _nvcc()
    target.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        objs = [Path(tmp) / (name + ".o") for name in SOURCES]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(csrc / name), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for name, obj in zip(SOURCES, objs)
        ]
        errors = []
        for name, p in zip(SOURCES, procs):
            out, _ = p.communicate()
            if p.returncode != 0:
                errors.append(f"{name}:\n{out}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp_lib = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        os.replace(tmp_lib, target)


def build(csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> Path:
    """The shared library of the kernels in ``csrc``, built unless a cached
    copy matches the sources and flags. Raises if nvcc is missing or the
    build fails."""
    target = _library_path(Path(csrc), Path(build_dir))
    if not target.exists():
        _build(Path(csrc), target)
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library, built and loaded once, at first use, by
    whichever thread comes first. Raises if CUDA or nvcc is missing or the
    build fails."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: the kernels need a GPU")
        t0 = time.perf_counter()
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        build_seconds = time.perf_counter() - t0
        _lib = lib
        return lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, shape=None, dtype=torch.float32) -> None:
    """Validate a kernel argument: CUDA, dtype, contiguity and shape."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
