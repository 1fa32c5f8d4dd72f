"""Host IO of the port (counterpart of
``rpg_open_remode_tpu/native/__init__.py``): the depth-file parse in C++,
with a numpy version of the same semantics, and the PLY writer and PGM
reader in numpy.

``remode_native.cpp`` is built with the system ``g++`` at first use into
``build/native/`` beside the package, named by a hash of the source, and
loaded with ``ctypes``. Without a compiler (or if the build fails) the
parse uses its numpy version, which reads the same values; ``backend()``
says which one runs. This is host IO, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "remode_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"

_lock = threading.Lock()
_lib = None
_tried = False


def _library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"_remode_native_{digest}.so"


def _build(target: Path) -> bool:
    """Compile into a temporary file and rename it into place, so that
    processes building at once never load a half-written library."""
    try:
        target.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
        os.close(fd)
        try:
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, str(SRC)],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, target)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def get_lib():
    """The loaded ctypes library, or None if it cannot be built or loaded."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        target = _library_path()
        if not target.exists() and not _build(target):
            return None
        try:
            lib = ctypes.CDLL(str(target))
        except OSError:
            return None
        lib.rmd_parse_float_file.restype = ctypes.c_long
        lib.rmd_parse_float_file.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_float,
        ]
        _lib = lib
        return _lib


def backend() -> str:
    """``"native"`` when the C++ library is loaded, else ``"numpy"``."""
    return "native" if get_lib() is not None else "numpy"


# -- numpy version -------------------------------------------------------------


def parse_float_file_numpy(path: str, count: int, scale: float = 1.0) -> np.ndarray:
    with open(path) as f:
        vals = np.array(f.read().split(), dtype=np.float32)
    if vals.size < count:
        raise ValueError(f"{path}: expected {count} floats, found {vals.size}")
    return vals[:count] * scale


# -- entry points --------------------------------------------------------------


def parse_float_file(path: str, count: int, scale: float = 1.0) -> np.ndarray:
    """Parse ``count`` whitespace-separated floats, scaled. The dataset's
    .depth files store centimetres; pass scale=0.01 for metres
    (test/dataset.cpp:180)."""
    lib = get_lib()
    if lib is None:
        return parse_float_file_numpy(path, count, scale)
    out = np.empty(count, np.float32)
    n = lib.rmd_parse_float_file(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), count, scale
    )
    if n == count:
        return out
    if n >= 0:
        raise ValueError(f"{path}: expected {count} floats, found {n}")
    raise FileNotFoundError(path)


def write_ply(path: str, xyz: np.ndarray, intensity: np.ndarray) -> None:
    """Binary little-endian PLY with per-point intensity (the file-export
    analog of the reference's PointXYZI cloud, src/publisher.cpp:69-104), in
    numpy: the native writer was no faster (chip_smoke.py's host IO timing
    on the H100 machine's host)."""
    xyz = np.ascontiguousarray(xyz, np.float32).reshape(-1, 3)
    intensity = np.ascontiguousarray(intensity, np.float32).reshape(-1)
    if xyz.shape[0] != intensity.shape[0]:
        raise ValueError(f"{xyz.shape[0]} points but {intensity.shape[0]} intensities")
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {xyz.shape[0]}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property float intensity\nend_header\n"
    )
    data = np.concatenate([xyz, intensity[:, None]], axis=1).astype("<f4")
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(data.tobytes())


def read_pgm(path: str) -> np.ndarray:
    """Binary 8-bit PGM (P5) -> uint8 [H, W]: one header parse and one read,
    in numpy: the native reader was slower (the same timing)."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"P5":
            raise ValueError(f"{path}: not a binary PGM")
        dims = []
        while len(dims) < 3:
            line = f.readline()
            if line.startswith(b"#"):
                continue
            dims += [int(tok) for tok in line.split()]
        w, h = dims[0], dims[1]
        return np.frombuffer(f.read(w * h), np.uint8).reshape(h, w)
