"""ctypes binding for the native C++ CPU rasterizer
(facerecon_tpu_torch/native/raster_oracle.cc; twin of the JAX package's
utils/native_oracle.py).

Builds the shared library on first use with g++ into
facerecon_tpu_torch/_build/ (listed in .gitignore), named by a hash of
the source and flags. Output is bitwise-identical to
facerecon_tpu_torch.oracle.rasterize (same float32 operation order, FMA
contraction disabled), ~100x faster at full resolution. `rasterize`
falls back to the numpy oracle when the toolchain is missing (it is an
oracle, not the device path); `require` raises instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from facerecon_tpu_torch import oracle

SRC = Path(__file__).resolve().parent.parent / "native" / "raster_oracle.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O2", "-ffp-contract=off", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_error = None


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libraster_oracle-{digest.hexdigest()[:16]}.so"


def _load():
    """The library, built first if needed; None (with the reason kept in
    _error) when it cannot be built or loaded."""
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        out = library_path()
        try:
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
                subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                               check=True, capture_output=True, text=True)
                os.replace(tmp, out)
            lib = ctypes.CDLL(str(out))
        except (OSError, subprocess.CalledProcessError) as e:
            _error = getattr(e, "stderr", None) or str(e)
            return None
        lib.rasterize_cpu.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.rasterize_cpu.restype = None
        _lib = lib
        return _lib


def is_available() -> bool:
    return _load() is not None


def require() -> None:
    """Raise unless the native library builds and loads."""
    if _load() is None:
        raise RuntimeError(f"native oracle build failed: {_error}")


def rasterize(verts_ndc: np.ndarray, faces: np.ndarray,
              height: int, width: int):
    """Same contract as oracle.rasterize; numpy fallback if no toolchain."""
    lib = _load()
    if lib is None:
        return oracle.rasterize(verts_ndc, faces, height, width)
    verts = np.ascontiguousarray(verts_ndc, dtype=np.float32)
    faces = np.ascontiguousarray(faces, dtype=np.int32)
    tri_id = np.empty((height, width), dtype=np.int32)
    bary = np.empty((height, width, 3), dtype=np.float32)
    zbuf = np.empty((height, width), dtype=np.float32)
    lib.rasterize_cpu(
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        verts.shape[0],
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        faces.shape[0], height, width,
        tri_id.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        bary.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        zbuf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return tri_id, bary, zbuf
