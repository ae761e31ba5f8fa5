"""Build and load the port's CUDA kernels at first use.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by
`nvcc` into its own shared library, loaded with ctypes (no PyTorch
headers, so a build takes seconds). A source may hold more than one
kernel's C entry (`SOURCES`: the two binning kernels share
`csrc/binning.cu`, the textured kernel and the detailed image's fetch
`csrc/raster_texture.cu`, and the detail decoder's two `csrc/upconv.cu`); it builds once for all of them. Libraries go into
`_build/` beside the package (listed in .gitignore), named by a hash of
the source, every header in `csrc/` and the flags, so a checkout builds
what it needs on its first call and reuses it afterwards, and an edited
header rebuilds every kernel. A failed build raises: there is no
fallback.

A variant build compiles the same source with macros defined
(`defines`, passed to nvcc as -D<name>): the ablated raster kernels and
the per-bit walk of K6, which only the probe twins in `benchmarks/` and
chip_smoke.py ask for. The macros enter the hash, so a variant is a
library of its own, built at its first use; without them every name and
build is the default one.

`launch` calls a kernel's C entry on the current stream and adds one to
its count in `LAUNCHES` (a variant's under its kernel's name); the
wrappers launch through it and nowhere else, so a run can show which
kernels its path went through. `on_card`
and `check_tensors` are the wrappers' shared input checks.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

KERNELS = ("raster_shade", "raster_select", "select_grad", "raster_pos",
           "ctz_walk", "bin_setup", "bin_windows", "raster_texture",
           "geometry", "records", "uv_detail", "raster_texfetch", "upconv",
           "outconv")
# the source, csrc/<source>.cu, of each kernel not in a file of its own
# name
SOURCES = {"bin_setup": "binning", "bin_windows": "binning",
           "raster_texfetch": "raster_texture", "outconv": "upconv"}
# the device function each kernel's C entry launches exactly once a
# launch (K3's and the geometry's last pass), as a profiler's trace names
# it
SYMBOLS = {"raster_shade": "raster_shade_kernel",
           "raster_select": "raster_select_kernel",
           "select_grad": "sum_rows",
           "raster_pos": "raster_pos_kernel",
           "ctz_walk": "ctz_walk_kernel",
           "bin_setup": "bin_setup_kernel",
           "bin_windows": "bin_windows_kernel",
           "raster_texture": "raster_texture_kernel",
           "geometry": "geometry_kernel",
           "records": "records_kernel",
           "uv_detail": "uv_detail_kernel",
           "raster_texfetch": "raster_texfetch_kernel",
           "upconv": "upconv_kernel",
           "outconv": "outconv_kernel"}
CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")

LAUNCHES: dict[str, int] = {name: 0 for name in KERNELS}

_libs: dict[tuple[str, tuple[str, ...]], ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def macros(defines=()) -> tuple[str, ...]:
    """A variant's macro names, sorted and without repeats; raises on
    anything that is not a macro name."""
    names = tuple(sorted(set(defines)))
    for d in names:
        if not re.fullmatch(r"[A-Z_][A-Z0-9_]*", d):
            raise ValueError(f"not a macro name: {d!r}")
    return names


def source(name: str) -> str:
    """The stem of the source that holds kernel `name` (a source's own
    stem gives itself)."""
    return SOURCES.get(name, name)


def library_path(name: str, defines=()) -> Path:
    """The library of kernel (or source) `name`, the variant with
    `defines` set."""
    name = source(name)
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    defines = macros(defines)
    if defines:
        digest.update(" ".join(f"-D{d}" for d in defines).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=KERNELS, defines=()) -> dict[str, str]:
    """Compile the source of every named kernel that has no current
    library, with the macros `defines` set: one nvcc per source, all
    started together. Returns each new build's compiler log by source
    (register and shared-memory use from ptxas). Raises if any build
    fails."""
    defines = macros(defines)
    procs = []
    for name in dict.fromkeys(map(source, names)):
        out = library_path(name, defines)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o",
               str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, errors = {}, []
    for name, tmp, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        logs[name] = log
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def load(name: str, defines=()) -> ctypes.CDLL:
    """The shared library of kernel `name`'s source (the variant with
    `defines` set), built first if needed."""
    key = (source(name), macros(defines))
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            build((name,), key[1])
            lib = ctypes.CDLL(str(library_path(*key)))
            _libs[key] = lib
        return lib


def on_card(dev: torch.device) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one
    (take the plain version); raises on any other device."""
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def check_tensors(dev, want) -> None:
    """Raise unless every tensor in `want` (name -> (tensor, dtype, shape))
    lies on `dev` with that dtype and shape and is contiguous."""
    for name, (t, dtype, shape) in want.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def launch(name: str, dev: torch.device, ptrs, ints, defines=(),
           floats=()) -> None:
    """Launch kernel `name` (built at first use; the variant with
    `defines` set) on the current stream of `dev`: its C entry takes the
    pointers, then the ints, then the floats (as C floats), then the
    stream, and returns the launch's CUDA error code."""
    fn = getattr(load(name, defines), name)
    fn.argtypes = ([ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * len(ints)
                   + [ctypes.c_float] * len(floats) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(t.data_ptr() for t in ptrs), *ints,
                 *(float(x) for x in floats), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
