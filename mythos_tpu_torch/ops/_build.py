"""Build and load the hand-written CUDA kernels (``ops/csrc``).

The sources are compiled by ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, loaded through :mod:`ctypes`.
The build runs at first use -- never at import -- into
``ops/_build/<hash of the sources and flags>/``, so a checkout builds
everything it needs from its own sources, and an edit rebuilds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libmythos_stencil.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
#: argument types of each exported C function (every pointer and the
#: stream as c_void_p, every count as c_int)
SIGNATURES = {
    "stencil_field_grads": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    "multistep_chunk": (
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,  # params, seq, partners, qf, n, w x4, w_wide
        _P, _P, _P, _I, _I,  # wstack, dirf, checks, n_checks, check_dm
        _P, _P, _I, _P, _P,  # ou, noise, n_inner, state, stream
    ),
}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def build() -> tuple[Path, float]:
    """Compile the library if this source hash has none; (path, seconds)."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    (out_dir / "build.log").write_text(f"$ {' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed (rc {res.returncode}):\n{res.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib, seconds


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
