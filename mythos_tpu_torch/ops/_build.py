"""Build and load the hand-written CUDA kernels (``ops/csrc``).

The sources are compiled by ``nvcc`` for Hopper (``sm_90a``), one
process per source, all started together, then linked into one shared
library with a plain C interface, loaded through :mod:`ctypes`. The build
runs at first use -- never at import -- into
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
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libmythos_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
#: argument types of each exported C function (every pointer and the
#: stream as c_void_p, every count as c_int)
SIGNATURES = {
    # params, seq, partners, qf, n, w x4, w_wide, dyn, out, counts, stream
    "stencil_field_grads": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    # n: the blocks of K2, the rows of its tally
    "stencil_field_grads_blocks": (_I,),
    "multistep_chunk": (
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,  # params, seq, partners, qf, n, w x4, w_wide
        _P, _P, _P, _I, _I,  # wstack, dirf, checks, n_checks, check_dm
        _P, _P, _I, _P, _P, _P,  # ou, noise, n_inner, state, alt, stream
    ),
    # params, rows, ids, n, n_blocks, block_size, cap, kind, then out, counts, stream
    "tile_forces": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P),
    "tile_row_grads": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P),
    # ... then partials, out, counts, stream
    "tile_energies": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    # n_blocks, block_size: the rows of tile_energies' partials scratch
    "tile_energies_partials": (_I, _I),
    # positions, n, box, then the cells' arrays (dims, cell_of, start, order, tmp), stream
    "lj_cells": (_P, _I, _P, _P, _P, _P, _P, _P, _P),
    # positions, types, mask bits, n, words, box, sigmas, epsilons, t, the cells (dims, cell_of,
    # start, order), then partials, out, stream (lj_energy) or grad, box rows, box grad, stream
    # (lj_grads)
    "lj_energy": (_P, _P, _P, _I, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P),
    "lj_grads": (_P, _P, _P, _I, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P),
}
# the oxRNA2 and oxDNA1 instances of K2 and K1, and the oxDNA1 instances of K3-K5, take the same arguments
for _fam in ("rna2", "dna1"):
    SIGNATURES[f"stencil_field_grads_{_fam}"] = SIGNATURES["stencil_field_grads"]
    SIGNATURES[f"multistep_chunk_{_fam}"] = SIGNATURES["multistep_chunk"]
for _name in ("tile_forces", "tile_row_grads", "tile_energies"):
    SIGNATURES[f"{_name}_dna1"] = SIGNATURES[_name]
    # the pseq instances of K3-K5 take the same arguments too
    SIGNATURES[f"{_name}_pseq"] = SIGNATURES[f"{_name}_dna1_pseq"] = SIGNATURES[_name]
# K2's pseq instances (oxDNA2, oxRNA2, oxDNA1): its arguments with the (10, n) hb factors before dyn
for _name in ("stencil_field_grads_pseq", "stencil_field_grads_rna2_pseq", "stencil_field_grads_dna1_pseq"):
    SIGNATURES[_name] = (*SIGNATURES["stencil_field_grads"][:10], _P, *SIGNATURES["stencil_field_grads"][10:])


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
    nvcc = find_nvcc()
    tag = os.getpid()
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out, err = proc.communicate()
        log.append(f"$ {' '.join(cmd)}\n{out}\n{err}")
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} (rc {proc.returncode}):\n{err[-4000:]}")
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _ in jobs)]
        res = subprocess.run(cmd, capture_output=True, text=True, check=False)
        log.append(f"$ {' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
        if res.returncode != 0:
            failed.append(f"link (rc {res.returncode}):\n{res.stderr[-4000:]}")
    seconds = time.perf_counter() - t0
    (out_dir / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
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
