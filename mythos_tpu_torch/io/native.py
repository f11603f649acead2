"""ctypes bindings to the native oxDNA trajectory parser.

Counterpart of mythos_tpu/io/native.py. The C++ source is the repo's
``native/traj_parser.cpp`` (one strtod pass over the mmap'd file), read in
place and compiled with g++ at first use into this package's own build
directory, ``io/_native_build/<hash of the source and flags>/`` -- never
next to the source, whose ``native/`` belongs to the reference. Where no
compiler or source is at hand, :func:`parse_trajectory` returns None and
the caller takes its numpy parser, as the reference does: the native
parser is an accelerator, never a requirement.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

SRC = Path(__file__).resolve().parents[2] / "native" / "traj_parser.cpp"
BUILD_ROOT = Path(__file__).resolve().parent / "_native_build"
LIB_NAME = "libmythos_traj.so"
#: portable flags: the build directory may travel to another host
GXX_FLAGS = ("-O3", "-shared", "-fPIC")


def library_path() -> Path | None:
    """Where the library of this source and these flags lives (None without the source)."""
    if not SRC.exists():
        return None
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + SRC.read_bytes()).hexdigest()[:16]
    return BUILD_ROOT / h / LIB_NAME


def _build(lib: Path) -> bool:
    gxx = shutil.which("g++") or shutil.which("c++")
    if gxx is None:
        return False
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.parent / f"{LIB_NAME}.{os.getpid()}.tmp"
    try:
        subprocess.run([gxx, *GXX_FLAGS, str(SRC), "-o", str(tmp)], check=True, capture_output=True)
    except (subprocess.CalledProcessError, OSError) as e:
        logger.debug("native trajectory parser build failed: %s", e)
        return False
    os.replace(tmp, lib)  # atomic: processes building at once each install a whole library
    return True


@functools.cache
def get_lib() -> ctypes.CDLL | None:
    """The loaded native library, built on first use (None if unavailable)."""
    lib_path = library_path()
    if lib_path is None or not (lib_path.exists() or _build(lib_path)):
        return None
    try:
        lib = ctypes.CDLL(str(lib_path))
    except OSError as e:
        logger.debug("native trajectory parser unavailable: %s", e)
        return None
    lib.oxdna_count_states.argtypes = [ctypes.c_char_p]
    lib.oxdna_count_states.restype = ctypes.c_long
    dbl = ctypes.POINTER(ctypes.c_double)
    lib.oxdna_parse.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_long, dbl, dbl, dbl, dbl]
    lib.oxdna_parse.restype = ctypes.c_int
    return lib


def parse_trajectory(path, n_nucleotides: int):
    """(times (S,), boxes (S, 3), energies (S, 3), states (S, N, 15)) float64
    arrays via the native parser, or None where the library is unavailable
    or the file malformed (the caller then parses in numpy)."""
    lib = get_lib()
    if lib is None:
        return None
    path_b = str(path).encode()
    n_states = lib.oxdna_count_states(path_b)
    if n_states <= 0:
        return None
    times = np.empty(n_states, dtype=np.float64)
    boxes = np.empty((n_states, 3), dtype=np.float64)
    energies = np.empty((n_states, 3), dtype=np.float64)
    states = np.empty((n_states, n_nucleotides, 15), dtype=np.float64)

    def ptr(a: np.ndarray):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    rc = lib.oxdna_parse(path_b, n_nucleotides, n_states, ptr(times), ptr(boxes), ptr(energies), ptr(states))
    if rc != 0:
        logger.debug("native trajectory parse failed with code %d; the numpy parser takes it", rc)
        return None
    return times, boxes, energies, states
