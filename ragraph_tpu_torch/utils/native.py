"""``ctypes`` binding of the host-side C++ data kernels
(counterpart of ``ragraph_tpu/utils/native.py``).

``csrc/fastgraph.cpp`` parses tab-separated edge files, rejection-samples
negatives against the sorted train-pair keys, and assembles CSR arrays. On
the first call that needs it, :func:`get_lib` compiles it with
``g++ -O3 -shared -fPIC`` into ``build/libfastgraph_<source digest>.so``
(``build/`` is gitignored) and loads it. Each build writes a temporary file
and renames it into place, so processes that build at once end with one
library. Importing this module compiles nothing.

Unlike the JAX package, whose ``get_lib`` returns ``None`` when the build
fails and lets the caller fall back to numpy without a word, a failed build
raises here with g++'s output. The numpy path is the callers' explicit
``use_native=False``.
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

SRC = Path(__file__).resolve().parent.parent / "csrc" / "fastgraph.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"

_lib = None
_lock = threading.Lock()

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_SIGNATURES = {
    "fg_count_edges": ([ctypes.c_char_p], ctypes.c_int64),
    "fg_parse_edge_file": ([ctypes.c_char_p, _I32P, _I32P, _I64P,
                            ctypes.c_int64], ctypes.c_int64),
    "fg_negative_sample": ([_I32P, ctypes.c_int64, _I64P, ctypes.c_int64,
                            ctypes.c_int64, ctypes.c_uint64, ctypes.c_int32,
                            _I32P], ctypes.c_int32),
    "fg_build_csr": ([_I32P, _I32P, ctypes.c_int64, ctypes.c_int64, _I64P,
                      _I32P], ctypes.c_int32),
}


def library_path() -> Path:
    """Where the library built from the current source lives."""
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libfastgraph_{digest}.so"


def build() -> Path:
    """Compile the library unless one built from this source exists;
    return its path. Raises ``RuntimeError`` with g++'s output on failure."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        try:
            res = subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, str(SRC)],
                capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"g++ not found, cannot build {SRC}") from e
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed on {SRC}:\n{res.stdout}"
                               f"{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = handle
    return _lib


def native_available() -> bool:
    """Whether the library builds and loads here."""
    try:
        get_lib()
    except (RuntimeError, OSError):
        return False
    return True


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def parse_edge_file_native(path: str):
    """Parse a tab-separated ``user \\t items \\t times`` file into
    ``(users int32, items int32, times int64)`` arrays."""
    lib = get_lib()
    n = lib.fg_count_edges(path.encode())
    if n < 0:
        raise FileNotFoundError(path)
    users = np.empty(n, np.int32)
    items = np.empty(n, np.int32)
    times = np.empty(n, np.int64)
    got = lib.fg_parse_edge_file(path.encode(), _ptr(users, ctypes.c_int32),
                                 _ptr(items, ctypes.c_int32),
                                 _ptr(times, ctypes.c_int64), n)
    if got != n:
        raise RuntimeError(f"{path} changed while it was parsed: {n} rows "
                           f"counted, {got} parsed")
    return users, items, times


def negative_sample_native(users: np.ndarray, hist_keys: np.ndarray,
                           num_items: int, seed: int,
                           n_negs: int = 1) -> np.ndarray:
    """Rejection-sample ``n_negs`` negatives per user in C++: items whose
    key ``user * num_items + item`` is not in the sorted ``hist_keys``
    (at most 1,000 draws each). Returns ``(len(users), n_negs)`` int32."""
    if num_items < 1 or n_negs < 1:
        raise ValueError(f"need num_items >= 1 and n_negs >= 1, got "
                         f"{num_items}, {n_negs}")
    lib = get_lib()
    users = np.ascontiguousarray(users, np.int32)
    hist_keys = np.ascontiguousarray(hist_keys, np.int64)
    out = np.empty((len(users), n_negs), np.int32)
    rc = lib.fg_negative_sample(
        _ptr(users, ctypes.c_int32), len(users),
        _ptr(hist_keys, ctypes.c_int64), len(hist_keys),
        num_items, np.uint64(seed), n_negs, _ptr(out, ctypes.c_int32))
    if rc != 0:
        raise RuntimeError(f"fg_negative_sample returned {rc}")
    return out


def build_csr_native(src: np.ndarray, dst: np.ndarray, num_nodes: int):
    """Counting-sort CSR by source node: ``(indptr (N+1,) int64, indices
    (E,) int32)``, each row's ``dst`` in input order."""
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError(f"src {src.shape} and dst {dst.shape} must be one "
                         f"1-D shape")
    if len(src) and (src.min() < 0 or src.max() >= num_nodes):
        raise ValueError(f"source ids must lie in [0, {num_nodes})")
    lib = get_lib()
    indptr = np.empty(num_nodes + 1, np.int64)
    indices = np.empty(len(src), np.int32)
    rc = lib.fg_build_csr(_ptr(src, ctypes.c_int32),
                          _ptr(dst, ctypes.c_int32), len(src), num_nodes,
                          _ptr(indptr, ctypes.c_int64),
                          _ptr(indices, ctypes.c_int32))
    if rc != 0:
        raise RuntimeError(f"fg_build_csr returned {rc}")
    return indptr, indices
