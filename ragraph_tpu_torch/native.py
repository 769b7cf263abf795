"""Lazy build and ``ctypes`` binding of the hand-written CUDA kernels.

The sources in ``csrc/*.cu`` expose a plain C interface. On the first call
that needs a kernel, :func:`lib` compiles every source with its own ``nvcc``
process (all started together), links them into one shared library under
``build/`` (listed in ``.gitignore``) and loads it with ``ctypes``. The
library's file name carries a hash of the sources, so an edited kernel is
rebuilt and an unchanged one is reused. A file lock in ``build/`` lets one
process build while others that need the library (the ranks of a
multi-process run) wait for it. Importing this module runs nothing.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an error.
``LAUNCHES`` counts, per kernel, the wrapper calls that launched it.
"""

from __future__ import annotations

import collections
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

# kernel name -> launches by its wrapper since the last reset
LAUNCHES: collections.Counter = collections.Counter()

_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # table, w, idx, indptr, out, n_rows, d, bf16 table (and weights),
    # then the walk plan: hub_edges, long_rows, piece_ptr, n_long, pieces,
    # n_pieces, partial; stream
    "rg_csr_gather_scale_segsum": [_P, _P, _P, _P, _P, _L, _I, _I,
                                   _I, _P, _P, _L, _P, _L, _P, _P],
    # msgs, indptr, out, n_rows, d, stream
    "rg_csr_segment_sum": [_P, _P, _P, _L, _I, _P],
    # q, keys, valid, part_s, part_i, bound, out_s, out_i, Q, R, E, k,
    # queries per block, splits, rows_per_split, stream
    "rg_fused_cosine_topk": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                             _I, _I, _I, _I, _P],
    # keys, q, valid, out, R, Q, E, queries per block, buckets per block,
    # stream
    "rg_bucket_max": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # keys, q, valid, out, R, Q, E, queries per block, buckets per block,
    # row stride of out, stream
    "rg_score_matrix": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, row stride, rows, n, k, sort width, scratch, out_v, out_i, stream
    "rg_select_topk": [_P, _L, _I, _I, _I, _I, _P, _P, _P, _P],
    # x, out_v, out_i, R, Q, k, list length, columns per block, stream
    "rg_column_topk": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # assign, q, keys, valid, out, buckets, P, Q, R, E, stream
    "rg_bucket_rescore": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, out_v, out_i, Q, W, k, list length, rows per block, stream
    "rg_row_topk": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, out, total, scratch (rg_prefix_sum_scratch_words), n, d,
    # exclusive, bf16 input, stream
    "rg_prefix_sum": [_P, _P, _P, _P, _L, _I, _I, _I, _P],
    # msgs2, w, indptr, out, n_rows, d, block, bf16 rows, round to bf16,
    # stream
    "rg_csr_segsum_packed2_w": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _P],
    # keys, q, out, R, Q, E, written row of each 128-row group, stream
    "rg_mm_probe": [_P, _P, _P, _I, _I, _I, _I, _P],
    # packed table, w_lo, w_hi, idx_half, indptr, out, n_rows, d, the walk
    # plan (as kernel A's), stream
    "rg_packed_table_segsum": [_P, _P, _P, _P, _P, _P, _L, _I,
                               _I, _P, _P, _L, _P, _L, _P, _P],
    # col, table, out, blocks, slots per block, table rows, d, stream
    "rg_onehot_gather": [_P, _P, _P, _I, _I, _L, _I, _P],
    # edge_norm, time_norm, their sender-order copies, send_perm, two salt
    # tensors, two thresholds, draws, time coefficient, out, out in sender
    # order, edges, stream
    "rg_edge_weights": [_P, _P, _P, _P, _P, _P, _P, _L, _L, _I,
                        ctypes.c_float, _P, _P, _L, _P],
}


def reset_launches() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _library_path() -> Path:
    digest = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libragraph_kernels_{digest.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> tuple[Path, float, str]:
    """Compile and link the kernels; return ``(path, seconds, log)``.

    Reuses an existing library built from the same sources unless
    ``verbose``, which rebuilds with ``-Xptxas -v`` so the log shows each
    kernel's registers, shared memory and spills.
    """
    out = _library_path()
    if out.exists() and not verbose:
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists() and not verbose:     # another process built it
            return out, 0.0, ""
        return _build(out, verbose)


def _build(out: Path, verbose: bool) -> tuple[Path, float, str]:
    nvcc = _nvcc()
    flags = ["-std=c++17", "-O3", ARCH, "-Xcompiler", "-fPIC", "-lineinfo"]
    if verbose:
        flags += ["-Xptxas", "-v"]
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    procs = []
    try:
        for src in sorted(CSRC.glob("*.cu")):
            obj = tmp / f"{src.stem}.o"
            log = open(tmp / f"{src.stem}.log", "w")
            procs.append((src, obj, log, subprocess.Popen(
                [nvcc, *flags, "-c", str(src), "-o", str(obj)],
                stdout=log, stderr=subprocess.STDOUT)))
        for _, _, log, p in procs:
            p.wait()
            log.close()
        logs = "".join(f"== {src.name}\n{(tmp / f'{src.stem}.log').read_text()}"
                       for src, _, _, _ in procs)
        failed = [src.name for src, _, _, p in procs if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{logs}")
        so = tmp / out.name
        res = subprocess.run([nvcc, "-shared", ARCH, "-o", str(so),
                              *[str(obj) for _, obj, _, _ in procs]],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        os.replace(so, out)
    finally:
        for _, _, log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return out, time.perf_counter() - t0, logs


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        path, _, _ = build()
        handle = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.rg_error_string.argtypes = [ctypes.c_int]
        handle.rg_error_string.restype = ctypes.c_char_p
        # words of kernel H's scratch for (n, d); -1 for a shape it refuses
        handle.rg_prefix_sum_scratch_words.argtypes = [_L, _I]
        handle.rg_prefix_sum_scratch_words.restype = ctypes.c_longlong
        _lib = handle
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = lib().rg_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as an integer handle."""
    return torch.cuda.current_stream(t.device).cuda_stream
