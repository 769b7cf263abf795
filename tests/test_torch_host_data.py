"""The port's host data path against the JAX package's: the C++ library
(``ragraph_tpu_torch/csrc/fastgraph.cpp`` through ``utils/native.py``), the
native branches of ``data/edgelist.py`` and ``train/prefetch.py``.

The C++ parser, sampler and CSR assembly are the same source in both
packages, so their outputs are held bit for bit, and so are the default
``train_batches``, which reach the sampler with a seed drawn from the same
numpy generator.
"""

import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from ragraph_tpu.data import edgelist as j_edgelist
from ragraph_tpu.utils import native as j_native
from ragraph_tpu_torch.data import edgelist as t_edgelist
from ragraph_tpu_torch.train.prefetch import prefetch
from ragraph_tpu_torch.utils import native as t_native

ROOT = Path(__file__).resolve().parents[1]

EDGE_FILE = ("0\t1 2 3\t100 200 300\n"
             "5\t7\t400\n"
             "\n"
             "2\t4 9\t500 3700\r\n"
             "7\t0 11 12 13\t10 20 30 7300\n")


def test_library_builds_under_build_dir_once_for_concurrent_builds(
        tmp_path):
    """The default library lives in ``ragraph_tpu_torch/build/`` under the
    source's digest; two processes that build into one empty directory at
    once end with one library that both load."""
    path = t_native.library_path()
    assert path.parent == ROOT / "ragraph_tpu_torch" / "build"
    assert re.fullmatch(r"libfastgraph_[0-9a-f]{16}\.so", path.name)
    code = textwrap.dedent(f"""
        from pathlib import Path
        from ragraph_tpu_torch.utils import native
        native.BUILD_DIR = Path({str(tmp_path / "build")!r})
        lib = native.get_lib()
        print(native.library_path())
        assert lib.fg_count_edges(b"/nonexistent") == -1
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert outs[0][0] == outs[1][0]
    built = sorted(p.name for p in (tmp_path / "build").iterdir())
    assert built == [path.name]


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    """No silent numpy fallback: a source g++ refuses raises its error."""
    bad = tmp_path / "fastgraph.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(t_native, "SRC", bad)
    monkeypatch.setattr(t_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(t_native, "_lib", None)
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed.*error"):
        t_native.get_lib()
    assert not t_native.native_available()
    assert list((tmp_path / "build").iterdir()) == []


def test_parse_edge_file_native_matches_jax_and_numpy(tmp_path):
    p = tmp_path / "train.txt"
    p.write_bytes(EDGE_FILE.encode())
    got = t_native.parse_edge_file_native(str(p))
    want = j_native.parse_edge_file_native(str(p))
    for g, w, dtype in zip(got, want, (np.int32, np.int32, np.int64)):
        assert g.dtype == dtype
        np.testing.assert_array_equal(g, w)
    clean = tmp_path / "clean.txt"
    clean.write_text(EDGE_FILE.replace("\n\n", "\n").replace("\r", ""))
    for has_time in (True, False):
        rows = t_edgelist.parse_edge_file(str(clean), has_time)
        assert rows == t_edgelist.parse_edge_file(str(clean), has_time,
                                                  use_native=False)
        assert rows == j_edgelist.parse_edge_file(str(clean), has_time)
    assert len(rows) == 10 and all(t == 0 for *_, t in rows)
    with pytest.raises(FileNotFoundError):
        t_native.parse_edge_file_native(str(tmp_path / "missing.txt"))


@pytest.mark.parametrize("n_negs", [1, 16])
def test_negative_sample_native_bit_equal(n_negs):
    """Bit for bit JAX's C++ sampler, also where ``user * num_items`` is
    past 2**31; no negative is in its user's history."""
    rng = np.random.default_rng(3)
    for num_users, num_items in ((40, 30), (1 << 13, 1 << 20)):
        users = rng.integers(0, num_users, 512).astype(np.int32)
        hist = np.unique(users.astype(np.int64) * num_items
                         + rng.integers(0, min(num_items, 20), 512))
        got = t_native.negative_sample_native(users, hist, num_items,
                                              seed=1234567, n_negs=n_negs)
        want = j_native.negative_sample_native(users, hist, num_items,
                                               seed=1234567, n_negs=n_negs)
        assert got.shape == (512, n_negs) and got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        keys = users.astype(np.int64)[:, None] * num_items + got
        assert not np.isin(keys, hist).any()
        assert (got >= 0).all() and (got < num_items).all()
    assert users.max().astype(np.int64) * num_items > 2**31


def test_build_csr_native_matches_jax():
    rng = np.random.default_rng(4)
    src = rng.integers(0, 50, 1000).astype(np.int32)
    dst = rng.integers(0, 70, 1000).astype(np.int32)
    indptr, indices = t_native.build_csr_native(src, dst, 60)
    j_indptr, j_indices = j_native.build_csr_native(src, dst, 60)
    np.testing.assert_array_equal(indptr, j_indptr)
    np.testing.assert_array_equal(indices, j_indices)
    np.testing.assert_array_equal(
        indices, dst[np.argsort(src, kind="stable")])
    with pytest.raises(ValueError, match="source ids"):
        t_native.build_csr_native(src, dst, 40)


@pytest.mark.parametrize("n_negs", [1, 4])
def test_default_train_batches_equal_jax(n_negs):
    """Both packages' default ``train_batches`` (the C++ sampler) from one
    seed give the same batches, bit for bit: the repair of the port's
    numpy-only sampler, which drew other negatives than the JAX CLI."""
    rng = np.random.default_rng(5)
    rows = [(int(u), int(i), 0) for u, i in zip(
        rng.integers(0, 100, 3000), rng.integers(0, 300, 3000))]
    test = rows[:50]
    tds = t_edgelist.load_edge_dataset(rows, test)
    jds = j_edgelist.load_edge_dataset(rows, test)
    got = list(tds.train_batches(256, np.random.default_rng(9),
                                 n_negs=n_negs))
    want = list(jds.train_batches(256, np.random.default_rng(9),
                                  n_negs=n_negs))
    assert len(got) == len(want) == 3000 // 256
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_prefetch_keeps_order_and_contents():
    items = list(prefetch(iter(range(100)), depth=3))
    assert items == list(range(100))
    arrays = [np.full(4, i) for i in range(10)]
    for got, want in zip(prefetch(iter(arrays)), arrays):
        np.testing.assert_array_equal(got, want)


def test_prefetch_raises_producer_exception():
    def gen():
        yield 1
        raise ValueError("boom")

    it = prefetch(gen())
    assert next(it) == 1
    with pytest.raises(ValueError, match="boom"):
        list(it)


def test_prefetch_close_stops_the_producer():
    made = []

    def gen():
        for i in range(1000):
            made.append(i)
            yield i

    with prefetch(gen(), depth=2) as it:
        assert next(it) == 0
    assert not it._thread.is_alive()
    assert len(made) < 10
    with pytest.raises(StopIteration):
        next(it)
