"""The port's probe kernels (J, K, L) against the Pallas kernel bodies of
the JAX package's bench scripts, and the port's bench scripts at small
sizes. On the CPU the port runs each kernel's plain version.

The JAX side: ``packed_table_segsum`` and the one-hot call of the scripts
have no ``interpret`` switch, so the scripts are loaded by path (their
``main`` is guarded), the kernel bodies ``_pt_scan_kernel`` (+
``_packed_boundary``) and ``onehot_gather_kernel`` are taken from them and
wrapped in a ``pl.pallas_call(..., interpret=True)`` with the scripts' own
block specs at a small shape. ``_mm_kernel`` is nested in the script's
``main``; its two lines are restated here.

Tolerances. J: the port adds the exact bf16 products in ascending column
order, the JAX dot in another order: a few f32 roundings of a sum of at most
E terms of size <= 1, 1e-5. K: the JAX kernel takes prefix differences (1e-3
of the prefix at worst, ``ops/pallas_segment.py:145-148``), the port sums
directly: the script's own limit, 5e-4 of the largest output. L: a copy, 0.
"""

import functools
import importlib.util
import json
import pathlib

import _torch_threads  # noqa: F401  (torch's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ragraph_tpu.ops import bucket_topk as jbt
from ragraph_tpu.ops import pallas_segment as jps
from ragraph_tpu_torch.bench import (csr_walk, exact_phases, main_path,
                                     onehot_gather, packed_table_gather,
                                     prefix_scan, score_tile)
from ragraph_tpu_torch.ops import bucket_topk as tbt
from ragraph_tpu_torch.ops import csr_segment as tcs
from ragraph_tpu_torch.ops import probes

ROOT = pathlib.Path(__file__).resolve().parents[1]
LANE = 128


def _load(rel):
    spec = importlib.util.spec_from_file_location(
        "_probe_" + pathlib.Path(rel).stem, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def pt_script():
    return _load("experiments/packed_table_gather_bench.py")


@pytest.fixture(scope="module")
def onehot_script():
    return _load("experiments/onehot_gather_bench.py")


def _unit_bf16(rng, n, e):
    x = rng.normal(size=(n, e)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return torch.from_numpy(x).to(torch.bfloat16)


# ---- J ----------------------------------------------------------------------

def _jax_mm_probe(keys, q, block_r, block_q):
    """``bench_exact_phases.py``'s ``_mm_kernel`` (``:212-219``) in
    interpret mode, with the script's grid and block specs."""
    def _mm_kernel(k_ref, q_ref, out_ref):
        tile = jnp.dot(k_ref[:], q_ref[:].T,
                       preferred_element_type=jnp.float32)
        out_ref[:] = tile.reshape(tile.shape[0] // LANE, LANE,
                                  tile.shape[1])[:, 0, :]
    r, e = keys.shape
    n_q = q.shape[0]
    return pl.pallas_call(
        _mm_kernel, grid=(r // block_r, n_q // block_q),
        in_specs=[pl.BlockSpec((block_r, e), lambda j, i: (j, 0)),
                  pl.BlockSpec((block_q, e), lambda j, i: (i, 0))],
        out_specs=pl.BlockSpec((block_r // LANE, block_q),
                               lambda j, i: (j, i)),
        out_shape=jax.ShapeDtypeStruct((r // LANE, n_q), jnp.float32),
        interpret=True)(keys, q)


@pytest.mark.parametrize("r,q,e", [(1024, 64, 32), (512, 128, 128),
                                   (2048, 32, 8)])
def test_matmul_probe_matches_jax_kernel(r, q, e):
    rng = np.random.default_rng(r + q + e)
    keys, qs = _unit_bf16(rng, r, e), _unit_bf16(rng, q, e)
    want = np.asarray(_jax_mm_probe(
        jnp.asarray(keys.float().numpy(), dtype=jnp.bfloat16),
        jnp.asarray(qs.float().numpy(), dtype=jnp.bfloat16), 512, 32))
    got = probes.matmul_probe(keys, qs).numpy()
    assert got.shape == (r // LANE, q)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("pick", [0, 1, 63, 64, 127])
def test_matmul_probe_is_rescore_score_and_below_bucket_max(pick):
    """``J[g, q]`` is kernel F's score of key ``128·g + pick`` bit for bit
    and never above kernel D's bucket maximum; a picked row past R is 0."""
    rng = np.random.default_rng(pick)
    r, q, e = 700, 9, 16          # the last group has 60 rows
    keys, qs = _unit_bf16(rng, r, e), _unit_bf16(rng, q, e)
    got = probes.matmul_probe(keys, qs, pick)
    nb = -(-r // LANE)
    assign = torch.arange(q, dtype=torch.int32).repeat(nb, 1)
    panels = tbt.bucket_rescore(assign, qs, keys)          # (nb, q, 128)
    live = torch.arange(nb) * LANE + pick < r
    assert torch.equal(got[live], panels[:, :, pick][live])
    assert bool((got[~live] == 0).all())
    assert bool((got[live] <= tbt.bucket_max(keys, qs)[live]).all())


def test_matmul_probe_rejects_bad_rows():
    keys, qs = torch.zeros(256, 8), torch.zeros(4, 8)
    for bad in (-1, 128):
        with pytest.raises(ValueError):
            probes.matmul_probe(keys, qs, bad)


# ---- K ----------------------------------------------------------------------

def _jax_packed_table_segsum(script, table_packed, w_lo, w_hi, idx_half,
                             indptr, block):
    """``packed_table_segsum`` of the script (``:97-120``) with its
    ``pallas_call`` in interpret mode."""
    rows = table_packed[idx_half]
    n, d2 = rows.shape
    d = d2 // 2
    two = 2 * block
    from jax.experimental.pallas import tpu as pltpu
    excl, total = pl.pallas_call(
        functools.partial(script._pt_scan_kernel, half=block),
        grid=(n // two,),
        in_specs=[pl.BlockSpec((two, d2), lambda j: (j, 0)),
                  pl.BlockSpec((two // 128, 128), lambda j: (j, 0)),
                  pl.BlockSpec((two // 128, 128), lambda j: (j, 0))],
        out_specs=[pl.BlockSpec((block, d2), lambda j: (j, 0)),
                   pl.BlockSpec((1, d), lambda j: (0, 0))],
        out_shape=[jax.ShapeDtypeStruct((n // 2, d2), jnp.float32),
                   jax.ShapeDtypeStruct((1, d), jnp.float32)],
        scratch_shapes=[pltpu.VMEM((1, d), jnp.float32)],
        interpret=True,
    )(rows, w_lo.reshape(n // 128, 128), w_hi.reshape(n // 128, 128))
    return jps._packed_boundary(excl, total, indptr, n, block, d)


def _packed_case(seed, n, d, e):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(n, d)).astype(np.float32)
    recv = np.sort(rng.integers(0, n, e)).astype(np.int32)
    send = rng.integers(0, n, e).astype(np.int32)
    indptr = np.concatenate(
        [[0], np.cumsum(np.bincount(recv, minlength=n))]).astype(np.int32)
    w = rng.random(e).astype(np.float32)
    return table, send, indptr, w


@pytest.mark.parametrize("both", [False, True])
@pytest.mark.parametrize("n,d,e,block", [(512, 64, 2048, 512),
                                         (256, 16, 1024, 256)])
def test_packed_table_segsum_matches_jax_kernel(pt_script, n, d, e, block,
                                                both):
    table, send, indptr, w = _packed_case(n + d, n, d, e)
    parity = (send & 1).astype(np.float32)
    if both:        # both halves weighted: no parity bit
        w_lo, w_hi = w, (1 - w).astype(np.float32)
    else:
        w_lo, w_hi = w * (1 - parity), w * parity
    tp = jnp.asarray(table).astype(jnp.bfloat16).reshape(n // 2, 2 * d)
    want = np.asarray(_jax_packed_table_segsum(
        pt_script, tp, jnp.asarray(w_lo), jnp.asarray(w_hi),
        jnp.asarray(send >> 1), jnp.asarray(indptr), block))
    t = torch.from_numpy
    got = probes.packed_table_segsum(
        probes.pack_table(t(table)), t(w_lo), t(w_hi), t(send >> 1),
        t(indptr)).numpy()
    assert got.shape == (n, d)
    assert np.abs(got - want).max() < 5e-4 * np.abs(want).max()


@pytest.mark.parametrize("n_tab,n_rows,e,d", [(64, 37, 300, 8),
                                              (10, 50, 20, 2),
                                              (128, 5, 0, 128)])
def test_packed_table_segsum_equals_kernel_a_function(n_tab, n_rows, e, d):
    """With the parity split K is kernel A's function on ``(table, w,
    send)``: here both plain versions, equal to the last bit since a zero
    weight adds nothing. Any number of receiver rows; empty segments are
    zero rows."""
    rng = np.random.default_rng(e)
    table = torch.from_numpy(rng.normal(size=(n_tab, d)).astype(np.float32))
    send = torch.from_numpy(rng.integers(0, n_tab, e).astype(np.int32))
    recv = np.sort(rng.integers(0, n_rows, e))
    indptr = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(np.bincount(recv, minlength=n_rows))])
        .astype(np.int32))
    w = torch.from_numpy(rng.random(e).astype(np.float32))
    par = (send & 1).float()
    got = probes.packed_table_segsum(probes.pack_table(table), w * (1 - par),
                                     w * par, send >> 1, indptr)
    want = tcs.gather_scale_segsum_plain(table, w, send, indptr, True)
    assert got.shape == (n_rows, d)
    assert torch.equal(got, want)
    empty = indptr[1:] == indptr[:-1]
    assert bool((got[empty] == 0).all())


def test_packed_table_segsum_rejects_bad_shapes():
    z = torch.zeros
    with pytest.raises(ValueError):     # D = 130
        probes.packed_table_segsum(z(4, 260), z(3), z(3),
                                   z(3, dtype=torch.int32),
                                   z(2, dtype=torch.int32))
    with pytest.raises(ValueError):     # weights of another length
        probes.packed_table_segsum(z(4, 16), z(3), z(2),
                                   z(3, dtype=torch.int32),
                                   z(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        probes.pack_table(z(3, 8))


# ---- L ----------------------------------------------------------------------

def _jax_onehot_gather(script, cols, table):
    """The script's ``pallas_call`` (``:88-102``) in interpret mode."""
    nb, p = cols.shape
    d = table.shape[1]
    bps = script.BPS
    return pl.pallas_call(
        script.onehot_gather_kernel, grid=(nb // bps,),
        in_specs=[pl.BlockSpec((bps, p), lambda b: (b, 0)),
                  pl.BlockSpec((bps * LANE, d), lambda b: (b, 0))],
        out_specs=pl.BlockSpec((bps * p, d), lambda b: (b, 0)),
        out_shape=jax.ShapeDtypeStruct((nb * p, d), jnp.bfloat16),
        interpret=True)(cols, table)


def test_build_onehot_layout_matches_script(onehot_script, monkeypatch):
    n, e = 2048, 8192
    monkeypatch.setattr(onehot_script, "N", n)
    monkeypatch.setattr(onehot_script, "E", e)
    senders, cols, p, counts = onehot_script.build(np.random.default_rng(3))
    got_cols, got_p, got_counts, slot = probes.build_onehot_layout(senders,
                                                                   n)
    assert got_p == p
    np.testing.assert_array_equal(got_cols, cols)
    np.testing.assert_array_equal(got_counts, counts)
    assert slot.shape == (e,) and len(np.unique(slot)) == e
    with pytest.raises(ValueError):
        probes.build_onehot_layout(senders[::-1], n)


@pytest.mark.parametrize("d", [64, 16])
def test_onehot_block_gather_matches_jax_kernel(onehot_script, d):
    n, e = 16 * LANE, 6000              # 16 table blocks
    rng = np.random.default_rng(d)
    senders = np.sort(rng.integers(0, n, e).astype(np.int32))
    cols, p, _, slot = probes.build_onehot_layout(senders, n)
    table = rng.normal(size=(n, d)).astype(np.float32)
    tj = jnp.asarray(table).astype(jnp.bfloat16)
    tt = torch.from_numpy(table).to(torch.bfloat16)
    want = np.asarray(_jax_onehot_gather(
        onehot_script, jnp.asarray(cols), tj).astype(jnp.float32))
    got = probes.onehot_block_gather(torch.from_numpy(cols), tt)
    assert got.dtype == torch.bfloat16 and got.shape == (16 * p, d)
    np.testing.assert_array_equal(got.float().numpy(), want)     # exact
    np.testing.assert_array_equal(
        got[torch.from_numpy(slot)].float().numpy(),
        tt[torch.from_numpy(senders).long()].float().numpy())


def test_onehot_block_gather_ragged_blocks_and_padding():
    """Three table blocks (no multiple of 8), a last block of 44 rows, and
    columns outside [0, 128) giving zero rows."""
    rng = np.random.default_rng(0)
    n, d = 300, 8
    senders = np.sort(rng.integers(0, n, 500))
    cols, p, _, slot = probes.build_onehot_layout(senders, n)
    cols = cols.copy()
    cols[0, -1], cols[2, -2] = -1, 999
    table = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)
                             ).to(torch.bfloat16)
    got = probes.onehot_block_gather(torch.from_numpy(cols), table)
    assert got.shape == (3 * p, d)
    assert torch.equal(got[torch.from_numpy(slot)],
                       table[torch.from_numpy(senders).long()])
    pad = np.ones(3 * p, bool)
    pad[slot] = False
    assert bool((got[torch.from_numpy(pad)] == 0).all())
    with pytest.raises(ValueError):     # four blocks of columns, three of rows
        probes.onehot_block_gather(torch.zeros(4, 128, dtype=torch.int32),
                                   table)


# ---- no library kernel, no other device ----------------------------------

def test_wrappers_call_no_library_kernel_and_take_no_other_device():
    """A wrapper's own source holds no matmul, gather or sparse call (those
    live in the plain versions), and a tensor that is neither on the CPU
    nor on a CUDA device raises."""
    import inspect
    for fn in (probes.matmul_probe, probes.packed_table_segsum,
               probes.onehot_block_gather):
        src = inspect.getsource(fn)
        for banned in ("torch.matmul", "index_select", "torch.sparse", "torch.gather",
                       " @ ", "index_add"):
            assert banned not in src, (fn.__name__, banned)
        assert "native.LAUNCHES" in src and "native.check" in src
    meta = torch.device("meta")
    z = functools.partial(torch.zeros, device=meta)
    with pytest.raises(ValueError, match="not CUDA"):
        probes.matmul_probe(z(256, 8, dtype=torch.bfloat16),
                            z(4, 8, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="not CUDA"):
        probes.packed_table_segsum(z(4, 16), z(3), z(3),
                                   z(3, dtype=torch.int32),
                                   z(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="not CUDA"):
        probes.onehot_block_gather(z(1, 128, dtype=torch.int32),
                                   z(128, 8, dtype=torch.bfloat16))


# ---- the bench scripts ---------------------------------------------------

BENCHES = {
    "exact_phases": (exact_phases, ("R", "Q", "E", "k",
                                    "dependent_over_independent")),
    "packed_table_gather": (packed_table_gather, ("N", "D", "E",
                                                  "max_rel_diff")),
    "onehot_gather": (onehot_gather, ("N", "D", "E", "P", "padded_slots",
                                      "mismatched")),
    "main_path": (main_path, ("users", "items", "edges", "topk_R", "k")),
    "csr_walk": (csr_walk, ("N", "E", "D", "degrees")),
    "prefix_scan": (prefix_scan, ("shapes",)),
    "score_tile": (score_tile, ("Q", "R", "widths", "k", "bound_ms")),
}
TIMES = {
    "exact_phases": ("latency", "throughput"),
    "packed_table_gather": ("A_plain_table", "B_packed_table",
                            "B_table_repack"),
    "onehot_gather": ("index_select", "onehot_block_gather"),
    "main_path": ("pretrain_step_ms", "finetune_step_ms",
                  "pretrain_step_plain_ms", "finetune_step_plain_ms",
                  "exact_topk"),
    "csr_walk": ("uniform", "skewed", "main_path"),
    "prefix_scan": ("f32_excl_small", "bf16_incl_small"),
    "score_tile": ("C_E12_k10", "D_E12", "C_E264_k10", "D_E264",
                   "score_matrix_E264"),
}


@pytest.mark.parametrize("name", sorted(BENCHES))
def test_bench_script_small_on_cpu(name, capsys, tmp_path):
    """Each script at ``--device cpu --small``: its last line is one JSON
    object with the expected keys, host-clock times under ``cpu_host_ms``
    and never under the device's ``ms``; ``--out`` writes the same line."""
    mod, keys = BENCHES[name]
    out = tmp_path / "rec.json"
    rec = mod.main(["--device", "cpu", "--small", "--out", str(out)])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == rec == json.loads(out.read_text())
    assert rec["bench"] == name and rec["device"]["platform"] == "cpu"
    assert "ms" not in rec
    for key in keys + ("launches", "device"):
        assert key in rec, key
    for key in TIMES[name]:
        assert key in rec["cpu_host_ms"], key
    assert rec["launches"] == {}        # no kernel is launched on the CPU


def test_exact_phases_arms():
    rec = exact_phases.run("cpu", small=True, iters=2)
    thr = rec["cpu_host_ms"]["throughput"]
    assert set(thr) == {"library", "full_exact", "phase1", "matmul_proxy",
                        "glue", "ratio"}
    assert set(rec["cpu_host_ms"]["latency"]) == {"library", "full_exact",
                                                  "ratio"}
    assert all(np.isfinite(v) and v > 0 for v in thr.values())


def test_bench_scripts_default_to_the_card():
    """Without ``--device`` a script asks for the card and raises here."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for mod, _ in BENCHES.values():
        with pytest.raises(RuntimeError, match="cuda"):
            mod.main([])


def test_jax_bucket_max_kernel_is_the_phase1_arm():
    """The script's ``phase1`` arm (``bench_exact_phases.py:188``) is the
    package's ``_bucket_max_kernel``; the port's arm is kernel D's wrapper.
    They agree at E = 128 as at the widths the other tests use."""
    rng = np.random.default_rng(5)
    keys, qs = _unit_bf16(rng, 512, 128), _unit_bf16(rng, 32, 128)
    kj = jnp.asarray(keys.float().numpy(), dtype=jnp.bfloat16)
    qj = jnp.asarray(qs.float().numpy(), dtype=jnp.bfloat16)
    want = np.asarray(pl.pallas_call(
        functools.partial(jbt._bucket_max_kernel, block_r=512),
        grid=(1, 1),
        in_specs=[pl.BlockSpec((512, 128), lambda j, i: (j, 0)),
                  pl.BlockSpec((32, 128), lambda j, i: (i, 0)),
                  pl.BlockSpec((512,), lambda j, i: (j,))],
        out_specs=pl.BlockSpec((4, 32), lambda j, i: (j, i)),
        out_shape=jax.ShapeDtypeStruct((4, 32), jnp.float32),
        interpret=True)(kj, qj, jnp.ones((512,), jnp.int32)))
    got = tbt.bucket_max(keys, qs).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
