"""The port's two-phase exact bucket top-k against the JAX package (its
Pallas kernels in interpret mode). On CPU tensors the port's wrappers run
their plain versions; the glue between the phases is the code the card
runs too."""

import _torch_threads  # noqa: F401  (torch's share of the cores)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragraph_tpu.ops import bucket_topk as jbt
from ragraph_tpu.ops import topk as jtopk
from ragraph_tpu_torch import ops as tops
from ragraph_tpu_torch.ops import bucket_topk as tbt
from ragraph_tpu_torch.ops import score_tile as tst
from ragraph_tpu_torch.ops import topk as ttopk

# About 2 f32 ulp at scores near 1. The port adds the exact bf16 products in
# one fixed order; the CPU matmul behind the JAX side's interpret mode adds
# them in another, so scores can differ in the last bit
# (tests/test_bucket_topk.py states the same bound for the JAX package
# against its own dense reference).
TOL = 3e-7


def _unit(rng, n, e):
    x = rng.normal(size=(n, e)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _assert_topk_close(s, i, want_s, want_i, live=None):
    """Scores within TOL; where indices differ, the two picks' scores are
    within TOL of each other (a tie, or a last-bit difference)."""
    s, i = np.asarray(s), np.asarray(i)
    want_s, want_i = np.asarray(want_s), np.asarray(want_i)
    if live is None:
        live = np.ones(s.shape, bool)
    assert np.array_equal(np.isinf(s), np.isinf(want_s))
    np.testing.assert_allclose(s[live], want_s[live], rtol=0, atol=TOL)
    mism = (i != want_i) & live
    if mism.any():
        assert np.abs(s[mism] - want_s[mism]).max() <= TOL


@pytest.mark.parametrize("fn,k,shape", [
    pytest.param("column", 4, (300, 130), id="column"),
    pytest.param("row", 4, (70, 260), id="row"),
    # k at and around the list lengths of the card's kernels (a warp list
    # of 32, 64 or 128); column counts that are not a multiple of
    # 32 (or of 4), rows of a width that is not a multiple of 4, and fewer
    # rows than k
    pytest.param("column", 16, (300, 130), id="column-k16"),
    pytest.param("column", 17, (200, 77), id="column-k17"),
    pytest.param("column", 32, (64, 45), id="column-k32"),
    pytest.param("column", 33, (20, 40), id="column-k33-fewer-rows"),
    pytest.param("row", 16, (40, 260), id="row-k16"),
    pytest.param("row", 17, (33, 250), id="row-k17"),
    pytest.param("row", 32, (10, 300), id="row-k32"),
    pytest.param("row", 33, (12, 21), id="row-k33-narrow"),
    # k past the kernels' 128-entry lists (the selection family on the
    # card), with ties, and fewer rows (columns) than k
    pytest.param("column", 129, (300, 40), id="column-k129"),
    pytest.param("column", 200, (150, 21), id="column-k200-fewer-rows"),
    pytest.param("row", 129, (20, 400), id="row-k129"),
    pytest.param("row", 200, (9, 150), id="row-k200-narrow"),
])
def test_extraction_topk_matches_jax_with_ties(fn, k, shape):
    rng = np.random.default_rng(5)
    x = rng.integers(0, 7, size=shape).astype(np.float32)
    if fn == "column":
        want = jbt.column_topk(jnp.asarray(x), k, block_q=128, interpret=True)
        got = tbt.column_topk(torch.from_numpy(x), k)
        ref = tbt.iterative_topk(torch.from_numpy(x.T.copy()), k)
    else:
        want = jbt.row_topk(jnp.asarray(x), k, block_q=64, interpret=True)
        got = tbt.row_topk(torch.from_numpy(x), k)
        ref = tbt.iterative_topk(torch.from_numpy(x), k)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    for g, w, r in zip(got, want, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), r.numpy())


@pytest.mark.parametrize("fn", ["column", "row"])
def test_extraction_topk_exhausted_slots_repeat_position_zero(fn):
    """Fewer than k values above -3e38: the tail is (-3e38, 0) on both
    sides, which the bucket glue's sentinel logic relies on."""
    x = np.full((6, 5), tbt.NEG_INF, np.float32)
    x[3, 1], x[4, 1], x[1, 2] = 0.5, 0.25, 0.5
    if fn == "row":
        x = np.ascontiguousarray(x.T)
        want = jbt.row_topk(jnp.asarray(x), 3, block_q=8, interpret=True)
        got = tbt.row_topk(torch.from_numpy(x), 3)
    else:
        want = jbt.column_topk(jnp.asarray(x), 3, block_q=128,
                               interpret=True)
        got = tbt.column_topk(torch.from_numpy(x), 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[1].numpy()[1], [3, 4, 0])
    assert (got[0].numpy()[0] == np.float32(tbt.NEG_INF)).all()


def test_iterative_topk_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 640)).astype(np.float32)
    want_v, want_i = jbt.iterative_topk(jnp.asarray(x), 7)
    v, i = tbt.iterative_topk(torch.from_numpy(x), 7)
    np.testing.assert_array_equal(v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("r_len,masked", [(1024, False), (1000, True)])
def test_phase1_bucket_max_matches_jnp_reference(r_len, masked):
    rng = np.random.default_rng(r_len)
    q, keys = _unit(rng, 20, 32), _unit(rng, r_len, 32)
    valid = rng.random(r_len) < 0.6 if masked else np.ones(r_len, bool)
    valid[128:256] = not masked         # one bucket with no valid key
    nb = -(-r_len // 128)
    scores = np.asarray(jnp.dot(jnp.asarray(keys).astype(jnp.bfloat16),
                                jnp.asarray(q).astype(jnp.bfloat16).T,
                                preferred_element_type=jnp.float32))
    scores = np.where(valid[:, None], scores, np.float32(tbt.NEG_INF))
    scores = np.pad(scores, ((0, nb * 128 - r_len), (0, 0)),
                    constant_values=np.float32(tbt.NEG_INF))
    want = scores.reshape(nb, 128, 20).max(axis=1)
    got = tbt.bucket_max(torch.from_numpy(keys).bfloat16(),
                         torch.from_numpy(q).bfloat16(),
                         torch.from_numpy(valid))
    assert got.shape == (nb, 20)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    if masked:
        assert (got.numpy()[1] == np.float32(tbt.NEG_INF)).all()


def test_phase2_rescore_matches_jnp_reference():
    rng = np.random.default_rng(7)
    n_q, r_len, e, p_max = 12, 300, 16, 5
    q, keys = _unit(rng, n_q, e), _unit(rng, r_len, e)
    valid = rng.random(r_len) < 0.8
    nb = -(-r_len // 128)
    assign = rng.integers(0, n_q + 3, size=(nb, p_max)).astype(np.int32)
    got = tbt.bucket_rescore(torch.from_numpy(assign),
                             torch.from_numpy(q).bfloat16(),
                             torch.from_numpy(keys).bfloat16(),
                             torch.from_numpy(valid)).numpy()
    assert got.shape == (nb, p_max, 128)
    scores = np.asarray(jnp.dot(jnp.asarray(q).astype(jnp.bfloat16),
                                jnp.asarray(keys).astype(jnp.bfloat16).T,
                                preferred_element_type=jnp.float32))
    for b in range(nb):
        for p in range(p_max):
            for lane in (0, 17, 43, 127):
                r = b * 128 + lane
                if r >= r_len or not valid[r]:
                    want = np.float32(tbt.NEG_INF)
                elif assign[b, p] >= n_q:
                    want = 0.0           # an empty slot of a valid key
                else:
                    want = scores[assign[b, p], r]
                assert abs(got[b, p, lane] - want) <= TOL, (b, p, lane)


def test_invert_pairs_lists_each_pair_once():
    """Every (query, bucket) pair lands once in the bucket's list, with its
    slot, in query order from column 0: the first ``p_max`` columns are the
    first launch of kernel F, each further ``p_max`` one more. Unused slots
    (id nb) land nowhere."""
    rng = np.random.default_rng(11)
    n_q, k, nb, p_max = 40, 5, 6, 8
    ids = np.stack([rng.permutation(nb + 1)[:k] for _ in range(n_q)])
    assign, slot = tbt.invert_pairs(torch.from_numpy(ids).int(), nb, p_max)
    demand = max(int((ids == b).sum()) for b in range(nb))
    assert demand > 2 * p_max          # three rounds or more
    assert assign.shape == slot.shape == (nb, -(-demand // p_max) * p_max)
    assert assign.dtype == torch.int32
    seen = []
    for b in range(nb):
        listed = [int(qid) for qid in assign[b] if qid < n_q]
        assert listed == sorted(listed)
        assert (assign[b, len(listed):] == n_q).all()
        for p, qid in enumerate(listed):
            assert ids[qid, int(slot[b, p])] == b
            seen.append((qid, b))
    want = [(qi, int(b)) for qi in range(n_q) for b in ids[qi] if b < nb]
    assert sorted(seen) == sorted(want)


def test_overflow_pairs_go_through_bucket_rescore(monkeypatch):
    """Past ``p_max`` queries a bucket, every (query, bucket) pair is still
    scored by ``bucket_rescore`` (kernel F on the card), ``p_max`` columns a
    launch, and the result still equals the JAX package's."""
    q_len, r_len, e, k, _, _, p_max = CASES["overflow-identical-queries"]
    rng = np.random.default_rng(len("overflow-identical-queries"))
    q, keys = _unit(rng, q_len, e), _unit(rng, r_len, e)
    q = np.repeat(q[:1], q_len, axis=0)
    calls = []

    def spy(assign, *args, **kwargs):
        calls.append(assign.clone())
        return real(assign, *args, **kwargs)
    real = tbt.bucket_rescore
    monkeypatch.setattr(tbt, "bucket_rescore", spy)
    qt, kt = torch.from_numpy(q), torch.from_numpy(keys)
    ids = tbt.bucket_candidates(qt.bfloat16(), kt.bfloat16(), k, None,
                                p_max)[2]
    rounds = len(calls)
    assert rounds == -(-q_len // p_max)     # every query wants k buckets
    assert all(c.shape == (r_len // 128, p_max) for c in calls)
    scored = sorted((int(qid), b) for c in calls
                    for b, row in enumerate(c.tolist())
                    for qid in row if qid < q_len)
    want = sorted((qi, int(b)) for qi in range(q_len) for b in ids[qi]
                  if b < r_len // 128)
    assert scored == want

    calls.clear()
    s, i = tbt.bucketed_exact_topk(qt, kt, k, p_max=p_max)
    assert len(calls) == rounds
    want_s, want_i = jbt.bucketed_exact_topk(
        jnp.asarray(q), jnp.asarray(keys), k, block_q=256, block_r=512,
        p_max=p_max, interpret=True)
    _assert_topk_close(s.numpy(), i.numpy(), want_s, want_i)


@pytest.mark.parametrize("n_q,n_r,e,sms", [
    (2048, 262_144, 64, 132),    # a refresh chunk: 16 x 16 blocks
    (2048, 262_144, 128, 132),   # the probe script's shape
    (2048, 262_144, 256, 132),   # one block of 128 queries per SM
    (4096, 262_144, 64, 114),
    (70, 1000, 64, 132),         # fewer blocks than SMs
    (1, 4097, 136, 132),
    (130, 2048, 8, 78),
    (2048, 262_144, 1000, 132),  # rows in chunks of 128 columns
    (5, 128_037, 512, 132),
])
def test_bucket_max_plan_is_one_wave_over_every_bucket(n_q, n_r, e, sms):
    """Kernel D's plan covers every bucket once, fits shared memory and the
    SMs' resident blocks, and takes 128 queries a block where that leaves
    no SM idle."""
    bq, ranges, per_range = tst.tile_plan(n_q, n_r, e, sms)
    nb = -(-n_r // 128)
    assert bq in (64, 128)
    assert (ranges - 1) * per_range < nb <= ranges * per_range
    # the resident query tile and two key tiles, 64-column atoms of the
    # width padded to 16; past 256 columns two stages of a 128-column query
    # chunk and key chunk
    if e > 256:
        smem = 1024 + 2 * (bq + 128) * 128 * 2
    else:
        smem = 1024 + (bq + 2 * 128) * 128 * -(-(-(-e // 16) * 16) // 64)
    assert smem <= 232_448
    per_sm = min(256 // bq, 233_472 // (smem + 1024))
    assert -(-n_q // bq) * ranges <= max(per_sm * sms, -(-n_q // bq))
    assert (bq == 128) == (-(-n_q // 128) * nb >= sms)
    if (n_q, n_r, e, sms) == (2048, 262_144, 64, 132):
        assert (bq, ranges, per_range) == (128, 16, 128)


@pytest.mark.parametrize("k", [1, 10, 16, 17, 32, 33, 128])
@pytest.mark.parametrize("n_q", [2048, 130, 1, 2049, 4100])
def test_column_topk_plan_is_one_wave_over_every_column(n_q, k):
    """Kernel E's plan: the list length (one list of 32, 64 or 128 a warp,
    the shortest that holds k) and the columns a block, which the kernel
    launches ceil(Q / cols) blocks of: every column once, and at the
    path's shape a block for each of an H100's 132 SMs."""
    kcap, cols = tbt._column_topk_plan(k)
    assert kcap in (32, 64, 128) and k <= kcap
    assert kcap == 32 or kcap // 2 < k
    assert cols == 8
    blocks = -(-n_q // cols)
    assert (blocks - 1) * cols < n_q <= blocks * cols
    if n_q == 2048:
        assert blocks >= 132


@pytest.mark.parametrize("k", [1, 10, 16, 17, 32, 33, 128])
@pytest.mark.parametrize("n_q,sms", [(2048, 132), (300, 132), (1, 132),
                                     (9, 78), (4096, 114)])
def test_row_topk_plan_covers_every_row(n_q, k, sms):
    """Kernel G's plan: one warp a row, every row once, four warps a block
    unless that leaves an SM without a block, and the register lists of
    kernel E."""
    kcap, warps = tbt._row_topk_plan(n_q, k, sms)
    assert kcap == tbt._column_topk_plan(k)[0]
    assert warps in (1, 2, 4)
    blocks = -(-n_q // warps)
    assert (blocks - 1) * warps < n_q <= blocks * warps
    assert blocks >= sms or warps == 1
    if n_q == 2048:
        assert (warps, blocks) == (4, 512)


CASES = {
    # name: (Q, R, E, k, n_valid, identical queries, p_max)
    "multiple-of-block": (32, 2048, 64, 10, None, False, 32),
    "unpadded": (13, 3000, 48, 4, None, False, 32),
    "valid-mask": (16, 2048, 32, 5, 700, False, 32),
    "overflow-identical-queries": (64, 2048, 32, 6, None, True, 4),
    "fewer-nonempty-buckets-than-k": (16, 600, 64, 8, 200, False, 32),
    "fewer-valid-rows-than-k": (9, 700, 16, 6, 4, False, 32),
    "fewer-buckets-than-k": (8, 200, 16, 10, None, False, 32),
    "more-than-4096-queries": (4100, 1024, 16, 3, None, False, 32),
}


@pytest.mark.parametrize("case", list(CASES))
def test_bucketed_exact_topk_matches_jax(case):
    q_len, r_len, e, k, n_valid, identical, p_max = CASES[case]
    rng = np.random.default_rng(len(case))
    q, keys = _unit(rng, q_len, e), _unit(rng, r_len, e)
    if identical:
        q = np.repeat(q[:1], q_len, axis=0)
    valid = None
    if n_valid is not None:
        valid = np.arange(r_len) < n_valid      # the first rows: few buckets
    want_s, want_i = jbt.bucketed_exact_topk(
        jnp.asarray(q), jnp.asarray(keys), k,
        valid_mask=None if valid is None else jnp.asarray(valid),
        block_q=256, block_r=512, p_max=p_max, interpret=True)
    s, i = tbt.bucketed_exact_topk(
        torch.from_numpy(q), torch.from_numpy(keys), k,
        valid_mask=None if valid is None else torch.from_numpy(valid),
        p_max=p_max)
    assert s.shape == i.shape == (q_len, k)
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    s, i = s.numpy(), i.numpy()
    live = np.isfinite(s)
    n_live = min(k, r_len if n_valid is None else n_valid)
    assert (live.sum(axis=1) == n_live).all()
    # exhausted slots: (-inf, 0); the JAX dense branch (fewer buckets than
    # k) leaves a padding row's index there, so only live slots compare
    assert (s[~live] == -np.inf).all() and (i[~live] == 0).all()
    _assert_topk_close(s, i, want_s, want_i, live)
    assert i[live].max() < (r_len if n_valid is None else n_valid)
    for row, row_live in zip(i, live):
        assert len(set(row[row_live])) == row_live.sum()
    # and against the dense sort of the same scores
    dense = tst.fma_chain(torch.from_numpy(q).bfloat16()[:, None, :],
                          torch.from_numpy(keys).bfloat16()[None, :, :])
    if valid is not None:
        dense[:, ~torch.from_numpy(valid)] = -torch.inf
    ref = torch.sort(dense, dim=1, descending=True, stable=True).values
    np.testing.assert_array_equal(s, ref[:, :k].numpy())


@pytest.mark.parametrize("k", [129, 300])
@pytest.mark.parametrize("e", [12, 100, 264])
def test_bucketed_exact_topk_large_k_matches_jax(k, e):
    """Every k and every width against the JAX package's kernels in
    interpret mode, with a valid mask (at R = 2,100 both sides take their
    dense branch: fewer buckets than k)."""
    rng = np.random.default_rng(k * e)
    q, keys = _unit(rng, 20, e), _unit(rng, 2100, e)
    valid = np.arange(2100) % 7 != 3
    want_s, want_i = jbt.bucketed_exact_topk(
        jnp.asarray(q), jnp.asarray(keys), k, valid_mask=jnp.asarray(valid),
        block_q=256, block_r=512, interpret=True)
    s, i = tbt.bucketed_exact_topk(torch.from_numpy(q),
                                   torch.from_numpy(keys), k,
                                   valid_mask=torch.from_numpy(valid))
    assert s.shape == i.shape == (20, k)
    _assert_topk_close(s.numpy(), i.numpy(), want_s, want_i)
    assert valid[i.numpy()].all()


@pytest.mark.parametrize("e", [12, 100])
def test_bucketed_exact_topk_large_k_through_the_buckets(e):
    """k = 129 with at least k buckets (R = 128 k + 37): the port's path of
    kernels D, E, F, G and its glue, with E and G past their 128-entry
    lists. The JAX kernels in interpret mode take over 10 s here, so the
    reference is JAX's ``cosine_topk(method="exact")`` on the bf16-rounded
    rows: scores within TOL, indices apart only inside a tie."""
    k, r_len = 129, 128 * 129 + 37
    rng = np.random.default_rng(e)
    q, keys = _unit(rng, 5, e), _unit(rng, r_len, e)
    qb = torch.from_numpy(q).bfloat16().float().numpy()
    kb = torch.from_numpy(keys).bfloat16().float().numpy()
    want_s, want_i = jtopk.cosine_topk(
        jnp.asarray(qb), jnp.asarray(kb), k, queries_normalized=True,
        keys_normalized=True, method="exact")
    s, i = tbt.bucketed_exact_topk(torch.from_numpy(q),
                                   torch.from_numpy(keys), k)
    assert -(-r_len // tbt.LANE) >= k       # the bucket path, not the dense
    _assert_topk_close(s.numpy(), i.numpy(), want_s, want_i)
    assert all(len(set(row)) == k for row in i.numpy())


@pytest.mark.parametrize("masked", [False, True])
def test_cosine_topk_bucket_matches_jax(masked, monkeypatch):
    rng = np.random.default_rng(21)
    q = rng.normal(size=(24, 32)).astype(np.float32)      # not normalised
    keys = rng.normal(size=(1500, 32)).astype(np.float32)
    valid = rng.random(1500) < 0.7 if masked else None
    want_s, want_i = jtopk.cosine_topk(
        jnp.asarray(q), jnp.asarray(keys), 10, method="bucket",
        valid_mask=None if valid is None else jnp.asarray(valid))
    kw = dict(valid_mask=None if valid is None else torch.from_numpy(valid))
    s, i = ttopk.cosine_topk(torch.from_numpy(q), torch.from_numpy(keys), 10,
                             method="bucket", **kw)
    # 1e-6: the two packages normalise the rows with different roundings
    # before the bf16 cast; indices may swap only across such differences
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), rtol=0,
                               atol=1e-6)
    mism = i.numpy() != np.asarray(want_i)
    assert mism.mean() < 0.05
    if masked:
        assert valid[i.numpy()].all()
    # "auto" asks for the bucket kernels when exact results are wanted at
    # scale (the threshold made small for the test)
    monkeypatch.setattr(ttopk, "AUTO_APPROX_THRESHOLD", 1000)
    s2, i2 = ttopk.cosine_topk(torch.from_numpy(q), torch.from_numpy(keys),
                               10, recall_target=1.0, **kw)
    np.testing.assert_array_equal(s2.numpy(), s.numpy())
    np.testing.assert_array_equal(i2.numpy(), i.numpy())


@pytest.mark.parametrize("fn,shape", [("column", (0, 5)),
                                      ("row", (5, 0))])
def test_topk_rejects_an_empty_axis(fn, shape):
    """E and G select along an axis with at least one value: an empty one
    is a ValueError on every device, not a row of exhausted slots."""
    f = tbt.column_topk if fn == "column" else tbt.row_topk
    with pytest.raises(ValueError, match="at least one"):
        f(torch.zeros(shape), 1)
    # the other axis may be empty: no columns (rows) to select for
    other = (shape[1], shape[0])
    v, i = f(torch.zeros(other), 1)
    assert v.shape == (0, 1) and i.shape == (0, 1)


def test_limits_and_exports():
    x = torch.zeros(4, 8)
    for fn in (tbt.column_topk, tbt.row_topk):
        with pytest.raises(ValueError, match="k >= 1"):
            fn(x, 0)
    with pytest.raises(ValueError, match="k >= 1"):
        tbt.bucketed_exact_topk(x, x, 0)
    with pytest.raises(ValueError, match="valid_mask"):
        tbt.bucketed_exact_topk(x, torch.zeros(300, 8), 2,
                                valid_mask=torch.ones(5, dtype=torch.bool))
    assert tops.bucketed_exact_topk is tbt.bucketed_exact_topk
    assert tops.column_topk is tbt.column_topk
    assert tops.row_topk is tbt.row_topk
    assert tbt.NEG_INF == jbt.NEG_INF and tbt.LANE == jbt.LANE
