"""The port's retrieval ops against the JAX package: the fused cosine top-k
(JAX Pallas kernel in interpret mode), the exact ``cosine_topk`` and the
cosine similarity helpers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragraph_tpu.ops import pallas_retrieval as jret
from ragraph_tpu.ops import similarity as jsim
from ragraph_tpu.ops import topk as jtopk
from ragraph_tpu_torch.ops import fused_retrieval as tret
from ragraph_tpu_torch.ops import score_tile as tst
from ragraph_tpu_torch.ops import similarity as tsim
from ragraph_tpu_torch.ops import topk as ttopk

TIE = 1e-6   # scores agree to this; indices may differ only inside a tie


def _unit(rng, n, e):
    x = rng.normal(size=(n, e)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _assert_topk_equal(s, i, want_s, want_i):
    """Scores within TIE; indices equal except inside a run of neighbouring
    scores within TIE (a tie the two sides may order apart), or in the last
    column (a tie with a row just outside the top-k)."""
    s, i = np.asarray(s), np.asarray(i)
    want_s, want_i = np.asarray(want_s), np.asarray(want_i)
    np.testing.assert_allclose(s, want_s, rtol=0, atol=TIE)
    for r, c in zip(*np.nonzero(i != want_i)):
        run = np.abs(want_s[r] - want_s[r, c]) <= TIE
        assert run.sum() > 1 or c == len(run) - 1, \
            f"row {r} col {c}: {i[r]} vs {want_i[r]}"


@pytest.mark.parametrize("q_len,r_len,e,k,n_valid", [
    (16, 256, 64, 10, None),     # R a multiple of the JAX block
    (5, 300, 32, 10, 3),         # fewer valid rows than k
    (1, 129, 16, 50, 100),       # one query, ragged R, invalid rows
    (9, 200, 8, 128, None),      # k at the kernel's limit, k < R < 2k
])
def test_fused_cosine_topk_matches_jax(q_len, r_len, e, k, n_valid):
    rng = np.random.default_rng(q_len + r_len)
    q, keys = _unit(rng, q_len, e), _unit(rng, r_len, e)
    valid = None
    if n_valid is not None:
        valid = np.zeros(r_len, bool)
        valid[rng.permutation(r_len)[:n_valid]] = True
    want_s, want_i = jret.fused_cosine_topk(
        jnp.asarray(q), jnp.asarray(keys), k,
        valid_mask=None if valid is None else jnp.asarray(valid),
        block_q=8, block_r=128, interpret=True)
    s, i = tret.fused_cosine_topk(
        torch.from_numpy(q), torch.from_numpy(keys), k,
        valid_mask=None if valid is None else torch.from_numpy(valid))
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    _assert_topk_equal(s, i, want_s, want_i)
    # exhausted slots: score -3e38, index 0, on both sides
    n_live = r_len if n_valid is None else n_valid
    if n_live < k:
        assert np.all(s.numpy()[:, n_live:] == np.float32(tret.NEG_INF))
        assert np.all(i.numpy()[:, n_live:] == 0)
        np.testing.assert_array_equal(np.asarray(want_i)[:, n_live:], 0)
    if valid is not None:
        live = s.numpy() > tret.NEG_INF
        assert valid[i.numpy()[live]].all()


def test_fused_cosine_topk_ties_keep_the_lowest_indices():
    """Duplicated keys: both sides keep the lowest indices; the port lists
    them in ascending order, the TPU kernel in descending order."""
    rng = np.random.default_rng(0)
    q = _unit(rng, 3, 32)
    keys = np.repeat(_unit(rng, 1, 32), 300, axis=0)
    want_s, want_i = jret.fused_cosine_topk(jnp.asarray(q), jnp.asarray(keys),
                                            5, block_q=8, block_r=128,
                                            interpret=True)
    s, i = tret.fused_cosine_topk(torch.from_numpy(q),
                                  torch.from_numpy(keys), 5)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), atol=TIE)
    np.testing.assert_array_equal(i.numpy(), np.tile(np.arange(5), (3, 1)))
    np.testing.assert_array_equal(np.sort(np.asarray(want_i), axis=1),
                                  i.numpy())


@pytest.mark.parametrize("k", [129, 300])
@pytest.mark.parametrize("e", [12, 100, 264])
def test_fused_cosine_topk_large_k_matches_jax(k, e):
    """Every k and every width: k above the kernel's 128-entry lists (the
    selection family on the card) and widths that are not a multiple of 8
    or pass 256 (padded rows, chunks of 128 columns on the card), with a
    valid mask, against the TPU kernel in interpret mode."""
    rng = np.random.default_rng(k + e)
    q_len, r_len = 20, 2100
    q, keys = _unit(rng, q_len, e), _unit(rng, r_len, e)
    valid = rng.random(r_len) < 0.9
    want_s, want_i = jret.fused_cosine_topk(
        jnp.asarray(q), jnp.asarray(keys), k, valid_mask=jnp.asarray(valid),
        block_q=8, block_r=128, interpret=True)
    s, i = tret.fused_cosine_topk(torch.from_numpy(q),
                                  torch.from_numpy(keys), k,
                                  valid_mask=torch.from_numpy(valid))
    assert s.shape == i.shape == (q_len, k)
    _assert_topk_equal(s, i, want_s, want_i)
    assert valid[i.numpy()].all()


@pytest.mark.parametrize("k,r_len,n_valid", [(300, 150, None),
                                             (200, 600, 129)])
def test_fused_cosine_topk_large_k_past_the_rows(k, r_len, n_valid):
    """k above R, or above the valid rows: both sides fill the slots past
    them with (-3e38, 0)."""
    rng = np.random.default_rng(r_len)
    q, keys = _unit(rng, 6, 100), _unit(rng, r_len, 100)
    valid = None
    if n_valid is not None:
        valid = np.zeros(r_len, bool)
        valid[rng.permutation(r_len)[:n_valid]] = True
    want_s, want_i = jret.fused_cosine_topk(
        jnp.asarray(q), jnp.asarray(keys), k,
        valid_mask=None if valid is None else jnp.asarray(valid),
        block_q=8, block_r=128, interpret=True)
    s, i = tret.fused_cosine_topk(
        torch.from_numpy(q), torch.from_numpy(keys), k,
        valid_mask=None if valid is None else torch.from_numpy(valid))
    _assert_topk_equal(s, i, want_s, want_i)
    n_live = r_len if n_valid is None else n_valid
    assert np.all(s.numpy()[:, n_live:] == np.float32(tret.NEG_INF))
    assert np.all(i.numpy()[:, n_live:] == 0)


def test_fused_cosine_topk_rejects_k_below_one():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="k >= 1"):
        tret.fused_cosine_topk(x, x, 0)


def test_bf16_rows_pads_to_a_multiple_of_8():
    """The kernels' 16-byte row loads: a width that is not a multiple of 8
    is copied into zero-padded bf16 rows (a zero column adds 0 to every
    product); contiguous bf16 rows of such a width are taken as they are."""
    x = torch.randn(5, 12)
    p = tst.bf16_rows(x)
    assert p.shape == (5, 16) and p.dtype == torch.bfloat16
    assert torch.equal(p[:, :12], x.bfloat16()) and not p[:, 12:].any()
    y = torch.randn(4, 16).bfloat16()
    assert tst.bf16_rows(y) is y
    assert tst.bf16_rows(torch.randn(3, 1)).shape == (3, 8)


@pytest.mark.parametrize("seed,k,n_valid", [
    (0, 1, None), (1, 5, None), (2, 17, None), (3, 40, 30), (4, 128, 90)])
def test_fused_cosine_topk_plain_ties_in_shuffled_order(seed, k, n_valid):
    """Duplicate keys scattered in shuffled order: equal scores come out in
    ascending index order, the members are the lowest indices, and slots
    past the valid rows hold (-3e38, 0). The order is (score descending,
    index ascending) of the plain version's own scores."""
    rng = np.random.default_rng(seed)
    base = _unit(rng, 6, 16)
    keys = base[rng.integers(0, 6, 150)]          # 150 keys, 6 distinct
    q = _unit(rng, 4, 16)
    valid = None
    if n_valid is not None:
        valid = np.zeros(150, bool)
        valid[rng.permutation(150)[:n_valid]] = True
    s, i = tret.fused_cosine_topk(
        torch.from_numpy(q), torch.from_numpy(keys), k,
        valid_mask=None if valid is None else torch.from_numpy(valid))
    s, i = s.numpy(), i.numpy()
    scores = (torch.from_numpy(q).bfloat16().float()
              @ torch.from_numpy(keys).bfloat16().float().T).numpy()
    n_live = 150 if valid is None else n_valid
    for r in range(4):
        cand = np.arange(150) if valid is None else np.nonzero(valid)[0]
        order = cand[np.lexsort((cand, -scores[r, cand]))][:k]
        m = min(k, n_live)
        np.testing.assert_array_equal(i[r, :m], order)
        np.testing.assert_array_equal(s[r, :m], scores[r, order])
        assert np.all(s[r, m:] == np.float32(tret.NEG_INF))
        assert np.all(i[r, m:] == 0)
        tied = s[r, 1:m] == s[r, :m - 1]
        assert np.all(i[r, 1:m][tied] > i[r, :m - 1][tied])
    # each key is repeated, so some tie runs are longer than one
    assert (s[:, 1:min(k, n_live)] == s[:, :min(k, n_live) - 1]).any() \
        or k < 3


SMS = 132   # an H100 SXM's SMs


@pytest.mark.parametrize("n_r", [1, 63, 64, 65, 65_536, 238_735, 262_144])
@pytest.mark.parametrize("n_q", [1, 384, 2048, 4096, 238_735])
def test_fused_tile_plan_covers_the_keys(n_q, n_r):
    """Kernel C's tile plan: at most 32 ranges, each a whole number of
    128-key tiles and none empty, that together cover R; a block of 64
    queries whose ring, lists and barriers fit shared memory."""
    for e, k in ((64, 10), (256, 4), (8, 1), (136, 50), (256, 128),
                 (264, 10), (512, 4), (1000, 128)):
        bq, splits, rows = tret._splits(n_q, n_r, e, k, SMS)
        assert bq == tret.BLOCK_Q == 64
        assert rows > 0 and rows % tst.LANE == 0
        assert 1 <= splits <= 32
        assert (splits - 1) * rows < n_r <= splits * rows
        assert tret._smem_bytes(e, k) <= tst.SMEM_BLOCK


@pytest.mark.parametrize("sms", [SMS, 114])
@pytest.mark.parametrize("n_q,n_r,e,k", [
    (2048, 262_144, 64, 10),    # an edge refresh chunk
    (384, 65_536, 256, 4),      # a node retrieve
    (384, 65_536, 512, 4),      # a node retrieve at --hidden 512
])
def test_fused_tile_plan_fills_the_card_in_one_wave(sms, n_q, n_r, e, k):
    """At the paths' shapes every SM gets a block and all blocks are
    resident at once; the registers and shared memory of the blocks an SM
    holds fit it (a block is 256 threads, 128 registers each at launch,
    two an SM where shared memory lets them)."""
    bq, splits, _ = tret._splits(n_q, n_r, e, k, sms)
    blocks = -(-n_q // bq) * splits
    regs = tret.REGS_SM // (tret.BLOCK_THREADS * tret.BLOCKS_PER_SM)
    per_sm = min(tret.BLOCKS_PER_SM, tst.SMEM_SM
                 // (tret._smem_bytes(e, k) + tst.SMEM_RESERVED))
    assert sms <= blocks <= per_sm * sms
    assert per_sm >= 1 and regs == 128
    assert per_sm * tret.BLOCK_THREADS * regs <= tret.REGS_SM
    assert per_sm * (tret._smem_bytes(e, k) + tst.SMEM_RESERVED) \
        <= tst.SMEM_SM


@pytest.mark.parametrize("n_q,k,plan", [
    (4096, 10, (64, 4, 59_776)),       # one rag_chunk of edge-amazon
    (238_735, 10, (64, 1, 238_848)),   # all its nodes in one call
    (4096, 20, (64, 4, 59_776)),       # the k of taobao's finetune
    (238_735, 20, (64, 1, 238_848)),
])
def test_fused_tile_plan_at_an_edge_finetune_step(n_q, k, plan):
    """At edge-amazon's 238,735-row library: a chunk of 4,096 queries has
    64 blocks for the card's 264 slots (two an SM) and cuts the keys into 4
    ranges; every node's query in one call gives 3,731 blocks and one
    range, so each query's list climbs through the keys once."""
    assert tret._splits(n_q, 238_735, 64, k, SMS) == plan


def test_c_kernel_names_are_the_benchmarks():
    """``csrc/fused_retrieval.cu`` defines kernels named for each of kernel
    C's entries in the benchmark's ``RETRIEVAL_KERNELS`` (the substrings
    ``retrieval_ms`` reads a device trace by), and every other entry names
    a kernel of another source."""
    import pathlib
    import re

    from perfbench.metrics.counts import RETRIEVAL_KERNELS
    csrc = pathlib.Path(tret.__file__).resolve().parents[1] / "csrc"
    kernels = {src.name: re.findall(
        r"__global__\s+void\s+"
        r"(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s+)?(\w+)\s*\(",
        src.read_text()) for src in csrc.glob("*.cu")}
    c_names = ("topk_partial_kernel", "topk_merge_kernel")
    assert set(c_names) <= set(RETRIEVAL_KERNELS)
    for name in c_names:
        assert any(name in k for k in kernels["fused_retrieval.cu"]), name
    for name in RETRIEVAL_KERNELS:
        assert any(name in k for ks in kernels.values() for k in ks), name


@pytest.mark.parametrize("normalized", [True, False])
def test_cosine_topk_exact_matches_jax(normalized):
    rng = np.random.default_rng(3)
    q = rng.normal(size=(12, 24)).astype(np.float32)
    keys = rng.normal(size=(400, 24)).astype(np.float32)
    valid = rng.random(400) < 0.8
    if normalized:
        q, keys = _unit(rng, 12, 24), _unit(rng, 400, 24)
    for mask in (None, valid):
        want_s, want_i = jtopk.cosine_topk(
            jnp.asarray(q), jnp.asarray(keys), 7,
            valid_mask=None if mask is None else jnp.asarray(mask),
            queries_normalized=normalized, keys_normalized=normalized,
            method="exact")
        s, i = ttopk.cosine_topk(
            torch.from_numpy(q), torch.from_numpy(keys), 7,
            valid_mask=None if mask is None else torch.from_numpy(mask),
            queries_normalized=normalized, keys_normalized=normalized,
            method="exact")
        _assert_topk_equal(s, i, want_s, want_i)


def test_cosine_topk_dispatch(monkeypatch):
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.normal(size=(3, 16)).astype(np.float32))
    keys = torch.from_numpy(rng.normal(size=(64, 16)).astype(np.float32))
    invalid = torch.arange(64) >= 2      # 2 valid rows, k = 4
    # exact: -inf for invalid rows; fused ("pallas"/"approx"): -3e38, 0
    s, _ = ttopk.cosine_topk(q, keys, 4, valid_mask=~invalid, method="exact")
    assert torch.isinf(s[:, 2:]).all()
    for method in ("pallas", "approx"):
        s, i = ttopk.cosine_topk(q, keys, 4, valid_mask=~invalid,
                                 method=method)
        assert (s[:, 2:] == tret.NEG_INF).all() and (i[:, 2:] == 0).all()
    # auto: exact below the threshold, the fused kernel above it
    s_auto, _ = ttopk.cosine_topk(q, keys, 4, valid_mask=~invalid)
    assert torch.isinf(s_auto[:, 2:]).all()
    monkeypatch.setattr(ttopk, "AUTO_APPROX_THRESHOLD", 0)
    s_auto, _ = ttopk.cosine_topk(q, keys, 4, valid_mask=~invalid)
    assert (s_auto[:, 2:] == tret.NEG_INF).all()
    # exact results asked for above the threshold, or "bucket" by name: the
    # two-phase kernels, whose exhausted slots hold (-inf, 0)
    s_exact, i_exact = ttopk.cosine_topk(q, keys, 4, valid_mask=~invalid,
                                         method="exact")
    for kw in (dict(recall_target=1.0), dict(method="bucket")):
        s, i = ttopk.cosine_topk(q, keys, 4, valid_mask=~invalid, **kw)
        assert torch.isinf(s[:, 2:]).all() and (i[:, 2:] == 0).all()
        assert i.dtype == torch.int32
        # bf16 scores against f32 scores of unit rows
        torch.testing.assert_close(s[:, :2], s_exact[:, :2], rtol=0,
                                   atol=2e-2)
    # int8 scoring: above the threshold through "approx"
    s, i = ttopk.cosine_topk(q, keys, 4, valid_mask=~invalid,
                             score_dtype="int8")
    assert torch.isinf(s[:, 2:]).all() and (i[:, :2] < 2).all()
    torch.testing.assert_close(s[:, :2], s_exact[:, :2], rtol=0, atol=5e-2)
    vals = torch.arange(64 * 2, dtype=torch.float32).reshape(64, 2)
    assert ttopk.topk_gather(vals, torch.tensor([[1, 3]])).shape == (1, 2, 2)


@pytest.mark.parametrize("k", [129, 200])
def test_cosine_topk_approx_wide_rows_matches_jax(k, monkeypatch):
    """``cosine_topk`` above the (lowered) threshold at E = 100: the port's
    ``"approx"`` answers exactly through kernel C's contract (the selection
    family on the card), the JAX package's ``approx_max_k`` (exact on the
    CPU)."""
    rng = np.random.default_rng(k)
    q = rng.normal(size=(9, 100)).astype(np.float32)
    keys = rng.normal(size=(700, 100)).astype(np.float32)
    monkeypatch.setattr(ttopk, "AUTO_APPROX_THRESHOLD", 500)
    monkeypatch.setattr(jtopk, "AUTO_APPROX_THRESHOLD", 500)
    want_s, want_i = jtopk.cosine_topk(jnp.asarray(q), jnp.asarray(keys), k)
    s, i = ttopk.cosine_topk(torch.from_numpy(q), torch.from_numpy(keys), k)
    # 2e-2: bf16 scores (the port) against f32 scores of unit rows (JAX);
    # neighbours whose scores differ by less trade places, and a few trade
    # places with the first row past the k-th
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), rtol=0,
                               atol=2e-2)
    for got, want in zip(i.numpy(), np.asarray(want_i)):
        assert len(set(got) & set(want)) >= 0.95 * k


def test_similarity_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(20, 12)).astype(np.float32)
    x[3] = 0.0                                   # an all-zero row stays 0
    y = rng.normal(size=(30, 12)).astype(np.float32)
    np.testing.assert_allclose(
        tsim.l2_normalize(torch.from_numpy(x)).numpy(),
        np.asarray(jsim.l2_normalize(jnp.asarray(x))), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        tsim.cosine_similarity(torch.from_numpy(x), torch.from_numpy(y)),
        np.asarray(jsim.cosine_similarity(jnp.asarray(x), jnp.asarray(y))),
        rtol=1e-5, atol=1e-6)
