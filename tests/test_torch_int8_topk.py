"""The port's int8 scoring tier of ``cosine_topk`` against the JAX package,
and ``retrieve_dtype="int8"`` through ``generate``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragraph_tpu.data import load_edge_dataset as j_load_edge_dataset
from ragraph_tpu.data import synthetic_edge_stream as j_synthetic
from ragraph_tpu.models import edge as jedge
from ragraph_tpu.ops import topk as jtopk
from ragraph_tpu_torch.convert import (int8_keys_from_jax, params_from_jax,
                                       resources_from_jax)
from ragraph_tpu_torch.data.edgelist import load_edge_dataset
from ragraph_tpu_torch.data.synthetic import synthetic_edge_stream
from ragraph_tpu_torch.models import edge as tedge
from ragraph_tpu_torch.ops import topk as ttopk

Q, R, E, K = 24, 600, 32, 10
SCALE = 1.0 / (127.0 * 127.0)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(Q, E)).astype(np.float32),
            rng.normal(size=(R, E)).astype(np.float32),
            rng.random(R) < 0.7)


def _both(data, k=K, masked=False, prequantized=False, **kw):
    """``cosine_topk(score_dtype="int8")`` on both sides; with
    ``prequantized`` the JAX package's int8 table serves both and the float
    table is passed as ``rescore_keys`` when a rescore is asked for."""
    q, keys, valid = data
    jkw, tkw = dict(kw), dict(kw)
    jkeys, tkeys = jnp.asarray(keys), torch.from_numpy(keys)
    if prequantized:
        table = np.asarray(jtopk.quantize_keys_i8(jkeys))
        if kw.get("rescore_pad"):
            jkw["rescore_keys"], tkw["rescore_keys"] = jkeys, tkeys
        jkeys, tkeys = jnp.asarray(table), int8_keys_from_jax(table, "cpu")
    if masked:
        jkw["valid_mask"] = jnp.asarray(valid)
        tkw["valid_mask"] = torch.from_numpy(valid)
    want = jtopk.cosine_topk(jnp.asarray(q), jkeys, k, score_dtype="int8",
                             **jkw)
    got = ttopk.cosine_topk(torch.from_numpy(q), tkeys, k,
                            score_dtype="int8", **tkw)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _int_scores(data):
    """The exact integer score matrix of the quantized rows."""
    q, keys, _ = data
    qi = ttopk._quantize_i8(ttopk.l2_normalize(torch.from_numpy(q)))
    ki = ttopk.quantize_keys_i8(torch.from_numpy(keys))
    return qi.long() @ ki.long().T


def test_quantized_tables_equal_jax(data):
    q, keys, _ = data
    want = np.asarray(jtopk.quantize_keys_i8(jnp.asarray(keys)))
    got = ttopk.quantize_keys_i8(torch.from_numpy(keys))
    assert got.dtype == torch.int8 and want.dtype == np.int8
    # the two packages normalise with different roundings, so a value that
    # lies on a rounding boundary may land one step apart
    diff = np.abs(got.numpy().astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff != 0).mean() < 1e-3
    unit = keys / np.linalg.norm(keys, axis=1, keepdims=True)
    np.testing.assert_array_equal(
        ttopk.quantize_keys_i8(torch.from_numpy(unit),
                               normalized=True).numpy(),
        np.asarray(jtopk.quantize_keys_i8(jnp.asarray(unit),
                                          normalized=True)))
    np.testing.assert_array_equal(
        ttopk._quantize_i8(torch.tensor([2.0, -2.0, 0.5 / 127, 1.5 / 127])),
        np.asarray(jtopk._quantize_i8(jnp.asarray(
            [2.0, -2.0, 0.5 / 127, 1.5 / 127]))))       # clip, half to even
    assert int8_keys_from_jax(want, "cpu").dtype == torch.int8
    with pytest.raises(ValueError, match="int8"):
        int8_keys_from_jax(keys, "cpu")


@pytest.mark.parametrize("method", ["exact", "approx"])
@pytest.mark.parametrize("masked", [False, True])
def test_int8_scores_and_indices_match_jax(data, method, masked):
    """No rescore: the scores are the integer products times 1/127^2, equal
    bit for bit when both sides score the same int8 table. Int8 scores tie
    often, and the two sorts break ties differently, so an index is held to
    its score."""
    (want_s, want_i), (s, i) = _both(data, masked=masked, prequantized=True,
                                     method=method)
    np.testing.assert_array_equal(s, want_s)
    ints = _int_scores(data)
    picked = torch.gather(ints, 1, torch.from_numpy(i)).numpy()
    np.testing.assert_array_equal(
        (picked.astype(np.float32) * np.float32(SCALE)), s)
    assert (np.diff(s, axis=1) <= 0).all()
    if masked:
        assert data[2][i].all()
    mism = i != want_i
    assert (s[mism] == want_s[mism]).all()


@pytest.mark.parametrize("prequantized", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_int8_rescore_matches_jax(data, prequantized, masked):
    """With ``rescore_pad`` the scores are full-precision cosines of the
    top candidates; 1e-6 covers the two packages' normalisation and sum
    order, and indices may swap only across such a difference."""
    (want_s, want_i), (s, i) = _both(data, masked=masked,
                                     prequantized=prequantized,
                                     method="exact", rescore_pad=22)
    np.testing.assert_allclose(s, want_s, rtol=0, atol=1e-6)
    mism = i != want_i
    assert mism.mean() < 0.05
    q, keys, valid = data
    unit_q = q / np.linalg.norm(q, axis=1, keepdims=True)
    unit_k = keys / np.linalg.norm(keys, axis=1, keepdims=True)
    true = np.take_along_axis(unit_q @ unit_k.T, i.astype(np.int64), axis=1)
    np.testing.assert_allclose(s, true, rtol=0, atol=1e-6)
    if masked:
        assert valid[i].all()


def test_int8_fewer_valid_rows_than_candidates(data):
    q, keys, _ = data
    valid = np.arange(R) < 15                   # k + rescore_pad = 32 > 15
    small = (q, keys, valid)
    (want_s, want_i), (s, i) = _both(small, masked=True, method="exact",
                                     rescore_pad=22)
    np.testing.assert_allclose(s, want_s, rtol=0, atol=1e-6)
    assert (i < 15).all()
    # a library smaller than the candidate window
    tiny = (q, keys[:20], valid[:20])
    (want_s, _), (s, i) = _both(tiny, method="exact", rescore_pad=22)
    np.testing.assert_allclose(s, want_s, rtol=0, atol=1e-6)


def test_int8_guards_match_jax(data):
    """Every ``ValueError`` of the JAX dispatch, with the same words."""
    q, keys, _ = data
    tq, tk = torch.from_numpy(q), torch.from_numpy(keys)
    jq, jk = jnp.asarray(q), jnp.asarray(keys)
    ti8, ji8 = ttopk.quantize_keys_i8(tk), jtopk.quantize_keys_i8(jk)
    cases = [
        (dict(score_dtype="int8", method="bucket"), "exact-score contract"),
        (dict(score_dtype="int8", method="pallas"), "exact-score contract"),
        (dict(score_dtype="fp8"), "unknown score_dtype"),
        (dict(rescore_pad=4), "only meaningful with score_dtype='int8'"),
        (dict(score_dtype="int8", rescore_keys="float", rescore_pad=4),
         "pre-quantized int8 keys"),
        (dict(keys="int8"), "int8 keys require score_dtype='int8'"),
        (dict(keys="int8", score_dtype="int8", rescore_pad=4),
         "rescore_pad needs full-precision rows"),
        (dict(keys="int8", score_dtype="int8", rescore_keys="float"),
         "rescore_pad > 0"),
    ]
    for kw, match in cases:
        kw = dict(kw)
        use_i8 = kw.pop("keys", None) == "int8"
        with_rescore = kw.pop("rescore_keys", None) == "float"
        with pytest.raises(ValueError, match=match):
            jtopk.cosine_topk(jq, ji8 if use_i8 else jk, K,
                              rescore_keys=jk if with_rescore else None,
                              **kw)
        with pytest.raises(ValueError, match=match):
            ttopk.cosine_topk(tq, ti8 if use_i8 else tk, K,
                              rescore_keys=tk if with_rescore else None,
                              **kw)
    # a slice of the port's f32 sums of int8 products is exact to E = 1040
    assert 127 * 127 * ttopk.INT8_SLICE_E < 2 ** 24 \
        <= 127 * 127 * (ttopk.INT8_SLICE_E + 1)


@pytest.mark.parametrize("e", [1100, 2500])
def test_int8_wide_rows_match_jax(e):
    """Rows wider than the 1,040 columns whose int8 products are sure to
    sum exactly in f32: the port adds the slices' exact sums in int32, as
    the JAX package's s32 product does, so the scores are its bit for bit
    (positive rows and three keys equal to queries: large sums)."""
    rng = np.random.default_rng(e)
    q = np.abs(rng.normal(size=(6, e))).astype(np.float32)
    keys = np.abs(rng.normal(size=(300, e))).astype(np.float32)
    keys[:3] = q[:3]
    want_s, want_i = jtopk.cosine_topk(jnp.asarray(q), jnp.asarray(keys), 5,
                                       score_dtype="int8", method="exact")
    s, i = ttopk.cosine_topk(torch.from_numpy(q), torch.from_numpy(keys), 5,
                             score_dtype="int8", method="exact")
    np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))
    mism = i.numpy() != np.asarray(want_i)
    assert (s.numpy()[mism] == np.asarray(want_s)[mism]).all()
    qi = ttopk._quantize_i8(ttopk.l2_normalize(torch.from_numpy(q)))
    ki = ttopk.quantize_keys_i8(torch.from_numpy(keys))
    ints = qi.long() @ ki.long().T
    assert int(ints.max()) >= 2 ** 13
    np.testing.assert_array_equal(
        ttopk._int8_dot(qi, ki).numpy(), ints.float().numpy())


def test_int8_auto_above_the_threshold(data, monkeypatch):
    """``auto`` above the threshold scores int8 through ``approx`` (exact
    here) and refuses ``recall_target=1``, which asks for ``bucket``."""
    q, keys, _ = data
    monkeypatch.setattr(ttopk, "AUTO_APPROX_THRESHOLD", 100)
    tq, tk = torch.from_numpy(q), torch.from_numpy(keys)
    s, i = ttopk.cosine_topk(tq, tk, K, score_dtype="int8")
    s2, _ = ttopk.cosine_topk(tq, tk, K, score_dtype="int8", method="exact")
    np.testing.assert_array_equal(s.numpy(), s2.numpy())
    with pytest.raises(ValueError, match="exact-score contract"):
        ttopk.cosine_topk(tq, tk, K, score_dtype="int8", recall_target=1.0)


def test_retrieve_dtype_int8_through_generate():
    """``retrieve_dtype="int8"`` in ``_fuse_rag`` on both sides, the JAX
    side's library carried over. A tie among int8 scores at the k-th place
    may pick another of ~10 neighbours (values of magnitude <= ~0.3, weight
    0.3), so a handful of rows may differ by up to ~2e-2; most are equal."""
    j_train, j_stages = j_synthetic(seed=0)
    train, stages = synthetic_edge_stream(seed=0)
    jg = jedge.EdgeGraphArrays.from_dataset(
        j_load_edge_dataset(j_train, j_stages[0]))
    tg = tedge.EdgeGraphArrays.from_dataset(
        load_edge_dataset(train, stages[0]), "cpu")
    kw = dict(retrieve_dtype="int8", rag_chunk=64)
    jm = jedge.RAGraphEdge(jedge.EdgeModelConfig(**kw), jg, phase="vanilla")
    tm = tedge.RAGraphEdge(tedge.EdgeModelConfig(**kw), tg, phase="vanilla")
    jparams = jm.init_params(jax.random.key(1))
    tparams = params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                              "cpu")
    jres = jm.make_resource_graph(*jm.generate(jparams), jax.random.key(2))
    tres = resources_from_jax(np.asarray(jres[0]), np.asarray(jres[1]), "cpu")
    want = jm.generate(jparams, resources=jres)
    got = tm.generate(tparams, resources=tres)
    exact = tedge.RAGraphEdge(tedge.EdgeModelConfig(rag_chunk=64), tg,
                              phase="vanilla").generate(tparams,
                                                        resources=tres)
    for g, w, x in zip(got, want, exact):
        err = np.abs(g.numpy() - np.asarray(w)).max(axis=1)
        assert err.max() < 2e-2
        assert (err > 1e-5).mean() < 0.1
        # and int8 retrieval is not the f32 retrieval
        assert (g - x).abs().max() > 1e-4
