"""The port's k-th-largest selection and the huge-k branch of ``_fuse_rag``
against the JAX package."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragraph_tpu.data import load_edge_dataset as j_load_edge_dataset
from ragraph_tpu.data import synthetic_edge_stream as j_synthetic
from ragraph_tpu.models import edge as jedge
from ragraph_tpu.models.edge import ragraph_edge as j_ragraph_edge
from ragraph_tpu.ops import selection as jsel
from ragraph_tpu_torch.convert import params_from_jax, resources_from_jax
from ragraph_tpu_torch.data.edgelist import load_edge_dataset
from ragraph_tpu_torch.data.synthetic import synthetic_edge_stream
from ragraph_tpu_torch.models import edge as tedge
from ragraph_tpu_torch.models.edge import ragraph_edge as t_ragraph_edge
from ragraph_tpu_torch.ops import selection as tsel


def _awkward(rng, shape):
    """Normal draws with exact ties, negatives, zeros of both signs and
    infinities."""
    x = rng.normal(size=shape).astype(np.float32)
    x = np.where(rng.random(shape) < 0.3, np.round(x * 2) / 2, x)
    flat = x.reshape(-1)
    flat[:6] = [0.0, -0.0, np.inf, -np.inf, np.inf, 1e-45]
    return rng.permutation(flat).reshape(shape).astype(np.float32)


def _bits(x, bf16):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16 if bf16 else torch.int32).numpy()
    return np.asarray(jax.lax.bitcast_convert_type(
        x, jnp.int16 if bf16 else jnp.int32))


def test_ordered_keys_match_jax_as_integers():
    rng = np.random.default_rng(0)
    x = _awkward(rng, (9, 300))
    want = np.asarray(jsel.f32_to_ordered_key(jnp.asarray(x)))
    got = tsel.f32_to_ordered_key(torch.from_numpy(x))
    assert want.dtype == np.uint32 and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    back = tsel.ordered_key_to_f32(got)
    np.testing.assert_array_equal(_bits(back, False), x.view(np.int32))
    np.testing.assert_array_equal(
        _bits(back, False),
        _bits(jsel.ordered_key_to_f32(jnp.asarray(want)), False))
    # the keys order as the floats do (-0.0 is the key just below +0.0)
    order = np.argsort(x.reshape(-1), kind="stable")
    with np.errstate(invalid="ignore"):          # inf - inf
        rising = np.diff(x.reshape(-1)[order]) > 0
    assert (np.diff(got.numpy().reshape(-1)[order])[rising] > 0).all()

    xb = jnp.asarray(x).astype(jnp.bfloat16)
    tb = torch.from_numpy(x).to(torch.bfloat16)
    np.testing.assert_array_equal(_bits(tb, True), _bits(xb, True))
    want = np.asarray(jsel.bf16_to_ordered_key(xb))
    got = tsel.bf16_to_ordered_key(tb)
    assert want.dtype == np.uint16 and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    np.testing.assert_array_equal(_bits(tsel.ordered_key_to_bf16(got), True),
                                  _bits(tb, True))
    np.testing.assert_array_equal(
        _bits(tsel.ordered_key_to_bf16(got), True),
        _bits(jsel.ordered_key_to_bf16(jnp.asarray(want)), True))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 2, 77, 299, 300, 5000])
def test_rowwise_kth_largest_is_the_order_statistic(k, bf16):
    """Bitwise equal to the JAX package's and to a sort's k-th value, with
    ties, negatives and infinities; k = 1, k = R and k > R (clamped)."""
    rng = np.random.default_rng(k)
    x = _awkward(rng, (7, 300))
    x[3] = 0.25                                  # a row of one value
    xj = jnp.asarray(x).astype(jnp.bfloat16 if bf16 else jnp.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16 if bf16 else torch.float32)
    got = tsel.rowwise_kth_largest(xt, k)
    assert got.shape == (7, 1) and got.dtype == xt.dtype
    want = jsel.rowwise_kth_largest(xj, k)
    np.testing.assert_array_equal(_bits(got, bf16), _bits(want, bf16))
    srt = torch.sort(xt.float(), dim=1, descending=True).values
    ref = srt[:, min(k, 300) - 1:min(k, 300)].to(xt.dtype)
    np.testing.assert_array_equal(_bits(got, bf16), _bits(ref, bf16))
    # membership admits at least k rows, and exactly k without ties
    assert ((xt >= got).sum(dim=1) >= min(k, 300)).all()


def test_rowwise_kth_largest_casts_other_dtypes_to_f32():
    x = torch.arange(40, dtype=torch.float64).reshape(2, 20)
    got = tsel.rowwise_kth_largest(x, 3)
    assert got.dtype == torch.float32
    assert got[:, 0].tolist() == [17.0, 37.0]
    assert tsel.rowwise_kth_largest(x, 0)[:, 0].tolist() == [19.0, 39.0]


# ---- the huge-k branch of _fuse_rag -----------------------------------------

@pytest.fixture(scope="module")
def models():
    """RAGraph-edge in the vanilla phase on the synthetic stream (64 users,
    128 items), same weights on both sides, and the JAX side's library
    (one augmented copy, so 384 rows) carried to the port."""
    j_train, j_stages = j_synthetic(seed=0)
    train, stages = synthetic_edge_stream(seed=0)
    jg = jedge.EdgeGraphArrays.from_dataset(
        j_load_edge_dataset(j_train, j_stages[0]))
    tg = tedge.EdgeGraphArrays.from_dataset(
        load_edge_dataset(train, stages[0]), "cpu")
    kw = dict(retrieve_num=100, rag_chunk=50, num_augment_scale=1)
    jm = jedge.RAGraphEdge(jedge.EdgeModelConfig(**kw), jg, phase="vanilla")
    tm = tedge.RAGraphEdge(tedge.EdgeModelConfig(**kw), tg, phase="vanilla")
    jparams = jm.init_params(jax.random.key(1))
    tparams = params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                              "cpu")
    jres = jm.make_resource_graph(*jm.generate(jparams), jax.random.key(2))
    tres = resources_from_jax(np.asarray(jres[0]), np.asarray(jres[1]), "cpu")
    assert tres[0].shape == (2 * 192, 64)
    return jm, tm, jparams, tparams, jres, tres


def _with_cfg(model, **kw):
    model.cfg = dataclasses.replace(model.cfg, **kw)
    return model


@pytest.mark.parametrize("sel", ["f32", "bf16"])
def test_huge_k_fusion_matches_jax(models, monkeypatch, sel):
    jm, tm, jparams, tparams, jres, tres = models
    # k * emb_size = 6,400: above the limit only when it is made small
    monkeypatch.setattr(j_ragraph_edge, "_BIG_K_ELEMS", 1000)
    monkeypatch.setattr(t_ragraph_edge, "_BIG_K_ELEMS", 1000)
    _with_cfg(jm, selection_dtype=sel)
    _with_cfg(tm, selection_dtype=sel)
    want = jm.generate(jparams, resources=jres)
    got = tm.generate(tparams, resources=tres)
    # f32: the membership sets are equal unless two scores straddle the
    # k-th value within an f32 rounding, so the means agree to sum
    # rounding. bf16: a score that rounds to another bf16 value on one side
    # moves one of ~100 members across the threshold, which changes a mean
    # of values of magnitude <= ~0.3 by at most ~0.6 / 100, times
    # retrieve_weight 0.3.
    atol = 1e-5 if sel == "f32" else 2e-3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=atol)
    plain = tm.generate(tparams, resources=(None, None))
    assert (got[0] - plain[0]).abs().max() > 1e-3   # the fusion did something


@pytest.mark.parametrize("sel", ["f32", "bf16"])
def test_huge_k_fusion_matches_the_index_path(models, monkeypatch, sel):
    """On a library without score ties (the augmented one has all-zero
    rows, which tie at score 0) the threshold path gives the index path's
    means: exactly the same members in f32, and in bf16 a few more, those
    whose scores round to the k-th bf16 value."""
    _, tm, _, tparams, _, _ = models
    _with_cfg(tm, selection_dtype=sel)
    rng = np.random.default_rng(3)
    res = tuple(torch.from_numpy(rng.normal(size=(384, 64))
                                 .astype(np.float32)) for _ in range(2))
    index_path = tm.generate(tparams, resources=res)
    monkeypatch.setattr(t_ragraph_edge, "_BIG_K_ELEMS", 1000)
    got = tm.generate(tparams, resources=res)
    # bf16: normal values, up to ~3 extra members of ~100, weight 0.3
    atol = 1e-5 if sel == "f32" else 3e-2
    for g, w in zip(got, index_path):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=atol)
        assert sel == "f32" or (g - w).abs().max() > 0


def test_huge_k_counts_ties_at_the_threshold(models, monkeypatch):
    """Duplicated library rows tie at the k-th score: every tied row is a
    member and the mean divides by the member count, as in the JAX
    package."""
    jm, tm, jparams, tparams, jres, tres = models
    monkeypatch.setattr(j_ragraph_edge, "_BIG_K_ELEMS", 1000)
    monkeypatch.setattr(t_ragraph_edge, "_BIG_K_ELEMS", 1000)
    _with_cfg(jm, selection_dtype="f32")
    _with_cfg(tm, selection_dtype="f32")
    jdup = tuple(jnp.concatenate([r, r]) for r in jres)
    tdup = tuple(torch.cat([r, r]) for r in tres)
    want = jm.generate(jparams, resources=jdup)
    got = tm.generate(tparams, resources=tdup)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)
