"""The training-side functions of the port's edge model against the JAX
package: losses, dropout masks, LoRA and the gate. Inputs come from numpy
seeds and go through both sides; where a function draws, the draw is
replaced by data or checked as a distribution.

Tolerance ``ATOL``: f32 sums of a few thousand terms in another order.
"""

import _torch_threads  # noqa: F401  (torch's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragraph_tpu.models.edge import base as jbase
from ragraph_tpu.nn import gating as jgating
from ragraph_tpu.nn import lora as jlora
from ragraph_tpu_torch.models.edge import base as tbase
from ragraph_tpu_torch.nn import gating as tgating
from ragraph_tpu_torch.nn import lora as tlora

ATOL = 1e-5


def _pair(rng, *shape):
    a = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def test_bpr_and_nce_and_reg_match_jax():
    rng = np.random.default_rng(0)
    (ju, tu), (jp, tp), (jn, tn) = (_pair(rng, 96, 16) for _ in range(3))
    np.testing.assert_allclose(float(tbase.bpr_loss(tu, tp, tn)),
                               float(jbase.bpr_loss(ju, jp, jn)), atol=ATOL)
    (jps, tps), (jns, tns) = _pair(rng, 96), _pair(rng, 96, 7)
    for w in (1.0, 0.25):
        np.testing.assert_allclose(
            float(tbase.nce_loss(tps, tns, w)),
            float(jbase.nce_loss(jps, jns, w)), atol=ATOL)
    (jut, tut), (jit, tit) = _pair(rng, 40, 16), _pair(rng, 50, 16)
    users, pos, neg = (rng.integers(0, 40, 96).astype(np.int32)
                       for _ in range(3))
    got = tbase.reg_loss_emb(tut, tit, *(torch.from_numpy(a)
                                         for a in (users, pos, neg)))
    want = jbase.reg_loss_emb(jut, jit, *(jnp.asarray(a)
                                          for a in (users, pos, neg)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert bool(tbase.check_finite(got)) and bool(jbase.check_finite(want))
    assert not bool(tbase.check_finite(torch.tensor(float("nan"))))


@pytest.mark.parametrize("b_cos", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_cal_infonce_matches_jax(b_cos, masked):
    rng = np.random.default_rng(1)
    (j1, t1), (j2, t2) = _pair(rng, 32, 8), _pair(rng, 32, 8)
    mask = rng.random(32) < 0.7 if masked else None
    want = jbase.cal_infonce(j1, j2, 0.2, b_cos,
                             None if mask is None else jnp.asarray(mask))
    got = tbase.cal_infonce(t1, t2, 0.2, b_cos,
                            None if mask is None else torch.from_numpy(mask))
    # unnormalised views reach exp(|x|²/0.2): compare relatively
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=ATOL)


@pytest.mark.parametrize("size", [4, 16, 40])
def test_unique_padded_matches_jax(size):
    x = np.random.default_rng(2).integers(0, 12, 30).astype(np.int32)
    jv, jm = jbase.unique_padded(jnp.asarray(x), size)
    tv, tm = tbase.unique_padded(torch.from_numpy(x), size)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def _jax_salt(key):
    return int(jax.random.randint(key, (), jnp.iinfo(jnp.int32).min,
                                  jnp.iinfo(jnp.int32).max)
               .astype(jnp.uint32))


@pytest.mark.parametrize("seed", [0, 1, 7, 2023])
@pytest.mark.parametrize("keep", [0.0, 0.3, 0.5, 0.999, 1.0, 1 - 2.0 ** -33])
def test_hash_edge_mask_bit_equal(seed, keep):
    """uint32 wrap-around arithmetic in int64: the same mask bit for bit,
    in edge order and through a permutation, for the salt JAX draws."""
    key = jax.random.key(seed)
    salt = _jax_salt(key)
    rng = np.random.default_rng(seed)
    ids = np.concatenate([np.arange(5000), [2 ** 31 - 1, 2 ** 30 + 12345],
                          rng.integers(0, 2 ** 31 - 1, 3000)]
                         ).astype(np.int32)
    want = np.asarray(jbase.hash_edge_mask(key, jnp.asarray(ids), keep))
    for s in (salt, torch.tensor(salt), salt - (1 << 32)):
        got = tbase.hash_edge_mask(s, torch.from_numpy(ids), keep)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)
    if keep == 0.0:
        assert not want.any()
    if keep >= 1 - 2.0 ** -33:
        assert want.all()           # the threshold clamp: no edge dropped
    if keep == 0.5:
        assert 0.45 < want[:5000].mean() < 0.55


def test_edge_drop_mask_rate_and_generator():
    gen = torch.Generator().manual_seed(0)
    m = tbase.edge_drop_mask(gen, 20000, 0.3)
    assert m.dtype == torch.bool and 0.28 < m.float().mean() < 0.32
    again = tbase.edge_drop_mask(torch.Generator().manual_seed(0), 20000, 0.3)
    assert torch.equal(m, again)
    assert tbase.edge_drop_mask(gen, 10, 1.0).all()
    assert np.asarray(jbase.edge_drop_mask(jax.random.key(0), 10, 1.0)).all()


@pytest.mark.parametrize("scale", [1.0, 0.0, 0.5])
def test_svd_init_and_apply_lora_match_jax(scale):
    """Singular vectors are defined up to sign: hold ``A @ B``, the shapes
    and ``B``'s row space to JAX's, not ``A`` and ``B`` themselves."""
    rng = np.random.default_rng(4)
    a = (rng.normal(size=(40, 6)) @ rng.normal(size=(6, 16))
         + 0.01 * rng.normal(size=(40, 16))).astype(np.float32)
    jf = jlora.svd_init(jnp.asarray(a), 4, scale)
    tf = tlora.svd_init(torch.from_numpy(a), 4, scale)
    assert tf.a.shape == (40, 4) and tf.b.shape == (4, 16)
    np.testing.assert_allclose((tf.a @ tf.b).numpy(),
                               np.asarray(jf.a @ jf.b), atol=1e-4)
    np.testing.assert_allclose((tf.b.T @ tf.b).numpy(),
                               np.asarray(jf.b.T @ jf.b), atol=1e-4)
    jb, tb = _pair(rng, 40, 16)
    np.testing.assert_allclose(
        tlora.apply_lora(tb, tf).numpy(),
        np.asarray(jlora.apply_lora(jb, jf)), atol=1e-4)
    # the same factors on both sides: no sign freedom left
    tf2 = tlora.LoRAFactors(torch.from_numpy(np.array(jf.a)),
                            torch.from_numpy(np.array(jf.b)))
    np.testing.assert_allclose(
        tlora.apply_lora(tb, tf2, 0.5).numpy(),      # no generator: no drop
        np.asarray(jlora.apply_lora(jb, jf, 0.5)), atol=ATOL)


def test_lora_and_gate_dropout_draw_from_the_generator():
    rng = np.random.default_rng(5)
    base = torch.zeros(200, 32)
    f = tlora.LoRAFactors(torch.ones(200, 1), torch.ones(1, 32))
    out = tlora.apply_lora(base, f, 0.25, torch.Generator().manual_seed(0))
    kept = out != 0
    assert 0.72 < kept.float().mean() < 0.78
    torch.testing.assert_close(out[kept], torch.full_like(out[kept], 1 / .75))
    same = tlora.apply_lora(base, f, 0.25, torch.Generator().manual_seed(0))
    assert torch.equal(out, same)

    (jx, tx), (jw, tw), (jb, tb) = (_pair(rng, 50, 8), _pair(rng, 8, 8),
                                    _pair(rng, 1, 8))
    want = np.asarray(jgating.learned_gate(jx, jw, jb, 0.5))   # no key
    np.testing.assert_allclose(tgating.learned_gate(tx, tw, tb, 0.5).numpy(),
                               want, atol=ATOL)
    dropped = tgating.learned_gate(tx, tw, tb, 0.5,
                                   torch.Generator().manual_seed(1)).numpy()
    kept = dropped != 0
    assert 0.35 < kept.mean() < 0.65
    np.testing.assert_allclose(dropped[kept], 2 * want[kept], atol=ATOL)
