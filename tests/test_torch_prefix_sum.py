"""The port's prefix-sum functions (kernel H) and the packed-input weighted
segment sum (kernel I) against the JAX package's Pallas kernels in
interpret mode. On the CPU the port runs each kernel's plain version.

Tolerances. A prefix is a sum of up to N terms taken in another order on
each side, so its error follows the size of the prefix, not of the element:
``PREFIX_RTOL * max|prefix|``. The prefix-difference segment sum cancels two
prefixes, so its tolerance is taken from the prefix too. The packed sum adds
a segment's terms directly on the port's side and by a prefix difference on
the JAX side: the same bound.
"""

import _torch_threads  # noqa: F401  (torch's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragraph_tpu import ops as jops
from ragraph_tpu.ops import pallas_segment as jps
from ragraph_tpu_torch import ops as tops
from ragraph_tpu_torch.ops import csr_segment as tcs
from ragraph_tpu_torch.ops import prefix_sum as tps

INTERPRET = jax.default_backend() == "cpu"
PREFIX_RTOL = 2e-6      # a few f32 roundings of the largest prefix


def _tol(prefix):
    return PREFIX_RTOL * max(float(np.abs(prefix).max()), 1.0)


def _indptr(rng, n_edges, n_segs, hub=False):
    ids = np.sort(rng.integers(0, n_segs, n_edges))
    if hub and n_edges:
        ids[: n_edges // 2] = n_segs // 2
        ids = np.sort(ids)
    indptr = np.zeros(n_segs + 1, np.int64)
    np.add.at(indptr[1:], ids, 1)
    return ids.astype(np.int32), np.cumsum(indptr).astype(np.int32)


def test_ops_exports_match_jax():
    for name in ("streaming_cumsum", "sorted_segment_sum",
                 "gather_scale_segsum", "sorted_segment_sum_grad"):
        assert hasattr(jops, name) and hasattr(tops, name), name
    assert tops.sorted_segment_sum_indptr is tps.sorted_segment_sum_indptr
    assert tops.segsum_packed2_w is tcs.segsum_packed2_w


# kernel H's tile and group edges (csrc/prefix_sum.cu's kTileRows = 256
# rows a tile, kGroup = 64 tiles a group)
_T, _GT = 256, 64 * 256


@pytest.mark.parametrize("n,d,block", [(1000, 8, 128), (512, 16, 128),
                                       (1, 4, 128), (777, 3, 256),
                                       (_T - 1, 5, 128), (_T, 3, 128),
                                       (_T + 1, 2, 128), (_GT - 1, 3, 1024),
                                       (_GT, 2, 1024), (_GT + 1, 3, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streaming_cumsum_matches_jax(n, d, block, dtype):
    rng = np.random.default_rng(n + d)
    x = rng.normal(size=(n, d)).astype(np.float32)
    jx = jnp.asarray(x, dtype=dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(jps.streaming_cumsum(jx, block=block,
                                           interpret=INTERPRET))
    got = tps.streaming_cumsum(tx)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    exact = np.cumsum(np.asarray(jx, np.float64), axis=0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_tol(exact))
    np.testing.assert_allclose(got.numpy(), exact, rtol=0, atol=_tol(exact))


@pytest.mark.parametrize("exclusive", [False, True])
def test_prefix_sum_total_and_exclusive(exclusive):
    """The exclusive prefix is the inclusive one a row down, and the total
    is the last inclusive row, as ``_cumsum_call`` returns them."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(300, 5)).astype(np.float32)
    want, want_total = jps._cumsum_call(
        jnp.asarray(x), block=128, interpret=INTERPRET, exclusive=exclusive,
        matmul_bf16=False, with_total=True)
    got, total = tps.prefix_sum(torch.from_numpy(x), exclusive)
    exact = np.cumsum(x.astype(np.float64), axis=0)
    tol = _tol(exact)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:300], rtol=0,
                               atol=tol)
    np.testing.assert_allclose(total.numpy(), np.asarray(want_total),
                               rtol=0, atol=tol)
    np.testing.assert_allclose(total.numpy()[0], exact[-1], rtol=0, atol=tol)
    if exclusive:
        assert (got[0] == 0).all()
    empty, zero = tps.prefix_sum(torch.zeros(0, 5), exclusive)
    assert empty.shape == (0, 5) and (zero == 0).all()
    with pytest.raises(ValueError, match="2-d"):
        tps.prefix_sum(torch.zeros(4), exclusive)


@pytest.mark.parametrize("n_edges,n_segs,d,hub", [
    (512, 64, 16, False), (1000, 300, 16, False), (1000, 40, 8, True),
    (5, 9, 2, False), (1, 1, 4, False), (_T - 1, 40, 4, False),
    (_T + 1, 300, 3, True), (_GT + 1, 500, 2, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sorted_segment_sum_matches_jax(n_edges, n_segs, d, hub, dtype):
    """Ragged N, empty segments, one hub segment, f32 and bf16 messages."""
    rng = np.random.default_rng(n_edges)
    ids, indptr = _indptr(rng, n_edges, n_segs, hub)
    msgs = rng.normal(size=(n_edges, d)).astype(np.float32)
    jm = jnp.asarray(msgs, dtype=dtype)
    tm = torch.from_numpy(msgs).to(getattr(torch, dtype))
    want = np.asarray(jps.sorted_segment_sum(
        jm, jnp.asarray(indptr[:-1]), jnp.asarray(indptr[1:]), block=128,
        interpret=INTERPRET))
    ip = torch.from_numpy(indptr)
    got = tps.sorted_segment_sum(tm, ip[:-1], ip[1:])
    prefix = np.cumsum(np.asarray(jm, np.float64), axis=0)
    tol = 2 * _tol(prefix)          # a difference of two prefixes
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    exact = np.zeros((n_segs, d))
    np.add.at(exact, ids, np.asarray(jm, np.float64))
    np.testing.assert_allclose(got.numpy(), exact, rtol=0, atol=tol)
    # empty segments are exactly zero
    empty = np.setdiff1d(np.arange(n_segs), ids)
    assert (got.numpy()[empty] == 0).all()
    np.testing.assert_array_equal(
        tps.sorted_segment_sum_indptr(tm, ip).numpy(), got.numpy())


def _pack(msgs, block):
    n, d = msgs.shape
    m3 = msgs.reshape(n // (2 * block), 2, block, d)
    return np.concatenate([m3[:, 0], m3[:, 1]], axis=2).reshape(n // 2, 2 * d)


@pytest.mark.parametrize("n_edges,n_segs,d,block", [(512, 96, 16, 128),
                                                    (1024, 7, 8, 128),
                                                    (768, 900, 4, 128)])
@pytest.mark.parametrize("bf16", [False, True])
def test_segsum_packed2_w_matches_jax(n_edges, n_segs, d, block, bf16):
    rng = np.random.default_rng(13 + n_segs)
    ids, indptr = _indptr(rng, n_edges, n_segs, hub=n_segs == 7)
    msgs = rng.normal(size=(n_edges, d)).astype(np.float32)
    w = rng.random(n_edges).astype(np.float32)
    msgs2 = _pack(msgs, block)
    want = np.asarray(jps._segsum_packed2_w(
        jnp.asarray(msgs2), jnp.asarray(w), jnp.asarray(indptr), n_edges,
        block=block, matmul_bf16=bf16, interpret=INTERPRET))
    got = tcs.segsum_packed2_w(torch.from_numpy(msgs2), torch.from_numpy(w),
                               torch.from_numpy(indptr), n_edges,
                               block=block, bf16=bf16)
    np.testing.assert_array_equal(
        tcs.unpack_half_split(torch.from_numpy(msgs2), n_edges,
                              block).numpy(), msgs)

    def r(a):       # the rounding both kernels apply under the bf16 switch
        return (torch.from_numpy(a).bfloat16().double().numpy() if bf16
                else a.astype(np.float64))

    terms = r(msgs) * r(w)[:, None]
    tol = 2 * _tol(np.cumsum(terms, axis=0))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    exact = np.zeros((n_segs, d))
    np.add.at(exact, ids, terms)
    # the port adds each segment directly: f32 rounding of the segment
    np.testing.assert_allclose(got.numpy(), exact, rtol=1e-5, atol=1e-5)


def test_segsum_packed2_w_rejects_what_jax_asserts():
    msgs2, w = torch.zeros(128, 8), torch.zeros(256)
    ip = torch.tensor([0, 256], dtype=torch.int32)
    with pytest.raises(AssertionError):
        jps._segsum_packed2_w(jnp.zeros((128, 8)), jnp.zeros(256),
                              jnp.asarray([0, 256]), 256, block=512,
                              interpret=INTERPRET)
    with pytest.raises(ValueError, match="multiple"):
        tcs.segsum_packed2_w(msgs2, w, ip, 256, block=512)
    with pytest.raises(ValueError, match="multiple"):
        tcs.segsum_packed2_w(msgs2[:100], w, ip, 256, block=128)
    assert tcs.segsum_packed2_w(msgs2, w, ip, 256, block=128).shape == (1, 4)


def test_wrappers_raise_off_the_cpu_without_a_card():
    """A wrapper takes its plain version only for a CPU tensor."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    x = torch.zeros(4, 2, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tps.prefix_sum(x)
    with pytest.raises(ValueError, match="CUDA"):
        tcs.segsum_packed2_w(torch.zeros(128, 4, device="meta"),
                             torch.zeros(256, device="meta"),
                             torch.zeros(2, dtype=torch.int32,
                                         device="meta"), 256, block=128)
