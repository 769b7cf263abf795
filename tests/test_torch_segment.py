"""The port's CSR segment sums against the JAX Pallas kernels (interpret
mode on the CPU), forward and backward.

On the CPU the port's wrappers run their plain PyTorch versions; the CUDA
kernels are held against those versions on the card by ``chip_smoke.py``.
"""

import _torch_threads  # noqa: F401  (torch's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragraph_tpu.ops import pallas_segment as jseg
from ragraph_tpu.ops.segment import scatter_sum as j_scatter_sum
from ragraph_tpu.ops.segment import segment_softmax as j_segment_softmax
from ragraph_tpu_torch.ops import csr_segment as tseg
from ragraph_tpu_torch.ops.segment import scatter_sum, segment_softmax

# f32: the JAX kernel's prefix difference carries rounding error that a
# direct sum does not; bf16: both sides form exact bf16 products and sum in
# f32, in different orders.
F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=0, atol=1e-4)


def _graph(seed, n_nodes, n_edges, d, hub=False):
    """Receiver-sorted random CSR graph with empty segments, its sender-order
    arrays, a table and per-edge weights (both orders)."""
    rng = np.random.default_rng(seed)
    # receivers drawn from half the ids: the other half are empty segments
    recv = np.sort(rng.integers(0, n_nodes // 2, n_edges) * 2)
    if hub:
        recv[: n_edges // 3] = 2
        recv = np.sort(recv)
    send = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    recv = recv.astype(np.int32)
    rip = np.concatenate(
        [[0], np.cumsum(np.bincount(recv, minlength=n_nodes))]).astype(np.int32)
    perm = np.argsort(send, kind="stable").astype(np.int32)
    sip = np.concatenate(
        [[0], np.cumsum(np.bincount(send, minlength=n_nodes))]).astype(np.int32)
    emb = rng.normal(size=(n_nodes, d)).astype(np.float32)
    w = rng.random(n_edges).astype(np.float32)
    return dict(emb=emb, w=w, w_send=w[perm], send=send, recv=recv, rip=rip,
                ros=recv[perm].astype(np.int32), sip=sip)


GRAPHS = [(96, 600, 16, False), (50, 1001, 64, True), (7, 3, 8, False)]
# an odd width, and one past 512 columns (kernels A and B walk it in column
# slices on the card)
WIDE_GRAPHS = [(40, 300, 65, True), (30, 200, 640, False)]


def _jax_layer(g, bf16, emb=None):
    def f(e):
        return jseg.gather_scale_segsum(
            e, jnp.asarray(g["w"]), jnp.asarray(g["w_send"]),
            jnp.asarray(g["send"]), jnp.asarray(g["rip"]),
            jnp.asarray(g["ros"]), jnp.asarray(g["sip"]), block=128,
            bf16=bf16, interpret=True)
    return f


def _torch_args(g):
    t = torch.from_numpy
    return (t(g["w"]), t(g["w_send"]), t(g["send"]), t(g["rip"]),
            t(g["ros"]), t(g["sip"]))


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("n_nodes,n_edges,d,hub", GRAPHS)
def test_gather_scale_segsum_matches_jax(n_nodes, n_edges, d, hub, bf16):
    g = _graph(1, n_nodes, n_edges, d, hub)
    tol = BF16_TOL if bf16 else F32_TOL
    want, vjp = jax.vjp(_jax_layer(g, bf16), jnp.asarray(g["emb"]))
    emb = torch.from_numpy(g["emb"]).requires_grad_(True)
    got = tseg.gather_scale_segsum(emb, *_torch_args(g), bf16=bf16)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)
    empty = np.setdiff1d(np.arange(n_nodes), g["recv"])
    assert np.all(got.detach().numpy()[empty] == 0)

    # backward: the same op in sender order; weights get no gradient
    ct = np.random.default_rng(2).normal(size=want.shape).astype(np.float32)
    (want_grad,) = vjp(jnp.asarray(ct))
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(emb.grad.numpy(), np.asarray(want_grad), **tol)


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("n_nodes,n_edges,d,hub", WIDE_GRAPHS)
def test_gather_scale_segsum_wide_rows_match_jax(n_nodes, n_edges, d, hub,
                                                 bf16):
    """Kernel A's function at an odd width and past 512 columns, forward
    and backward. The f32 backward is held to float64 sums of the same
    terms instead of the JAX kernel: at 640 columns its prefix difference
    strays by up to 1.5e-5 from the direct sum (the f32 note above)."""
    g = _graph(5, n_nodes, n_edges, d, hub)
    tol = BF16_TOL if bf16 else F32_TOL
    want, vjp = jax.vjp(_jax_layer(g, bf16), jnp.asarray(g["emb"]))
    emb = torch.from_numpy(g["emb"]).requires_grad_(True)
    got = tseg.gather_scale_segsum(emb, *_torch_args(g), bf16=bf16)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)
    ct = np.random.default_rng(6).normal(size=want.shape).astype(np.float32)
    got.backward(torch.from_numpy(ct))
    if bf16:
        (want_grad,) = vjp(jnp.asarray(ct))
    else:
        want_grad = np.zeros(g["emb"].shape)
        np.add.at(want_grad, g["send"],
                  ct[g["recv"]].astype(np.float64) * g["w"][:, None])
    np.testing.assert_allclose(emb.grad.numpy(), np.asarray(want_grad), **tol)


@pytest.mark.parametrize("n_nodes,n_edges,d,hub", GRAPHS + WIDE_GRAPHS)
def test_sorted_segment_sum_grad_matches_jax(n_nodes, n_edges, d, hub):
    g = _graph(3, n_nodes, n_edges, d, hub)
    msgs = g["emb"][g["send"]] * g["w"][:, None]

    def f(m):
        return jseg.sorted_segment_sum_grad(m, jnp.asarray(g["rip"]),
                                            jnp.asarray(g["recv"]), 128,
                                            True)

    want, vjp = jax.vjp(f, jnp.asarray(msgs))
    m = torch.from_numpy(msgs).requires_grad_(True)
    got = tseg.sorted_segment_sum_grad(m, torch.from_numpy(g["rip"]),
                                       torch.from_numpy(g["recv"]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **F32_TOL)
    ct = np.random.default_rng(4).normal(size=want.shape).astype(np.float32)
    (want_grad,) = vjp(jnp.asarray(ct))
    got.backward(torch.from_numpy(ct))
    np.testing.assert_array_equal(m.grad.numpy(), np.asarray(want_grad))


def test_plain_versions_agree_with_index_add():
    """The two plain versions compute the CSR sums of the module doc."""
    g = _graph(5, 40, 300, 8)
    t = torch.from_numpy
    got = tseg.gather_scale_segsum_plain(t(g["emb"]), t(g["w"]), t(g["send"]),
                                         t(g["rip"]), bf16=False)
    want = np.zeros((40, 8), np.float64)
    np.add.at(want, g["recv"], g["emb"][g["send"]] * g["w"][:, None])
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    got = tseg.segment_sum_plain(t(g["emb"][g["send"]]), t(g["rip"]))
    want = np.zeros((40, 8), np.float64)
    np.add.at(want, g["recv"], g["emb"][g["send"]])
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_wrappers_refuse_other_devices():
    """Only CPU tensors take the plain version; anything else must be a
    CUDA tensor that the kernel accepts, or the wrapper raises."""
    g = _graph(6, 20, 50, 8)
    args = [torch.from_numpy(g[k]).to("meta")
            for k in ("emb", "w", "w_send", "send", "rip", "ros", "sip")]
    with pytest.raises(ValueError, match="not CUDA"):
        tseg.gather_scale_segsum(*args)
    with pytest.raises(ValueError, match="not CUDA"):
        tseg.csr_segment_sum(args[0], args[4])


def test_segment_primitives_match_jax():
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 12, 90).astype(np.int32)
    logits = rng.normal(size=90).astype(np.float32)
    mask = rng.random(90) < 0.7
    src = rng.normal(size=(90, 5)).astype(np.float32)
    np.testing.assert_allclose(
        scatter_sum(torch.from_numpy(src), torch.from_numpy(ids), 15).numpy(),
        np.asarray(j_scatter_sum(jnp.asarray(src), jnp.asarray(ids), 15)),
        rtol=1e-6, atol=1e-6)
    for m in (None, mask):
        got = segment_softmax(torch.from_numpy(logits), torch.from_numpy(ids),
                              15, None if m is None else torch.from_numpy(m))
        want = j_segment_softmax(jnp.asarray(logits), jnp.asarray(ids), 15,
                                 None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
