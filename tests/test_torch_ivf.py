"""``ragraph_tpu_torch/rag/ivf.py`` against ``ragraph_tpu/rag/ivf.py``.

JAX draws the initial centroids inside ``kmeans`` with
``jax.random.choice``; the tests draw the same indices from the same key
and hand them to the port. Keys are normalised once, on the JAX side, and
given to both packages (bf16 keys as the bf16 values of those rows).
"""

import _torch_threads  # noqa: F401  (torch's share of the cores)
import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from ragraph_tpu.rag import ivf as j_ivf
from ragraph_tpu.ops.similarity import l2_normalize as j_l2_normalize
from ragraph_tpu_torch.ops.topk import cosine_topk
from ragraph_tpu_torch.rag import ivf as t_ivf

R, E, P = 2048, 32, 16
TOL = 1e-5          # f32 sums of the same exact products in another order
TIE = 1e-6          # rows whose top two centroid scores are this close


def _clustered(r=R, e=E, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(16, e)).astype(np.float32) * 3
    assign = rng.integers(0, 16, size=r)
    return centers[assign] + rng.normal(size=(r, e)).astype(np.float32)


def _keys(dtype):
    """Normalised keys as ``(jax array, torch tensor)`` of ``dtype``."""
    kn = j_l2_normalize(jnp.asarray(_clustered()))
    if dtype == "bf16":
        kn = kn.astype(jnp.bfloat16)
        return kn, torch.from_numpy(np.asarray(kn.astype(jnp.float32))).to(
            torch.bfloat16)
    return kn, torch.from_numpy(np.array(kn))


def _init_idx(key, r, p):
    return np.asarray(jax.random.choice(key, r, shape=(p,), replace=False))


def _top2_gap(keys_t, centroids):
    """Each row's gap between its best and second-best centroid score."""
    s = keys_t.float() @ centroids.to(keys_t.dtype).float().T
    top2 = torch.topk(s, 2, dim=1).values
    return (top2[:, 0] - top2[:, 1]).numpy()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_kmeans_matches_jax(dtype):
    kj, kt = _keys(dtype)
    cj, aj = j_ivf.kmeans(kj, jr.key(0), P, iters=6, chunk=512)
    ct, at = t_ivf.kmeans(kt, _init_idx(jr.key(0), R, P), P, iters=6,
                          chunk=512)
    assert ct.dtype == torch.float32 and at.dtype == torch.int32
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=TOL)
    differ = at.numpy() != np.asarray(aj)
    assert (_top2_gap(kt, ct)[differ] <= TIE).all()
    assert differ.mean() < 0.01


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_bucketize_matches_jax(dtype):
    """The same assignment gives the same buckets, ids, valid flags and
    drops, with a capacity that overflows the larger clusters."""
    kj, kt = _keys(dtype)
    _, aj = j_ivf.kmeans(kj, jr.key(1), P, iters=3)
    cap = 100
    want = j_ivf._bucketize(kj, aj, P, cap)
    got = t_ivf._bucketize(kt, torch.from_numpy(np.asarray(aj)), P, cap)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w.astype(jnp.float32)))
    assert int(got[3]) == int(want[3]) > 0
    assert int(got[2].sum()) + int(got[3]) == R


def _port_index(jidx):
    def t(x):
        x = jnp.asarray(x)
        if x.dtype == jnp.bfloat16:
            return torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(
                torch.bfloat16)
        return torch.from_numpy(np.array(x))
    return t_ivf.IVFIndex(centroids=t(jidx.centroids), keys=t(jidx.keys),
                          row_ids=t(jidx.row_ids), valid=t(jidx.valid),
                          dropped=t(jidx.dropped),
                          num_clusters=jidx.num_clusters,
                          capacity=jidx.capacity)


def _exact(keys_t, queries, ids):
    """f64 cosine of each query against the keys ``ids`` names."""
    q = queries.astype(np.float64)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    k = keys_t.double().numpy()
    return np.einsum("qe,qke->qk", q, k[ids])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ivf_search_matches_jax(dtype):
    """Scores within ``TOL``; ids equal up to ties (the two lists name keys
    of the same scores, position by position)."""
    kj, kt = _keys(dtype)
    jidx = j_ivf.build_ivf(kj, jr.key(2), num_clusters=P, capacity=200,
                           iters=5, normalized=True)
    queries = _clustered(64, seed=7)
    sj, ij = j_ivf.ivf_search(jidx, jnp.asarray(queries), k=10, nprobe=4)
    st, it = t_ivf.ivf_search(_port_index(jidx), torch.from_numpy(queries),
                              k=10, nprobe=4)
    assert st.dtype == torch.float32 and it.dtype == torch.int32
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=TOL)
    ij, it = np.asarray(ij), it.numpy()
    assert (it >= 0).all() and (ij >= 0).all()
    np.testing.assert_allclose(_exact(kt, queries, it),
                               _exact(kt, queries, ij), rtol=0, atol=TOL)
    assert (it == ij).mean() > 0.95


def test_build_ivf_matches_jax_from_its_draw():
    """The port's ``build_ivf`` on JAX's initial indices builds JAX's
    index: the same buckets and ids, centroids within ``TOL``."""
    kj, kt = _keys("f32")
    jidx = j_ivf.build_ivf(kj, jr.key(3), num_clusters=P, capacity=300,
                           iters=4, normalized=True)
    cj, _ = j_ivf.kmeans(kj, jr.key(3), P, iters=4)
    tidx = t_ivf.build_ivf(kt, _init_idx(jr.key(3), R, P), num_clusters=P,
                           capacity=300, iters=4, normalized=True)
    np.testing.assert_allclose(tidx.centroids.numpy(), np.asarray(cj),
                               rtol=0, atol=TOL)
    np.testing.assert_array_equal(tidx.row_ids.numpy(),
                                  np.asarray(jidx.row_ids))
    np.testing.assert_array_equal(tidx.keys.numpy(), np.asarray(jidx.keys))
    assert int(tidx.dropped) == int(jidx.dropped)


# -- the counterparts of tests/test_ivf.py ------------------------------------

@pytest.fixture(scope="module")
def clustered_keys():
    return torch.from_numpy(_clustered(4096))


def test_kmeans_assignment_consistency(clustered_keys):
    from ragraph_tpu_torch.ops.similarity import l2_normalize
    keys_n = l2_normalize(clustered_keys)
    centroids, assignment = t_ivf.kmeans(
        keys_n, torch.Generator().manual_seed(0), 16, iters=15)
    assert centroids.shape == (16, 32)
    scores = (keys_n @ centroids.T).numpy()
    np.testing.assert_array_equal(assignment.numpy(), scores.argmax(1))


def test_bucketing_preserves_rows(clustered_keys):
    idx = t_ivf.build_ivf(clustered_keys, torch.Generator().manual_seed(0),
                          num_clusters=16, capacity=1024, iters=10)
    assert int(idx.valid.sum()) + int(idx.dropped) == clustered_keys.shape[0]
    ids = idx.row_ids[idx.valid].numpy()
    assert len(np.unique(ids)) == len(ids)


def test_search_recall_vs_bruteforce(clustered_keys):
    idx = t_ivf.build_ivf(clustered_keys, torch.Generator().manual_seed(0),
                          num_clusters=16, capacity=1024, iters=10)
    rng = np.random.default_rng(1)
    queries = clustered_keys[:64] + 0.05 * torch.from_numpy(
        rng.normal(size=(64, 32)).astype(np.float32))
    _, ivf_ids = t_ivf.ivf_search(idx, queries, k=10, nprobe=4)
    _, exact_ids = cosine_topk(queries, clustered_keys, 10, method="exact")
    recall = np.mean([len(set(a) & set(b)) / 10 for a, b in
                      zip(ivf_ids.numpy(), exact_ids.numpy())])
    assert recall > 0.9, f"IVF recall {recall} too low"


def test_search_full_probe_is_near_exact(clustered_keys):
    """Probing every cluster recovers brute force (nothing dropped)."""
    idx = t_ivf.build_ivf(clustered_keys, torch.Generator().manual_seed(0),
                          num_clusters=8, capacity=2048, iters=10)
    assert int(idx.dropped) == 0
    rng = np.random.default_rng(2)
    queries = torch.from_numpy(rng.normal(size=(16, 32)).astype(np.float32))
    _, ivf_ids = t_ivf.ivf_search(idx, queries, k=5, nprobe=8)
    _, exact_ids = cosine_topk(queries, clustered_keys, 5, method="exact")
    np.testing.assert_array_equal(np.sort(ivf_ids.numpy(), 1),
                                  np.sort(exact_ids.numpy(), 1))
