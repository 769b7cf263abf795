"""The selection family (``ragraph_tpu_torch/ops/select_topk.py``): the exact
top-k of each row for any k, which kernels C, E and G route to above their
128-entry lists on the card. On the CPU its wrapper runs the plain version;
here that version is held to the JAX package's row top-k (its Pallas kernel
in interpret mode) and to the extraction plain versions of E and G, which
the card's selections are held to in ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragraph_tpu.ops import bucket_topk as jbt
from ragraph_tpu_torch.ops import bucket_topk as tbt
from ragraph_tpu_torch.ops import select_topk as tsel


def _tied(rng, shape):
    """Values on a coarse grid (many ties), a row of -3e38 (nothing in it)
    and a row exhausted halfway."""
    x = rng.integers(0, 5, size=shape).astype(np.float32)
    x[0] = tsel.NEG_INF
    x[-1, shape[1] // 2:] = tsel.NEG_INF
    return x


@pytest.mark.parametrize("k,shape", [(129, (12, 700)), (300, (5, 301)),
                                     (200, (7, 150))])
def test_select_topk_matches_jax_row_topk(k, shape):
    rng = np.random.default_rng(k)
    x = _tied(rng, shape)
    want = jbt.row_topk(jnp.asarray(x), k, block_q=8, interpret=True)
    got = tsel.select_topk(torch.from_numpy(x), k)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("k", [129, 256, 1000])
def test_select_topk_plain_is_the_extraction_plain(k):
    """The card's E and G take the selection family past k = 128 and are
    held to the extraction plain versions: the two plain versions agree,
    values and indices, ties and exhausted rows included."""
    rng = np.random.default_rng(k)
    x = torch.from_numpy(_tied(rng, (6, 1500)))
    for got, want in zip(tsel.select_topk_plain(x, k),
                         tbt.row_topk_plain(x, k)):
        assert torch.equal(got, want)
    xt = x.T.contiguous()
    for got, want in zip(tsel.select_topk_plain(xt.T, k),
                         tbt.column_topk_plain(xt, k)):
        assert torch.equal(got, want)


def test_select_topk_takes_the_first_n_columns_and_any_k():
    """``n`` columns of wider rows (kernel C's score rows are padded to a
    whole bucket); slots past them and k >= 1 everywhere."""
    x = torch.randn(3, 256)
    v, i = tsel.select_topk(x, 150, n=200)
    assert v.shape == i.shape == (3, 150)
    want = torch.sort(x[:, :200], dim=1, descending=True, stable=True)
    assert torch.equal(v, want.values[:, :150])
    assert torch.equal(i, want.indices[:, :150].int())
    v, i = tsel.select_topk(x, 300, n=200)
    assert (v[:, 200:] == tsel.NEG_INF).all() and (i[:, 200:] == 0).all()
    with pytest.raises(ValueError, match="k >= 1"):
        tsel.select_topk(x, 0)


@pytest.mark.parametrize("n,k,p", [(1, 129, 1), (1000, 129, 256),
                                   (200, 300, 256), (10 ** 6, 16_384, 16_384),
                                   (10 ** 6, 16_385, 32_768)])
def test_sort_width(n, k, p):
    """The sort's entries: the least power of two at or above min(k, n); up
    to 16,384 of them sort in shared memory, more in a global scratch row."""
    assert tsel.sort_width(n, k) == p
    assert (p > tsel.SMEM_SORT) == (min(n, k) > 16_384)
