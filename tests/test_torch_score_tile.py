"""The score tile's Python side (``ragraph_tpu_torch/ops/score_tile.py``):
the score matrix that kernel C's and the bucket path's ``k > 128``
selection reads, held to the JAX package's bf16 product and to kernel D's
plain version, and the bound on one pass's scratch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragraph_tpu_torch.ops import bucket_topk as tbt
from ragraph_tpu_torch.ops import score_tile as tst

TOL = 1e-6


@pytest.mark.parametrize("e", [12, 264])
def test_score_matrix_plain_matches_jax(e):
    """Scores of L2-normalised bf16 rows within TOL of JAX's f32 product
    of the same rows, -3e38 for a masked key and past R to the bucket's
    end; each bucket's maximum bit for bit kernel D's plain version."""
    rng = np.random.default_rng(e)
    q = rng.standard_normal((7, e)).astype(np.float32)
    keys = rng.standard_normal((300, e)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    keys /= np.linalg.norm(keys, axis=1, keepdims=True)
    valid = rng.random(300) < 0.8
    qt, kt = torch.from_numpy(q), torch.from_numpy(keys)
    got = tst.score_matrix(kt, qt, torch.from_numpy(valid))
    assert got.shape == (7, 384) and got.dtype == torch.float32
    want = np.asarray(jnp.dot(jnp.asarray(q, jnp.bfloat16),
                              jnp.asarray(keys, jnp.bfloat16).T,
                              preferred_element_type=jnp.float32))
    g = got.numpy()
    np.testing.assert_allclose(g[:, :300][:, valid], want[:, valid],
                               rtol=0, atol=TOL)
    assert (g[:, :300][:, ~valid] == tst.NEG_INF).all()
    assert (g[:, 300:] == tst.NEG_INF).all()
    maxima = got.view(7, 3, tst.LANE).amax(2).T
    assert torch.equal(maxima, tbt.bucket_max_plain(kt, qt,
                                                    torch.from_numpy(valid)))


def test_pass_rows_bound_the_scratch():
    """A pass of a large-k path: its scratch takes at most 1/32 of the
    device's memory, and a pass has at least one row and at most n."""
    gb80 = 80 * 10 ** 9
    ld = 262_144
    assert tst.pass_rows(2048, 4 * ld, gb80) == 2048
    assert tst.pass_rows(4096, 4 * ld, gb80) == 2384
    assert tst.pass_rows(10, 4 * 10 ** 9, gb80) == 1
    # the bucket path's candidates at k = 16,384: 8 MiB a query
    assert tst.pass_rows(4096, 4 * 16_384 * 128, gb80) == 298
    for n, row_bytes in ((4096, 4 * ld), (3, 4 * 512), (10 ** 5, 4 * 10 ** 7)):
        c = tst.pass_rows(n, row_bytes, gb80)
        assert 1 <= c <= n
        assert c == 1 or c * row_bytes <= gb80 // tst.SCRATCH_SHARE
    assert tst.device_memory(torch.device("cpu")) > 0
