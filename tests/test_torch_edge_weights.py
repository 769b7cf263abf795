"""The edge-dropout weights of one step (``ops/edge_weights.py``, kernel
``rg_edge_weights``) on the CPU.

The kernel runs only on a card (``chip_smoke.py`` holds it there to the
composition it replaces, bit for bit). Here a numpy uint32 twin of its
arithmetic (the hash in native uint32, the fold's product and sum rounded
apart, ``+0.0`` for a dropped edge) is held bit for bit to the JAX
package's ``hash_edge_mask`` and PyTorch's fold, and the port's plain
version to the twin. The models' route is checked on a graph that reports
a CUDA device while its tensors stay on the CPU: draws take the one-launch
route there, explicit masks, the dynamic time mode and the CPU take the
masks' route, and both give the same bits. A step's generator draws what it
drew when ``_drop_masks`` returned bool masks.
"""

import dataclasses

import _torch_threads  # noqa: F401  (torch's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragraph_tpu.models.edge import base as jbase
from ragraph_tpu_torch.data.edgelist import load_edge_dataset
from ragraph_tpu_torch.data.synthetic import synthetic_edge_stream
from ragraph_tpu_torch.models import edge as tedge
from ragraph_tpu_torch.models.edge import ragraph_edge
from ragraph_tpu_torch.models.edge.base import EdgeDraws, mask_pair
from ragraph_tpu_torch.ops import edge_weights as ew
from ragraph_tpu_torch.train import profiling

SALTS = (0, 1, 2 ** 32 - 1)
KEEPS = (0.0, 0.5, 0.9, 1 - 2.0 ** -33, 1.0)
# None: no time; else time_scale, whose fold coefficient is 0.5 * it
SCALES = (None, 1.0, 2.0, 1 / (0.5 * 0.9))
SECOND_KEEP = 0.9          # the second draw of two, as SGL's views


def _twin(draws, ids, en, tn, c):
    """The kernel's arithmetic in numpy: uint32 hash, f32 fold."""
    ids = ids.astype(np.uint32)
    keep = np.ones(ids.shape, bool)
    with np.errstate(over="ignore"):
        for salt, rate in draws:
            if rate >= 1.0:
                continue
            x = ids * np.uint32(0x9E3779B9) + np.uint32(salt & 0xFFFFFFFF)
            x = (x ^ (x >> np.uint32(16))) * np.uint32(0x85EBCA6B)
            x = (x ^ (x >> np.uint32(13))) * np.uint32(0xC2B2AE35)
            x = x ^ (x >> np.uint32(16))
            keep &= x < np.uint32(min(round(rate * 2.0 ** 32), 2 ** 32 - 1))
    w = en if c is None else (en * np.float32(0.5)) + (tn * np.float32(c))
    return np.where(keep, w, np.float32(0.0)).astype(np.float32)


def _jax_mask(monkeypatch, salt, ids, rate):
    """JAX's ``hash_edge_mask`` with its drawn salt replaced by ``salt``
    (the int32 whose uint32 cast it is)."""
    signed = salt - 2 ** 32 if salt >= 2 ** 31 else salt
    with monkeypatch.context() as m:
        m.setattr(jax.random, "randint",
                  lambda *a, **k: jnp.asarray(signed, jnp.int32))
        return np.asarray(jbase.hash_edge_mask(jax.random.key(0),
                                               jnp.asarray(ids), rate))


def _inputs(seed=0, n_random=3000):
    """Edge ids up to 2**31 - 1 (as a sender-order permutation would hold
    them, int32) and f32 norms."""
    rng = np.random.default_rng(seed)
    ids = np.concatenate([np.arange(5000), [2 ** 31 - 1, 2 ** 30 + 12345,
                                            2 ** 31 - 2],
                          rng.integers(0, 2 ** 31 - 1, n_random)]
                         ).astype(np.int32)
    en = rng.random(ids.size, dtype=np.float32)
    tn = rng.random(ids.size, dtype=np.float32) * np.float32(1e-3)
    return ids, en, tn


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("n_draws", [1, 2])
@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("keep", KEEPS)
@pytest.mark.parametrize("salt", SALTS)
def test_twin_matches_jax_hash_and_torch_fold(monkeypatch, salt, keep,
                                              scale, n_draws):
    """Bit for bit: the twin against JAX's masks ANDed with PyTorch's fold
    and ``torch.where``, and the port's plain version against the twin in
    both orders (positions in receiver order, the ids in sender order)."""
    ids, en, tn = _inputs(salt % 7)
    draws = [(salt, keep), ((salt * 2654435761 + 12345) % 2 ** 32,
                            SECOND_KEEP)][:n_draws]
    c = None if scale is None else 0.5 * scale

    mask = np.ones(ids.size, bool)
    for s, rate in draws:
        mask &= _jax_mask(monkeypatch, s, ids, rate)
    te, tt = torch.from_numpy(en), torch.from_numpy(tn)
    w = te if c is None else te * 0.5 + tt * c
    want = torch.where(torch.from_numpy(mask), w, 0.0).numpy()
    twin = _twin(draws, ids, en, tn, c)
    np.testing.assert_array_equal(_bits(twin), _bits(want))

    pos = np.arange(ids.size, dtype=np.int32)
    got, got_s = ew.edge_weights_plain(
        draws, te, tt, c, send_perm=torch.from_numpy(ids),
        edge_norm_send=te, time_norm_send=tt)
    np.testing.assert_array_equal(_bits(got_s.numpy()), _bits(twin))
    np.testing.assert_array_equal(_bits(got.numpy()),
                                  _bits(_twin(draws, pos, en, tn, c)))
    if keep == 0.0:
        assert not twin.any()
    if keep >= 1 - 2.0 ** -33 and n_draws == 1:
        assert (twin == (en if c is None else w.numpy())).all()


@pytest.mark.parametrize("seed", [0, 1, 7, 2023])
def test_twin_matches_jax_hash_on_drawn_salts(seed):
    """The twin at the salts JAX itself draws from a key."""
    key = jax.random.key(seed)
    salt = int(jax.random.randint(key, (), jnp.iinfo(jnp.int32).min,
                                  jnp.iinfo(jnp.int32).max)
               .astype(jnp.uint32))
    ids, en, _ = _inputs(seed)
    want = np.asarray(jbase.hash_edge_mask(key, jnp.asarray(ids), 0.5))
    np.testing.assert_array_equal(_twin([(salt, 0.5)], ids, en, None, None),
                                  np.where(want, en, np.float32(0.0)))


def test_wrapper_on_cpu_is_the_plain_version():
    """``edge_weights`` on CPU tensors returns the plain version's bits,
    with no launch, and no sender order without ``send_perm``."""
    ids, en, tn = _inputs(3, n_random=100)
    salt = torch.tensor(2 ** 32 - 5)
    draws = [(salt, 0.5)]
    before = dict(ew.native.LAUNCHES)
    args = (torch.from_numpy(en), torch.from_numpy(tn), 1.0)
    w, none = ew.edge_weights(draws, *args)
    assert none is None and dict(ew.native.LAUNCHES) == before
    want, _ = ew.edge_weights_plain(draws, *args)
    assert torch.equal(w, want)
    np.testing.assert_array_equal(
        _bits(w.numpy()),
        _bits(_twin([(2 ** 32 - 5, 0.5)], np.arange(ids.size), en, tn, 1.0)))


# -- the models' route ------------------------------------------------------

@pytest.fixture(scope="module")
def graph():
    train, stages = synthetic_edge_stream(
        seed=3, num_users=24, num_items=48, num_stages=1,
        interactions_per_user=8)
    ds = load_edge_dataset(train, [(u, i) for (u, i, _) in stages[0]])
    return tedge.EdgeGraphArrays.from_dataset(ds, "cpu")


class _CudaLike(tedge.EdgeGraphArrays):
    """A graph that reports a CUDA device; its tensors stay on the CPU, so
    the one-launch route runs the plain version."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda_like(g):
    return _CudaLike(**{f.name: getattr(g, f.name)
                        for f in dataclasses.fields(g)})


CFG = dict(emb_size=8, num_layers=2, batch_size=16, edge_dropout=0.3,
           segsum_impl="fused", propagate_dtype="f32")


@pytest.fixture()
def launches(monkeypatch):
    """The one-launch route's calls, each run by the plain version."""
    calls = []

    def spy(draws, *args, **kwargs):
        calls.append(len(draws))
        return ew.edge_weights_plain(draws, *args, **kwargs)
    monkeypatch.setattr(ragraph_edge, "edge_weights", spy)
    return calls


def _draws(g, keep=0.7, seed=5):
    return tedge.RAGraphEdge(tedge.EdgeModelConfig(**CFG), g)._drop_masks(
        torch.Generator().manual_seed(seed), g, keep)


@pytest.mark.parametrize("case", [
    "draws", "draws-no-time", "two-draws", "keep-all",
    "masks", "dynamic-time", "max-time-step", "cpu"])
def test_route_by_input(graph, launches, case):
    """Which route ``_edge_weights`` takes, read from its inputs alone, and
    the same bits on either: the one launch for draws on a CUDA graph with
    the static fold or no time (both orders under the fused backend);
    bool masks, the dynamic time mode, a ``max_time_step`` and the CPU
    through today's masks."""
    cls = tedge.LightGCNEdge if case == "draws-no-time" else tedge.GraphPro
    cfg = tedge.EdgeModelConfig(
        **CFG, time_mode="dynamic" if case == "dynamic-time" else "static")
    g = graph if case == "cpu" else _cuda_like(graph)
    m = cls(cfg, g, phase="pretrain")
    draws = _draws(graph, keep=1.0 if case == "keep-all" else 0.7)
    if case == "two-draws":
        draws = draws & _draws(graph, keep=0.9, seed=6)
    edge_mask, edge_mask_send = mask_pair(draws)
    if case == "masks":
        edge_mask, edge_mask_send = draws.masks()
    kw = dict(time_scale=1.0 / 0.7)
    if case == "max-time-step":
        kw["max_time_step"] = 3
    w, w_send, impl = m._edge_weights(g, edge_mask, edge_mask_send, **kw)
    fused = case in ("draws", "draws-no-time", "two-draws", "keep-all")
    assert launches == ([len(draws.draws)] if fused else [])
    if fused:
        assert impl == "fused" and w_send is not None
    ref_m = cls(cfg, graph, phase="pretrain")
    rw, rw_send, _ = ref_m._edge_weights(graph, *draws.masks(), **kw)
    np.testing.assert_array_equal(_bits(w.numpy()), _bits(rw.numpy()))
    if rw_send is None:
        assert w_send is None
    else:
        np.testing.assert_array_equal(_bits(w_send.numpy()),
                                      _bits(rw_send.numpy()))


def test_fused_edges_counter(graph, launches):
    """Counter ``edge_weights.fused_edges`` adds the edges the launch
    weighs, per order; the masks' route adds nothing."""
    g = _cuda_like(graph)
    m = tedge.GraphPro(tedge.EdgeModelConfig(**CFG), g, phase="pretrain")
    draws = _draws(graph)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        m._edge_weights(g, draws, None)
        m._edge_weights(g, *draws.masks())
        sorted_m = tedge.GraphPro(tedge.EdgeModelConfig(
            **{**CFG, "segsum_impl": "sorted"}), g, phase="pretrain")
        _, w_send, impl = sorted_m._edge_weights(g, draws, None)
    assert impl == "sorted" and w_send is None
    assert profiling.recorded().counts["edge_weights.fused_edges"] \
        == 3 * graph.num_edges


def test_draw_record(graph):
    """``_drop_masks`` returns the step's draws; unpacked, the two bool
    masks describe one set of edges; ``&`` ANDs them; ``mask_pair`` passes
    a record whole and a pair as given."""
    draws = _draws(graph)
    assert isinstance(draws, EdgeDraws) and len(draws.draws) == 1
    salt, rate = draws.draws[0]
    assert salt.dtype == torch.int64 and salt.dim() == 0 and rate == 0.7
    m, ms = draws
    assert torch.equal(ms, m[graph.send_perm.long()])
    both = draws & _draws(graph, keep=0.9, seed=6)
    bm, bms = both.masks()
    assert torch.equal(bm, m & _draws(graph, keep=0.9, seed=6).masks()[0])
    assert torch.equal(bms, bm[graph.send_perm.long()])
    assert mask_pair(draws) == (draws, None)
    assert mask_pair((m, ms)) == (m, ms)
    assert _draws(graph, keep=1.0).draws == ()


def _old_drop_masks(self, generator, g, keep_rate):
    """``_drop_masks`` as it was before it returned draws."""
    if g.send_perm is not None:
        salt = 0 if keep_rate >= 1.0 else self._draw_salt(generator)
        ids = torch.arange(g.num_edges, device=g.device)
        return (ew.hash_edge_mask(salt, ids, keep_rate),
                ew.hash_edge_mask(salt, g.send_perm, keep_rate))
    return tedge.base.edge_drop_mask(generator, g.num_edges, keep_rate,
                                     g.device), None


@pytest.mark.parametrize("name", ["RAGraphEdge", "LightGCNEdge", "SGLPlugin",
                                  "SimGCLPlugin", "MixGCFPlugin",
                                  "EvolveGCNO"])
def test_step_draws_as_before(graph, monkeypatch, name):
    """A step's loss and the generator's state after it are those of the
    masks' ``_drop_masks``: the same draws, in the same order."""
    cfg = tedge.EdgeModelConfig(**CFG)
    batch = (torch.arange(8), torch.arange(8), torch.arange(8, 16))
    m = getattr(tedge, name)(cfg, graph, phase="pretrain")
    params = m.init_params(torch.Generator().manual_seed(0))
    if getattr(m, "multi_negs", False):
        batch = batch[:2] + (torch.arange(8 * cfg.n_negs).reshape(8, -1)
                             % graph.num_items,)

    def step():
        gen = torch.Generator().manual_seed(11)
        loss, _ = m.cal_loss(params, batch, gen)
        return loss, gen.get_state()
    new_loss, new_state = step()
    with monkeypatch.context() as mp:
        mp.setattr(ragraph_edge.TemporalLightGCN, "_drop_masks",
                   _old_drop_masks)
        old_loss, old_state = step()
    assert torch.equal(new_state, old_state)
    assert torch.equal(new_loss, old_loss)
