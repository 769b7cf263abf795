"""The port's ``parallel/`` package against the JAX package's, each on a
mesh of the same shape: JAX on the virtual CPU devices of
``tests/conftest.py``, the port on spawned gloo worlds of CPU processes
(``tests/_torch_parallel_workers.py``, which imports no JAX). One fixture
runs a world of two ranks (meshes ``dp=1,idx=2`` and ``dp=2,idx=1``) and
one of four (``dp=2,idx=2`` and a ``(dcn, dp, idx)`` mesh), each through
many cases, at module scope; the tests below check one case each.

Tolerances: f32 sums in another order to 1e-6 (retrieval scores, the dp
step), 1e-5 (the edge step's loss relative, its tables absolute, and the
huge-k mean relative); 1e-4 for the propagation's layers and gradients
(kernel A's plain version sums each segment in another order than the
JAX Pallas kernel); retrieved indices equal up to ties; the k-th
threshold, the sharded library and the gathered rows bit for bit.
"""

import concurrent.futures as cf
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parallel_workers import run_world
from ragraph_tpu import parallel as jpar
from ragraph_tpu.data import load_edge_dataset as j_load_edge_dataset
from ragraph_tpu.data import synthetic_edge_stream as j_synthetic
from ragraph_tpu.models import edge as jedge
from ragraph_tpu.models.edge.base import lightgcn_propagate as j_propagate
from ragraph_tpu.ops.selection import rowwise_kth_largest as j_kth
from ragraph_tpu.ops.similarity import l2_normalize as j_l2
from ragraph_tpu.ops.topk import cosine_topk as j_topk
from ragraph_tpu.parallel.edge_sharded import (
    shard_edges_by_receiver as j_shard_edges)
from ragraph_tpu.rag import library as jlib
from ragraph_tpu_torch.ops.selection import rowwise_kth_largest as t_kth
from ragraph_tpu_torch.ops.similarity import l2_normalize as t_l2
from ragraph_tpu_torch.ops.topk import cosine_topk as t_topk
from ragraph_tpu_torch.parallel import edge_sharded as t_edge_sharded
from ragraph_tpu_torch.rag import library as tlib

MESHES = [(1, 2), (2, 1), (2, 2)]
IDX_MESHES = [(1, 2), (2, 2)]
F32 = 1e-6


def _world(dp, idx):
    return 2 if dp * idx == 2 else 4


def _jmesh(dp, idx):
    return jpar.make_mesh(dp=dp, idx=idx, devices=jax.devices()[:dp * idx])


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


# -- inputs (numpy, seeded) ---------------------------------------------------

def _topk_inputs():
    rng = _rng(0)
    q, keys = _f32(rng, 16, 32), _f32(rng, 512, 32)
    valid = np.arange(512) < 300
    return q, keys, valid


def _dp_inputs():
    rng = _rng(4)
    return _f32(rng, 16, 4), _f32(rng, 64, 16), _f32(rng, 64, 4)


def _entry_batch(rng, n, e, c, a, n_valid):
    return (_f32(rng, n, e), _f32(rng, n, e), _f32(rng, n, c),
            _f32(rng, n, a), np.arange(n) < n_valid)


def _append_inputs():
    rng = _rng(10)
    entries = [_entry_batch(rng, n, 16, 3, 4, v)
               for n, v in [(24, 24), (24, 17), (40, 40)]]
    return dict(capacity=64, e=16, c=3, a=4, entries=entries,
                query=_f32(rng, 8, 16), k=4)


def _kth_inputs():
    """Ties, negatives and a +-inf row in a (12, 256) matrix."""
    rng = _rng(0)
    x = rng.normal(size=(12, 256)).astype(np.float32)
    x[1] = np.round(x[1] * 2) / 2               # many ties
    x[2] = -np.abs(x[2])                        # all negative
    x[3, :40] = np.inf
    x[3, 40:] = -np.inf
    return x


KTH_CASES = [(k, dt) for dt in ("float32", "bfloat16")
             for k in (1, 7, 100, 256, 1000)]   # 1000 clamps to 256


def _huge_inputs():
    rng = _rng(6)
    q, keys, values = _f32(rng, 8, 16), _f32(rng, 256, 16), _f32(rng, 256, 8)
    keys_n = np.array(j_l2(jnp.asarray(keys)))
    valid = np.arange(256) < 200
    return q, keys_n, values, valid


HUGE_CASES = [("f32-k50", 50, False, False), ("f32-valid", 50, True, False),
              ("f32-fewer-than-k", 230, True, False),
              ("bf16-k50", 50, False, True)]


def _prop_inputs():
    """A graph whose second receiver range has 400 fewer edges than the
    first: the padding passes kernel A's 128-edge hub threshold on the
    lighter shard's last row, and node 0 sends them all."""
    rng = _rng(41)
    n, d = 64, 8
    recv = np.sort(np.concatenate([rng.integers(0, 32, 600),
                                   rng.integers(32, 64, 200)]))
    send = rng.integers(1, n, len(recv)).astype(np.int32)
    w = rng.random(len(recv)).astype(np.float32)
    return send, recv.astype(np.int32), w, _f32(rng, n, d), 2


EDGE_BASE = dict(emb_size=16, num_layers=2, batch_size=96,
                 eval_batch_size=64, lora_rank=4, retrieve_num=5,
                 segsum_impl="scatter", propagate_dtype="f32")
EDGE_CASES = {
    "graphpro-pretrain": ("GraphPro", "pretrain", dict(edge_dropout=0.0)),
    "ragraph-finetune-lora-dropout": (
        "RAGraphEdge", "finetune",
        dict(edge_dropout=0.4, use_lora=True, lora_init_scale=1.0)),
}


def _host(tree):
    return {k: tuple(np.asarray(t) for t in v) if isinstance(v, tuple)
            else np.asarray(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def edge_setup():
    """Per case: the JAX model, its params, the batch, the masks and the
    library, for both packages."""
    j_train, j_stages = j_synthetic(seed=0)
    jds = j_load_edge_dataset(j_train, j_stages[0])
    jg = jedge.EdgeGraphArrays.from_dataset(jds)
    out = {}
    for name, (cls, phase, kw) in EDGE_CASES.items():
        cfg = jedge.EdgeModelConfig(**EDGE_BASE, **kw)
        pre = getattr(jedge, cls)(cfg, jg, phase="pretrain")
        tables = pre.init_params(jax.random.key(0))
        tables = (tables["user_embedding"], tables["item_embedding"])
        jm = getattr(jedge, cls)(cfg, jg, phase=phase)
        jparams = jm.init_params(jax.random.key(1), pretrained_tables=tables)
        resources = None
        if jm.use_rag and phase == "finetune":
            ju, ji = pre.generate({"user_embedding": tables[0],
                                   "item_embedding": tables[1]})
            jk, jv = jm.make_resource_graph(ju, ji, jax.random.key(2))
            resources = (np.asarray(jk), np.asarray(jv))
        rng = _rng(3)
        batch = tuple(rng.integers(0, n, cfg.batch_size).astype(np.int32)
                      for n in (jds.num_users, jds.num_items,
                                jds.num_items))
        mask = rng.random(jg.num_edges) < 1.0 - cfg.edge_dropout
        masks = (mask, mask[np.asarray(jg.send_perm)])
        out[name] = dict(jm=jm, jparams=jparams, batch=batch, masks=masks,
                         resources=resources, cls=cls, phase=phase,
                         cfg_kw={**EDGE_BASE, **kw})
    return out


def _edge_step_case(setup, dp, idx, steps=2):
    return ("edge_step", dict(
        dp=dp, idx=idx, cls_name=setup["cls"], phase=setup["phase"],
        cfg_kw=setup["cfg_kw"], tparams=_host(setup["jparams"]),
        batch=setup["batch"], masks=setup["masks"],
        resources=setup["resources"], steps=steps))


def _cases(world, edge_setup, tmp):
    q, keys, valid = _topk_inputs()
    w0, x, y = _dp_inputs()
    meshes = [m for m in MESHES if _world(*m) == world]
    idx_meshes = [m for m in IDX_MESHES if _world(*m) == world]
    cases = []
    for m in meshes:
        dp, idx = m
        cases += [(("mesh", m), "mesh_info", dict(dp=dp, idx=idx)),
                  (("dp", m), "dp_step", dict(dp=dp, idx=idx, w0=w0, x=x,
                                              y=y, lr=0.1)),
                  (("dpw", m), "dp_step", dict(dp=dp, idx=idx, w0=w0, x=x,
                                               y=y, lr=0.1, weighted=True))]
        for name in EDGE_CASES:
            fn, kw = _edge_step_case(edge_setup[name], dp, idx)
            cases.append((("edge", name, m), fn, kw))
    for m in idx_meshes:
        dp, idx = m
        for method in ("auto", "pallas", "bucket"):
            cases.append((("topk", method, m), "topk",
                          dict(dp=dp, idx=idx, q=q, keys=keys, k=10,
                               local_method=method)))
        cases += [
            (("topk_valid", m), "topk", dict(dp=dp, idx=idx, q=q, keys=keys,
                                            k=5, valid=valid)),
            (("topk_int8", m), "topk", dict(dp=dp, idx=idx, q=q, keys=keys,
                                           k=8, score_dtype="int8",
                                           rescore_pad=8)),
            (("gather", m), "gather_rows",
             dict(dp=dp, idx=idx, vals=keys, ids=_rng(2).integers(
                 0, 512, (16, 4)))),
            (("retrieve", m), "retrieve",
             dict(dp=dp, idx=idx, q=q, keys=keys, values=keys * 2.0,
                  labels=keys[:, :3], k=5)),
            (("append", m), "library_append",
             dict(dp=dp, idx=idx, **_append_inputs())),
            (("restore", m), "restore",
             dict(dp=dp, idx=idx, path=str(tmp / f"ck_{dp}_{idx}"),
                  table=np.arange(32.0, dtype=np.float32).reshape(8, 4),
                  gate=np.full((4,), 0.5)))]
        cases.append((("coll", m), "collectives",
                       dict(dp=dp, idx=idx, x=_f32(_rng(5), 8, 3))))
        for level in ("node", "graph"):
            cases.append((("build", level, m), "library_build",
                          dict(dp=dp, idx=idx, capacity=96, level=level,
                               seed=7)))
        for k, dt in KTH_CASES:
            cases.append((("kth", k, dt, m), "kth",
                          dict(dp=dp, idx=idx, x=_kth_inputs(), k=k,
                               dtype=dt)))
        hq, hk, hv, hvalid = _huge_inputs()
        for name, k, masked, bf16 in HUGE_CASES:
            cases.append((("huge", name, m), "huge_k",
                          dict(dp=dp, idx=idx, q=hq, keys_n=hk, values=hv,
                               k=k, valid=hvalid if masked else None,
                               bf16=bf16)))
    if world == 2:
        send, recv, w, emb, layers = _prop_inputs()
        cases += [
            ("prop", "propagate", dict(dp=1, idx=2, send=send, recv=recv,
                                       w=w, emb=emb, layers=layers)),
            ("resume", "trainer_resume", dict(dp=1, idx=2,
                                              ck_dir=str(tmp / "resume"),
                                              epochs_a=2, epochs_b=4))]
        for name in EDGE_CASES:
            fn, kw = _edge_step_case(edge_setup[name], 0, 1)
            cases.append((("edge_single", name), fn, kw))
    if world == 4:
        cases.append(("multislice", "multislice_info",
                      dict(slices=2, dp=2, idx=1, w0=w0, x=x, y=y, lr=0.1)))
    return cases


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, edge_setup):
    """Both worlds, run at once; ``{case name: [rank results]}``."""
    tmp = tmp_path_factory.mktemp("parallel")
    with cf.ThreadPoolExecutor(2) as ex:
        futs = {w: ex.submit(run_world, w, _cases(w, edge_setup, tmp),
                             str(tmp), 600, f"w{w}") for w in (2, 4)}
        per_rank = {w: f.result() for w, f in futs.items()}
    out = {}
    for ranks in per_rank.values():
        for name in ranks[0]:
            out[name] = [r[name] for r in ranks]
    return out


# -- meshes and the dp step ---------------------------------------------------

@pytest.mark.parametrize("m", MESHES)
def test_mesh_shapes_and_specs(worlds, m):
    jm = _jmesh(*m)
    for r, got in enumerate(worlds[("mesh", m)]):
        assert got["shape"] == dict(jm.shape)
        assert got["spec"] == ("dp",) and jpar.dp_spec(jm) == \
            jax.sharding.PartitionSpec("dp")
        assert got["index"] == {"dp": r // m[1], "idx": r % m[1]}


def test_multislice_mesh_and_step(worlds):
    w0, x, y = _dp_inputs()
    jm = jpar.make_multislice_mesh(num_slices=2, dp=2, idx=1,
                                   devices=jax.devices()[:4])

    def loss_fn(p, batch, key):
        return jnp.mean((batch[0] @ p - batch[1]) ** 2)

    opt = optax.sgd(0.1)
    params = jpar.replicate(jm, jnp.asarray(w0))
    w2, _, loss2 = jpar.make_dp_train_step(jm, loss_fn, opt)(
        params, opt.init(params), jpar.shard_batch(jm, (jnp.asarray(x),
                                                        jnp.asarray(y))),
        None)
    for got in worlds["multislice"]:
        assert got["names"] == tuple(jm.axis_names)
        assert got["shape"] == dict(jm.shape)
        assert got["spec"] == ("dcn", "dp")
        np.testing.assert_allclose(got["loss"], float(loss2), rtol=F32)
        np.testing.assert_allclose(got["w"], np.asarray(w2), atol=F32)


@pytest.mark.parametrize("m", MESHES)
def test_dp_step_matches_single_device(worlds, m):
    """One SGD step, the batch split over dp: the loss and the params equal
    JAX's single-device step and its dp step on the same mesh."""
    w0, x, y = _dp_inputs()

    def loss_fn(p, batch, key):
        return jnp.mean((batch[0] @ p - batch[1]) ** 2)

    loss1, g = jax.value_and_grad(loss_fn)(jnp.asarray(w0), (x, y), None)
    w1 = np.asarray(w0 - 0.1 * g)
    jm = _jmesh(*m)
    opt = optax.sgd(0.1)
    params = jpar.replicate(jm, jnp.asarray(w0))
    w2, _, _ = jpar.make_dp_train_step(jm, loss_fn, opt)(
        params, opt.init(params), jpar.shard_batch(jm, (jnp.asarray(x),
                                                        jnp.asarray(y))),
        None)
    for got in worlds[("dp", m)]:
        np.testing.assert_allclose(got["loss"], float(loss1), rtol=F32)
        np.testing.assert_allclose(got["w"], w1, atol=F32)
        np.testing.assert_allclose(got["w"], np.asarray(w2), atol=F32)


@pytest.mark.parametrize("m", MESHES)
def test_dp_step_weighted_shares(worlds, m):
    """Masked rows weigh the dp shares unequally: the numerators and the
    counts are summed apart, so the step is the global masked mean's."""
    w0, x, y = _dp_inputs()
    mask = ((np.arange(64) % 5 != 0) & (np.arange(64) < 40)).astype(
        np.float32)

    def loss_fn(p):
        per = jnp.mean((x @ p - y) ** 2, axis=1)
        return jnp.sum(per * mask) / jnp.sum(mask)

    loss1, g = jax.value_and_grad(loss_fn)(jnp.asarray(w0))
    for got in worlds[("dpw", m)]:
        np.testing.assert_allclose(got["loss"], float(loss1), rtol=F32)
        np.testing.assert_allclose(got["w"], np.asarray(w0 - 0.1 * g),
                                   atol=F32)


@pytest.mark.parametrize("m", IDX_MESHES)
def test_collectives_and_their_gradients(worlds, m):
    """All-gather, reduce-scatter and all-reduce on the idx axis and their
    backward passes under the port's convention (every rank takes 1/|idx|
    of a replicated loss); integer sums stay integers."""
    x = _f32(_rng(5), 8, 3)
    idx = m[1]
    b = 8 // idx
    total = sum(x * (r + 1) for r in range(idx))
    for r, got in enumerate(worlds[("coll", m)]):
        i = r % idx
        np.testing.assert_array_equal(got["full"], x)
        np.testing.assert_allclose(got["grad_gather"],
                                   2 * x[i * b:(i + 1) * b], rtol=F32)
        np.testing.assert_allclose(got["part"], total[i * b:(i + 1) * b],
                                   rtol=F32)
        # d/dx_r of sum_r' (r'+1) * part_r' = (r'+1) on rows r' gathered
        want = np.concatenate([np.full((b, 3), j + 1.0) for j in
                               range(idx)]).astype(np.float32)
        np.testing.assert_allclose(got["grad_scatter"], want, rtol=F32)
        np.testing.assert_allclose(got["tot"], total, rtol=F32)
        np.testing.assert_allclose(got["grad_reduce"], 2 * total, rtol=F32)
        np.testing.assert_array_equal(got["counts"],
                                      np.full((2, 3), idx * (idx + 1) // 2))
        assert got["counts_dtype"] == "torch.int32"


# -- sharded retrieval ----------------------------------------------------------

def _same_up_to_ties(got_idx, want_idx, scores, atol=F32):
    """Index sets equal, except where the scores tie within ``atol``."""
    for row, (a, b) in enumerate(zip(got_idx, want_idx)):
        if set(a.tolist()) != set(b.tolist()):
            kth = scores[row, -1]
            diff = set(a.tolist()) ^ set(b.tolist())
            assert len(diff) <= 2 and abs(scores[row, -2] - kth) <= atol, \
                (row, a, b)


@pytest.mark.parametrize("m", IDX_MESHES)
@pytest.mark.parametrize("method", ["auto", "pallas", "bucket"])
def test_sharded_topk_matches_single_device(worlds, m, method):
    """Local top-k through the single-device dispatch (C for "pallas", D-G
    for "bucket", exact for "auto" below 32,768 rows), offset and merged:
    the port's single-device answer of the same method, and the JAX
    package's (within bf16 rounding where the kernels score in bf16, as
    ``tests/test_parallel.py`` holds JAX's own)."""
    q, keys, _ = _topk_inputs()
    s_ref, i_ref = (np.asarray(a) for a in j_topk(jnp.asarray(q),
                                                  jnp.asarray(keys), 10))
    s_one, i_one = (a.numpy() for a in t_topk(
        torch.from_numpy(q), torch.from_numpy(keys), 10, method=method))
    for got in worlds[("topk", method, m)]:
        np.testing.assert_allclose(got["scores"], s_one, atol=F32)
        _same_up_to_ties(got["idx"], i_one, s_one)
        np.testing.assert_allclose(got["scores"], s_ref,
                                   atol=F32 if method == "auto" else 2e-2)


@pytest.mark.parametrize("m", IDX_MESHES)
def test_sharded_topk_valid_mask(worlds, m):
    q, keys, valid = _topk_inputs()
    s_ref, i_ref = (np.asarray(a) for a in j_topk(
        jnp.asarray(q), jnp.asarray(keys), 5, valid_mask=jnp.asarray(valid)))
    for got in worlds[("topk_valid", m)]:
        assert (got["idx"] < 300).all()
        np.testing.assert_allclose(got["scores"], s_ref, atol=F32)
        _same_up_to_ties(got["idx"], i_ref, s_ref)


@pytest.mark.parametrize("m", IDX_MESHES)
def test_sharded_topk_int8_rescored(worlds, m):
    """Int8 local scoring with an exact rescore of k+8 candidates: the
    merged scores are the true f32 scores of the rows returned, and the
    rows are JAX's sharded int8 tier's."""
    q, keys, _ = _topk_inputs()
    jm = _jmesh(*m)
    s_j, i_j = jpar.sharded_cosine_topk(jm, jnp.asarray(q),
                                        jpar.shard_rows(jm, jnp.asarray(keys)),
                                        8, score_dtype="int8", rescore_pad=8)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    kn = keys / np.linalg.norm(keys, axis=1, keepdims=True)
    for got in worlds[("topk_int8", m)]:
        true = np.take_along_axis(qn @ kn.T, got["idx"], axis=1)
        np.testing.assert_allclose(got["scores"], true, atol=1e-5)
        np.testing.assert_allclose(got["scores"], np.asarray(s_j), atol=1e-5)
        _same_up_to_ties(got["idx"], np.asarray(i_j), np.asarray(s_j), 1e-5)


@pytest.mark.parametrize("m", IDX_MESHES)
def test_sharded_gather_rows_exact(worlds, m):
    _, keys, _ = _topk_inputs()
    ids = _rng(2).integers(0, 512, (16, 4))
    jm = _jmesh(*m)
    want = np.asarray(jpar.sharded_gather_rows(
        jm, jpar.shard_rows(jm, jnp.asarray(keys)), jnp.asarray(ids)))
    for got in worlds[("gather", m)]:
        np.testing.assert_array_equal(got, keys[ids])
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m", IDX_MESHES)
def test_sharded_retrieve(worlds, m):
    q, keys, _ = _topk_inputs()
    values, labels = keys * 2.0, keys[:, :3]
    jm = _jmesh(*m)
    v, lab = jpar.sharded_retrieve(
        jm, jnp.asarray(q), *(jpar.shard_rows(jm, jnp.asarray(a))
                              for a in (keys, values, labels)), 5)
    for got in worlds[("retrieve", m)]:
        np.testing.assert_allclose(got["values"], np.asarray(v), atol=1e-5)
        np.testing.assert_allclose(got["labels"], np.asarray(lab),
                                   atol=1e-5)


# -- the sharded library ------------------------------------------------------

@pytest.mark.parametrize("m", IDX_MESHES)
def test_sharded_append_matches_jax(worlds, m):
    """Full, partly valid and overflowing appends: the port's sharded store
    equals JAX's sharded store (and its single-device one) bit for bit, and
    ``retrieve`` from it (through the sharded index) equals JAX's
    single-device ``retrieve``."""
    inp = _append_inputs()
    jm = _jmesh(*m)
    cap, e, c, a = inp["capacity"], inp["e"], inp["c"], inp["a"]
    lib_s = jpar.sharded_library_init(jm, cap, e, c, num_anchors=a)
    lib_1 = jlib.library_init(cap, e, c, num_anchors=a)
    for ent in inp["entries"]:
        ent = tuple(jnp.asarray(x) for x in ent)
        lib_s = jpar.sharded_library_append(jm, lib_s, *ent)
        lib_1 = jlib.library_append(lib_1, *ent)
    v1, l1 = jlib.retrieve(lib_1, jnp.asarray(inp["query"]),
                           jlib.LibraryConfig(retrieve_num=inp["k"]))
    for got in worlds[("append", m)]:
        assert got["fill"] == int(lib_s.fill) == int(lib_1.fill) == cap
        for name in ("keys", "values", "labels", "positions"):
            np.testing.assert_array_equal(got[name],
                                          np.asarray(getattr(lib_s, name)))
            np.testing.assert_array_equal(
                got[name], np.asarray(getattr(lib_1, name))[:cap])
        np.testing.assert_allclose(got["ret_values"], np.asarray(v1),
                                   atol=1e-5)
        np.testing.assert_allclose(got["ret_labels"], np.asarray(l1),
                                   atol=1e-5)


@pytest.mark.parametrize("m", IDX_MESHES)
@pytest.mark.parametrize("level", ["node", "graph"])
def test_sharded_build_matches_single_device(worlds, m, level):
    """The sharded build from the same draws equals the single-device build
    bit for bit, rows and fill; the structure-weighted retrieve with row
    noise from the two stores agrees."""
    for got in worlds[("build", level, m)]:
        f1, f2 = got["fill"]
        assert f1 == f2 > 0
        for name in ("keys", "values", "labels", "positions"):
            np.testing.assert_array_equal(got[name][1], got[name][0],
                                          err_msg=name)
        for a, b in zip(got["retrieve_sharded"], got["retrieve_single"]):
            np.testing.assert_allclose(a, b, atol=1e-6)


def test_library_append_refuses_a_sharded_store():
    lib = dataclasses.replace(tlib.library_init(4, 2, 2, 2), mesh=object())
    z = torch.zeros(1, 2)
    with pytest.raises(ValueError, match="sharded_library_append"):
        tlib.library_append(lib, z, z, z, z, torch.ones(1, dtype=torch.bool))


# -- k-th selection and the huge-k fusion --------------------------------------

@pytest.mark.parametrize("m", IDX_MESHES)
@pytest.mark.parametrize("k,dtype", KTH_CASES)
def test_kth_largest_psum_bitwise(worlds, m, k, dtype):
    """Integer counts summed over idx: the threshold equals the JAX
    package's single-device selection (and, at k = 7 on ``dp=1,idx=2``,
    its sharded one) bit for bit, with ties, negatives, +-inf and k
    clamped to the row length."""
    x = jnp.asarray(_kth_inputs()).astype(getattr(jnp, dtype))
    view = jnp.int16 if dtype == "bfloat16" else jnp.int32
    want = np.asarray(jax.lax.bitcast_convert_type(j_kth(x, k), view))
    if k == 7 and m == (1, 2):
        from jax.sharding import NamedSharding, PartitionSpec as P
        jm = _jmesh(*m)
        xs = jax.device_put(x, NamedSharding(jm, P(None, "idx")))
        np.testing.assert_array_equal(np.asarray(
            jax.lax.bitcast_convert_type(
                jpar.sharded_kth_largest(jm, xs, k), view)), want)
    for got in worlds[("kth", k, dtype, m)]:
        np.testing.assert_array_equal(got, want)


def _huge_k_single(q, keys_n, values, k, valid, bf16):
    """The single-device huge-k fusion, with the port's selection."""
    kn = torch.from_numpy(keys_n)
    if bf16:
        kn = kn.to(torch.bfloat16)
    scores = t_l2(torch.from_numpy(q)).to(kn.dtype) @ kn.T
    vm = torch.ones(len(keys_n), dtype=torch.bool) if valid is None \
        else torch.from_numpy(valid)
    scores = torch.where(vm[None, :], scores, -torch.inf)
    member = (scores >= t_kth(scores, k)) & vm[None, :]
    count = member.sum(dim=1, keepdim=True)
    mean = (member.float() @ torch.from_numpy(values)) / count.clamp(min=1)
    return mean.numpy(), count[:, 0].numpy()


@pytest.mark.parametrize("m", IDX_MESHES)
@pytest.mark.parametrize("name,k,masked,bf16", HUGE_CASES)
def test_sharded_huge_k_fuse(worlds, m, name, k, masked, bf16):
    """The sharded fusion's mean and count against the single-device
    fusion: padding rows masked, fewer valid rows than k, and the bf16
    selection tier; on ``dp=1,idx=2`` the masked f32 and the bf16 cases
    also against JAX's sharded fusion."""
    q, keys_n, values, valid = _huge_inputs()
    mean, count = _huge_k_single(q, keys_n, values, k,
                                 valid if masked else None, bf16)
    if m == (1, 2) and name in ("f32-valid", "bf16-k50"):
        jm = _jmesh(*m)
        kn = jnp.asarray(keys_n)
        if bf16:
            kn = kn.astype(jnp.bfloat16)
        kw = ({"valid_mask": jpar.shard_rows(jm, jnp.asarray(valid))}
              if masked else {})
        j_mean, j_count = jpar.sharded_huge_k_fuse(
            jm, jnp.asarray(q), jpar.shard_rows(jm, kn),
            jpar.shard_rows(jm, jnp.asarray(values)), k, **kw)
        np.testing.assert_array_equal(count, np.asarray(j_count))
        np.testing.assert_allclose(mean, np.asarray(j_mean), rtol=1e-5,
                                   atol=1e-6)
    for got in worlds[("huge", name, m)]:
        np.testing.assert_array_equal(got["count"], count)
        np.testing.assert_allclose(got["mean"], mean, rtol=1e-5, atol=1e-6)
        if masked and k > valid.sum():
            assert (got["count"] == valid.sum()).all()


# -- the sharded propagation and the edge step ---------------------------------

def test_shard_edges_by_receiver_matches_jax():
    send, recv, w, emb, _ = _prop_inputs()
    want = j_shard_edges(send, recv, w, emb.shape[0], 2)
    got = t_edge_sharded.shard_edges_by_receiver(send, recv, w,
                                                 emb.shape[0], 2)
    assert (got.num_nodes, got.rows_per_shard, got.edges_per_shard) == (
        want.num_nodes, want.rows_per_shard, want.edges_per_shard)
    for f in ("senders", "recv_indptr", "weights", "recv_of_send",
              "send_indptr", "weights_send", "edge_gid", "edge_gid_send",
              "valid", "valid_send"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


def test_sharded_propagation_with_hub_padding(worlds):
    """The lighter shard pads 400 zero-weight edges onto its last row (and
    node 0 sends them all), past the 128-edge hub threshold: layers and
    the embedding gradient equal JAX's sharded and single-device
    propagation."""
    send, recv, w, emb, layers = _prop_inputs()
    n = emb.shape[0]
    jm = _jmesh(1, 2)
    sh = j_shard_edges(send, recv, w, n, 2)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(recv, minlength=n))])

    def single(x):
        return j_propagate(x, jnp.asarray(send), jnp.asarray(recv),
                           jnp.asarray(w), n, layers,
                           recv_indptr=jnp.asarray(indptr, jnp.int32),
                           impl="sorted", interpret=True)

    def sharded(x):
        return jpar.sharded_lightgcn_propagate(jm, x, sh, layers, bf16=False)

    x = jnp.asarray(emb)
    want = [np.asarray(h) for h in single(x)]
    want_sh = [np.asarray(h) for h in sharded(x)]
    g_want = np.asarray(jax.grad(lambda e: (sum(single(e)) ** 2).sum())(x))
    ranks = worlds["prop"]
    assert ranks[0]["edges_per_shard"] == 600
    # the lighter shard's padding: its last local row and node 0 are hubs
    assert 31 in ranks[1]["recv_long"].tolist()
    assert 0 in ranks[1]["send_long"].tolist()
    for got in ranks:
        for a, b, c in zip(got["layers"], want, want_sh):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(a, c, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got["grad"], g_want, rtol=1e-4,
                                   atol=1e-3)


def _jax_adam_steps(setup, steps):
    if "want" in setup:
        return setup["want"]
    jm, params = setup["jm"], setup["jparams"]
    mask_r, mask_s = setup["masks"]
    jm._drop_masks = lambda key, g, keep: (jnp.asarray(mask_r),
                                           jnp.asarray(mask_s))
    opt = optax.adam(jm.cfg.lr)
    state = opt.init(params)
    batch = tuple(jnp.asarray(b) for b in setup["batch"])
    if setup["resources"] is not None:
        jm.resource_keys, jm.resource_values = (
            jnp.asarray(r) for r in setup["resources"])
    losses = []
    for _ in range(steps):
        (loss, _), g = jax.value_and_grad(
            lambda p: jm.cal_loss(p, batch, jax.random.key(0)),
            has_aux=True)(params)
        upd, state = opt.update(g, state, params)
        params = optax.apply_updates(params, upd)
        losses.append(float(loss))
    flat = {}
    for k, v in _host(params).items():
        if isinstance(v, tuple):
            flat.update({f"{k}.{i}": t for i, t in enumerate(v)})
        else:
            flat[k] = v
    setup["want"] = losses, flat
    return losses, flat


@pytest.mark.parametrize("m", MESHES)
@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_edge_step_matches_single_device(worlds, edge_setup, m, case):
    """Two Adam steps with the tables row-sharded over idx and the batch
    over dp: the loss and every parameter equal JAX's single-device steps
    on the same masks; replicated parameters stay equal on every rank."""
    want_losses, want = _jax_adam_steps(edge_setup[case], 2)
    ranks = worlds[("edge", case, m)]
    for got in ranks:
        np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
        assert set(got["params"]) == set(want)
        for name, t in got["params"].items():
            np.testing.assert_allclose(t, want[name], atol=1e-5,
                                       err_msg=name)
    for name in ranks[0]["local"]:
        for got in ranks[1:]:
            np.testing.assert_array_equal(got["local"][name],
                                          ranks[0]["local"][name])
    # the port's own single-device steps give the same numbers
    single = worlds[("edge_single", case)][0]
    for name, t in ranks[0]["params"].items():
        np.testing.assert_allclose(t, single["params"][name], atol=1e-5)


def test_trainer_resume_on_the_mesh(worlds):
    """A mesh run checkpointed after 2 epochs and resumed to 4 (the tables
    and their Adam moments placed back over idx, rank 0 writing whole
    arrays) equals the same run on one device."""
    ranks = worlds["resume"]
    single = ranks[0]["single"]
    assert single[2] == 4 and len(single[1]) == 2
    for got in ranks:
        params, losses, epochs = got["mesh"]
        assert epochs == 4
        np.testing.assert_allclose(losses, single[1], rtol=1e-5)
        for name in single[0]:
            np.testing.assert_allclose(params[name], single[0][name],
                                       atol=1e-5, err_msg=name)


@pytest.mark.parametrize("m", IDX_MESHES)
def test_restore_sharded(worlds, m):
    """The whole saved table comes back as this rank's block on idx, the
    replicated leaf whole in the template's dtype, a plain leaf as saved."""
    table = np.arange(32.0, dtype=np.float32).reshape(8, 4)
    b = 8 // m[1]
    for r, got in enumerate(worlds[("restore", m)]):
        i = r % m[1]
        np.testing.assert_array_equal(got["user_embedding"],
                                      table[i * b:(i + 1) * b])
        np.testing.assert_array_equal(got["gate"], np.full((4,), 0.5))
        assert got["gate_dtype"] == "torch.float64" and got["step"] == 7
