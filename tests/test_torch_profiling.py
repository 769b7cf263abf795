"""The port's span and counter store (``train/profiling.py``): nothing is
recorded, and no profiler range is opened, without a ``torch.profiler``
run; under one, spans nest, name their ranges ``rg.*``, start each
recording afresh, count, record collections, and sit where the trainer,
the model and the evaluator do their work."""

import gc

import _torch_threads  # noqa: F401  (torch's share of the cores)
import numpy as np
import pytest
import torch

from ragraph_tpu_torch.data.edgelist import load_edge_dataset
from ragraph_tpu_torch.data.synthetic import synthetic_edge_stream
from ragraph_tpu_torch.models.edge import (EdgeGraphArrays, EdgeModelConfig,
                                           RAGraphEdge)
from ragraph_tpu_torch.train import profiling
from ragraph_tpu_torch.train.trainer import EdgeTrainer


def _cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _names(rec) -> list:
    return [s.name for s in rec.spans]


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    with _cpu_profile():
        with profiling.span("kept"):
            pass
    before = profiling.recorded()

    def boom(*a, **k):
        raise AssertionError("called with tracing off")
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(profiling.time, "perf_counter", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    for _ in range(3):
        with profiling.span("off"):
            pass
        profiling.count("off.count")
    gc.collect()
    after = profiling.recorded()
    assert after is before and _names(after) == ["kept"]
    assert after.counts == {}


def test_nested_spans_record_parents_and_rg_ranges():
    with _cpu_profile() as prof:
        with profiling.span("outer"):
            with profiling.span("inner"):
                torch.ones(4).sum()
            with profiling.span("inner"):
                pass
    rec = profiling.recorded()
    assert [(s.name, s.parent) for s in rec.spans] == [
        ("inner", "outer"), ("inner", "outer"), ("outer", None)]
    outer = rec.spans[-1]
    assert outer.host_s >= sum(s.host_s for s in rec.spans[:2]) > 0
    assert all(s.device_s is None for s in rec.spans)   # no CUDA here
    ranges = [e.name for e in prof.events() if e.name.startswith("rg.")]
    assert sorted(ranges) == ["rg.inner", "rg.inner", "rg.outer"]
    assert set(profiling.phase_totals()) == {"inner", "outer"}


def test_second_recording_starts_afresh_and_counts():
    with _cpu_profile():
        with profiling.span("first"):
            profiling.count("items")
            profiling.count("items", 2)
            profiling.count("empty", 0)
    assert profiling.recorded().counts == {"items": 3, "empty": 0}
    with profiling.span("between"):         # tracing off
        pass
    with _cpu_profile():
        profiling.count("items")
        with profiling.span("second"):
            pass
    rec = profiling.recorded()
    assert _names(rec) == ["second"] and rec.counts == {"items": 1}


def test_a_collection_under_a_recording_is_a_gc_span():
    with _cpu_profile() as prof:
        with profiling.span("outer"):
            gc.collect()
    rec = profiling.recorded()
    # the explicit collection; automatic ones may come besides
    gcs = [s for s in rec.spans if s.name == "gc" and s.parent == "outer"]
    assert gcs and all(s.host_s > 0 for s in gcs)
    assert any(e.name == "rg.gc" for e in prof.events())


@pytest.fixture(scope="module")
def tiny():
    train, stages = synthetic_edge_stream(seed=0, num_users=24,
                                          num_items=32,
                                          interactions_per_user=8)
    ds = load_edge_dataset(train, stages[0])
    graph = EdgeGraphArrays.from_dataset(ds, "cpu")
    cfg = EdgeModelConfig(emb_size=8, num_layers=2, batch_size=32,
                          eval_batch_size=8)
    model = RAGraphEdge(cfg, graph, phase="pretrain")
    return ds, model


def test_a_step_and_an_evaluation_record_their_spans(tiny):
    ds, model = tiny
    trainer = EdgeTrainer(model, ds, logger=lambda *_: None)
    params, opt = trainer.prepare(
        model.init_params(torch.Generator().manual_seed(0)))
    users, pos, neg = next(ds.train_batches(32, np.random.default_rng(0)))
    gen = torch.Generator().manual_seed(1)
    with _cpu_profile():
        batch = trainer._to_device(users, pos, neg)
        trainer.step(params, opt, batch, gen)
    rec = profiling.recorded()
    step_parts = {s.name for s in rec.spans if s.parent == "step"}
    assert {"edge_weights", "propagate", "loss", "backward",
            "adam"} <= step_parts
    assert {s.parent for s in rec.spans if s.name == "to_device"} == {None}

    model.generate(params)      # a span with tracing off: a new recording
    with _cpu_profile():
        user_emb, item_emb = model.generate(params)
        trainer.evaluator.evaluate(user_emb, item_emb, ds.test_user_dict,
                                   ds.user_hist_dict)
    rec = profiling.recorded()
    under = {s.name for s in rec.spans if s.parent == "evaluate"}
    assert {"eval.history", "eval.score", "eval.fetch",
            "eval.hits"} <= under
    batches = -(-len(ds.test_user_dict) // 8)
    assert _names(rec).count("eval.history") == batches
    assert {s.parent for s in rec.spans if s.name == "propagate"} == {
        "generate"}
