"""The per-layer metrics read from the program's own spans and counters
(``ragraph_tpu_torch.train.profiling``): each reader on a made-up
recording and on none, every one printed by a tiny traced cell on the CPU,
and, on the card, no program range counted as device work."""

import gc
import json
import subprocess
import sys

import pytest
import torch

from perfbench import run, spec
from perfbench.metrics import spans
from perfbench.trace import TraceView
from ragraph_tpu_torch.train.profiling import Recording, SpanRecord

SEED = 2**31 + 77
CPU = torch.device("cpu")
TRAIN = ("edge_weights_ms", "backward_ms", "adam_ms", "step_host_ms",
         "to_device_ms", "feed_empty_share")
EVAL = ("history_ms", "topk_wait_ms", "hits_ms", "gc_ms.eval")


def _view(units=2):
    return TraceView(window_s=0.01, units=units, device_ops=[], spans={},
                     counters={}, shapes={})


def _made_up():
    rec = Recording()
    rec.spans = [SpanRecord("edge_weights", "step", 0.001, 0.003),
                 SpanRecord("edge_weights", "step", 0.001, 0.001),
                 SpanRecord("backward", "step", 0.002, 0.006),
                 SpanRecord("adam", "step", 0.0005, 0.0008),
                 SpanRecord("step", None, 0.009, 0.012),
                 SpanRecord("to_device", None, 0.004, 0.004),
                 SpanRecord("eval.history", "evaluate", 0.010),
                 SpanRecord("eval.history", "evaluate", 0.030),
                 SpanRecord("eval.fetch", "evaluate", 0.002),
                 SpanRecord("eval.hits", "evaluate", 0.050),
                 SpanRecord("gc", "eval.hits", 0.006)]
    rec.counts = {"feed.items": 8, "feed.empty": 2}
    return rec


def test_readers_on_a_made_up_recording(monkeypatch):
    monkeypatch.setattr(spans, "recording", _made_up)
    read = {m: spec.load_metric(m).read(_view()) for m in (
        "edge_weights_ms.pretrain", "backward_ms.finetune", "adam_ms.pretrain",
        "step_host_ms.finetune", "to_device_ms.pretrain",
        "feed_empty_share.finetune") + EVAL}
    # per unit of two: device seconds where the span has them, else host
    assert read == pytest.approx({
        "edge_weights_ms.pretrain": 2.0, "backward_ms.finetune": 3.0,
        "adam_ms.pretrain": 0.4, "step_host_ms.finetune": 4.5,
        "to_device_ms.pretrain": 2.0, "feed_empty_share.finetune": 25.0,
        "history_ms": 20.0, "topk_wait_ms": 1.0, "hits_ms": 25.0,
        "gc_ms.eval": 3.0})


@pytest.mark.parametrize("store", ["empty", "none", "no_store"])
def test_a_reader_with_nothing_to_read_returns_nothing(monkeypatch, store):
    if store == "no_store":
        # a program without the store (the parent of this metric's PR)
        from ragraph_tpu_torch.train import profiling
        monkeypatch.delattr(profiling, "recorded")
    else:
        monkeypatch.setattr(spans, "recording", {
            "empty": Recording, "none": lambda: None}[store])
    for m in TRAIN + EVAL:
        assert spec.load_metric(m).read(_view()) is None, m
    monkeypatch.setattr(spans, "recording", _made_up)
    assert spec.load_metric("adam_ms").read(_view(units=0)) is None


@pytest.mark.parametrize("workload,names", [
    ("taobao.pretrain", [f"{m}.pretrain" for m in TRAIN]),
    ("amazon.finetune", [f"{m}.finetune" for m in TRAIN]),
    ("amazon.eval", list(EVAL))])
def test_a_tiny_traced_cell_prints_every_new_metric(tiny_cell, workload,
                                                    names):
    threshold = gc.get_threshold()
    gc.set_threshold(50)        # a tiny window collects too
    try:
        out = run.run_cell(tiny_cell(workload), SEED, 0.3, True, CPU)
    finally:
        gc.set_threshold(*threshold)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    assert all(got[n]["value"] >= 0 for n in names), got
    if workload == "amazon.eval":
        assert got["history_ms"]["value"] > 0
    else:
        ph = workload.split(".")[1]
        assert got[f"step_host_ms.{ph}"]["value"] > 0
        assert got[f"feed_empty_share.{ph}"]["value"] <= 100.0


@pytest.mark.chip
def test_no_program_range_is_device_work(cuda_device):
    res = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload",
         "amazon.finetune", "--seed", str(SEED), "--seconds", "2",
         "--trace", "1"],
        cwd=spec.REPO, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert not [n for n, _ in out["breakdown"]["device_ops"]
                if n.startswith("rg.")]
    for m in TRAIN:
        assert out["metrics"][f"{m}.finetune"]["value"] >= 0
