"""The benchmark's cell of SGL crossed with ROLAND (``taobao.sgl_roland``)
on the CPU at a tiny size: the port agrees with the plain reference under
the cell's limits, the two faults of the mechanism read past them, the GRU's
roofline count worked by hand, and the new per-layer metrics read from the
program's spans (a made-up recording, none, and a tiny traced run)."""

import _torch_threads  # noqa: F401  (torch's share of the cores)
import pytest
import torch

from perfbench import run, spec
from perfbench.conftest import tiny_cell  # noqa: F401  (the fixture)
from perfbench.metrics import gru_counts, spans
from perfbench.trace import TraceView
from ragraph_tpu_torch.train import profiling
from ragraph_tpu_torch.train.profiling import Recording, SpanRecord

CPU = torch.device("cpu")
SEED = 2**31 + 77
CELL = "taobao.sgl_roland"
NEW = ("gru_ms", "views_ms", "infonce_ms", "gru_roofline")


@pytest.fixture(autouse=True)
def _leave_no_recording_open():
    # the profiling store keeps a recording until a span sees tracing off;
    # a later test (in this process) must not find this file's spans in it
    yield
    with profiling.span("off"):
        pass


def _view(units=2, shapes=None):
    return TraceView(window_s=0.01, units=units, device_ops=[], spans={},
                     counters={}, shapes=shapes or {})


def test_gru_count_at_one_shape_by_hand():
    # n = 1,000 rows of width 64: two (1000, 64) x (64, 192) products are
    # 2 * 2 * 1000 * 64 * 192 = 49,152,000 operations; x, h and the output
    # in float32 are 3 * 4 * 64,000 = 768,000 bytes, the two (192, 64)
    # weights and two 192 biases 4 * (24,576 + 384) = 99,840
    assert gru_counts.gru_flops(1000, 64) == 49_152_000
    assert gru_counts.gru_bytes(1000, 64) == 867_840
    # bound by the products: 49,152,000 / 66.9e12 s against 867,840 /
    # 3.35e12 s
    assert gru_counts.gru_bound_s(1000, 64) == pytest.approx(7.3471e-7,
                                                             rel=1e-4)


def _made_up():
    rec = Recording()
    rec.spans = [SpanRecord("roland.gru", "sgl.views", 0.001, 0.004),
                 SpanRecord("roland.gru", None, 0.001, 0.006),
                 SpanRecord("sgl.views", "step", 0.003, 0.010),
                 SpanRecord("infonce", "step", 0.0005, 0.0008)]
    return rec


def test_readers_on_a_made_up_recording(monkeypatch):
    monkeypatch.setattr(spans, "recording", _made_up)
    shapes = {"num_nodes": 1000, "emb_size": 64, "gru_cells": 9}
    read = {m: spec.load_metric(m).read(_view(shapes=shapes)) for m in NEW}
    # device seconds per unit of two: 5 ms of GRU, 5 of views, 0.4 of
    # InfoNCE; nine cells at 7.3471e-4 ms over 5 ms
    assert read == pytest.approx({"gru_ms": 5.0, "views_ms": 5.0,
                                  "infonce_ms": 0.4,
                                  "gru_roofline": 0.13225}, rel=1e-4)


@pytest.mark.parametrize("store", ["empty", "none", "no_shapes"])
def test_a_reader_with_nothing_to_read_returns_nothing(monkeypatch, store):
    if store == "no_shapes":
        # a program that gives no GRU cells (the other programs' shapes)
        monkeypatch.setattr(spans, "recording", _made_up)
        assert spec.load_metric("gru_roofline").read(_view()) is None
        return
    monkeypatch.setattr(spans, "recording", {
        "empty": Recording, "none": lambda: None}[store])
    for m in NEW:
        assert spec.load_metric(m).read(_view()) is None, m


def test_the_port_agrees_with_the_reference(tiny_cell):  # noqa: F811
    out = run.run_cell(tiny_cell(CELL), SEED, 0.3, False, CPU)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"loss_gap", "grad_gap", "update_gap",
                                  "meta_gap", "feed_faults"}


@pytest.mark.parametrize("fault", ["views_alike", "meta_dropped"])
def test_a_fault_of_the_mechanism_reads_past_a_limit(tiny_cell,  # noqa: F811
                                                     fault):
    cell = tiny_cell(CELL)
    with cell["loop"].faults(cell)[fault]():
        out = run.run_cell(cell, SEED, 0.3, False, CPU)
    assert not out["correct"], out["checks"]


def test_a_tiny_traced_cell_prints_the_new_metrics(tiny_cell):  # noqa: F811
    out = run.run_cell(tiny_cell(CELL), SEED, 0.3, True, CPU)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    for m in NEW + ("edge_weights_ms.finetune", "backward_ms.finetune"):
        assert got[m]["value"] > 0, m
