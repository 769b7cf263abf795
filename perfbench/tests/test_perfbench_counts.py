"""The operation and byte counts against values worked out by hand, and the
metric readers on a made-up trace."""

import pytest

from perfbench import device, spec
from perfbench.metrics import counts
from perfbench.trace import TraceView, short_name


def test_retrieval_counts_by_hand():
    # 3 queries x 5 rows x width 4: 60 multiply-adds
    assert counts.retrieval_flops(3, 5, 4) == 120.0
    # bf16 queries 3*4*2, keys 5*4*2, top-2 scores and ids 3*2*(4+4)
    assert counts.retrieval_bytes(3, 5, 4, 2) == 24 + 40 + 48


def test_propagation_counts_by_hand():
    # 6 edges of width 4: a multiply and an add each
    assert counts.propagation_a_flops(6, 4) == 48.0
    # 5 nodes, 6 edges, width 4: bf16 table 40, f32 weights 24, ids 24,
    # bounds 6*4, f32 output 80
    assert counts.propagation_a_bytes(5, 6, 4) == 40 + 24 + 24 + 24 + 80
    # f32 messages 6*4*4, bounds 24, output 80
    assert counts.propagation_b_bytes(5, 6, 4) == 96 + 24 + 80


def _view(**kw):
    shapes = dict(num_nodes=8192, num_edges=1 << 20, emb_size=64,
                  num_layers=3, batch_size=2048, library_rows=8192,
                  retrieve_num=10, rag_chunk=4096, test_users=100)
    ops = [("void rgc::topk_partial_kernel<2, 4>(bf16 const*)", 0.0, 0.004),
           ("topk_merge_kernel(float const*)", 0.004, 0.005),
           ("void rgc::walk_kernel<TableRows<bf16>, 8, 1>(int)", 0.006,
            0.007),
           ("Memcpy HtoD (Pageable -> Device)", 0.008, 0.0085)]
    base = dict(window_s=0.010, units=2, device_ops=ops,
                spans={"batch_wait": [0.001, 0.003]},
                counters={"fused_cosine_topk": 4,
                          "csr_gather_scale_segsum": 12},
                shapes=shapes,
                host_ops=[("perfbench.step", 0.0, 0.01),
                          ("aten::copy_", 0.0075, 0.0079)])
    base.update(kw)
    return TraceView(**base)


def test_readers_on_a_made_up_trace():
    v = _view()
    read = {m: spec.load_metric(m).read(v) for m in (
        "retrieval_ms", "retrieval_roofline", "propagation_ms",
        "propagation_roofline", "step_mfu", "batch_wait_ms",
        "idle_share.finetune")}
    assert read["retrieval_ms"] == pytest.approx(2.5)      # 5 ms / 2 steps
    assert read["propagation_ms"] == pytest.approx(0.5)
    # one retrieval a step (4 launches / 2 chunks / 2 steps)
    flops = 2.0 * 8192 * 8192 * 64
    bound = 2 * max(flops / device.PEAK_BF16_FLOPS,
                    counts.retrieval_bytes(8192, 8192, 64, 10)
                    / device.PEAK_HBM_BYTES)
    assert read["retrieval_roofline"] == pytest.approx(100 * bound / 0.005)
    a_bytes = 12 * counts.propagation_a_bytes(8192, 1 << 20, 64)
    assert read["propagation_roofline"] == pytest.approx(
        100 * a_bytes / device.PEAK_HBM_BYTES / 0.001)
    step_flops = flops + 6 * 2.0 * (1 << 20) * 64
    assert read["step_mfu"] == pytest.approx(
        100 * step_flops / (0.005 * device.PEAK_BF16_FLOPS))
    assert read["batch_wait_ms"] == pytest.approx(2.0)
    # busy: 0-5, 6-7, 8-8.5 ms of 10
    assert read["idle_share.finetune"] == pytest.approx(35.0)


def test_a_reader_with_nothing_to_read_returns_nothing():
    v = _view(device_ops=[], counters={}, spans={})
    for m in ("retrieval_ms", "retrieval_roofline", "propagation_ms",
              "propagation_roofline", "batch_wait_ms", "idle_share.eval",
              "generate_ms", "evaluator_ms"):
        assert spec.load_metric(m).read(v) is None, m


def test_breakdown_names_ops_and_gaps():
    v = _view()
    top = dict(v.top_device_ops())
    assert top["topk_partial_kernel"] == pytest.approx(0.004)
    assert short_name("void a::b::walk_kernel<x>(int)") == "walk_kernel"
    gaps = dict(v.idle_gaps())
    assert gaps["step/aten::copy_"] == pytest.approx(0.001)   # 7-8 ms
    assert gaps["step"] == pytest.approx(0.0025)   # 5-6 and 8.5-10 ms
    assert sum(gaps.values()) == pytest.approx(0.0035)
