"""How ``RAGraphEdge._retrieved_mean`` feeds the retrieval layer: kernel
C's route takes all queries in one ``cosine_topk`` call and gives what the
calls of ``rag_chunk`` rows each gave, bit for bit; the paths that build a
``(Q, R)`` score matrix still pass over at most ``rag_chunk`` query rows."""

import pytest
import torch

from ragraph_tpu_torch.data.edgelist import load_edge_dataset
from ragraph_tpu_torch.data.synthetic import synthetic_edge_stream
from ragraph_tpu_torch.models import edge as tedge
from ragraph_tpu_torch.models.edge import ragraph_edge
from ragraph_tpu_torch.ops import topk as ttopk
from ragraph_tpu_torch.ops.similarity import l2_normalize

Q, R, E, CHUNK = 70, 300, 32, 16     # 70 queries: chunks of 16, 16, ..., 6


@pytest.fixture(scope="module")
def graph():
    train, stages = synthetic_edge_stream(seed=0)
    return tedge.EdgeGraphArrays.from_dataset(
        load_edge_dataset(train, stages[0]), "cpu")


def _inputs(seed):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(Q, E, generator=gen),
            torch.randn(R, E, generator=gen),
            torch.randn(R, E, generator=gen))


@pytest.mark.parametrize("route", ["one_pass", "by_chunk"])
@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("k", [10, 20])
def test_retrieved_mean_equals_the_per_chunk_calls(graph, monkeypatch, k,
                                                   noise, route):
    """``_retrieved_mean`` on the fused route (the threshold lowered below
    the library) against an explicit loop of ``cosine_topk`` calls of
    ``rag_chunk`` rows: the same indices and the same output, bit for bit.
    ``one_pass`` hands all queries to one call of the plain version, as the
    card hands them to kernel C; ``by_chunk`` is the CPU's own route."""
    monkeypatch.setattr(ttopk, "AUTO_APPROX_THRESHOLD", R // 2)
    if route == "one_pass":
        monkeypatch.setattr(ttopk, "runs_kernel_c", lambda q, k: True)
    cfg = tedge.EdgeModelConfig(emb_size=E, retrieve_num=k, rag_chunk=CHUNK,
                                noise_retrieve_num=3)
    model = tedge.RAGraphEdge(cfg, graph, phase="finetune")
    query, keys, values = _inputs(k)
    got_idx = []
    topk = ragraph_edge.cosine_topk

    def spy(*args, **kwargs):
        out = topk(*args, **kwargs)
        got_idx.append(out[1])
        return out
    monkeypatch.setattr(ragraph_edge, "cosine_topk", spy)
    got = model._retrieved_mean(query, noise,
                                torch.Generator().manual_seed(5),
                                (keys, values))
    assert len(got_idx) == 1 and got_idx[0].shape[0] == Q

    kk = k + (cfg.noise_retrieve_num if noise else 0)
    keys_n = l2_normalize(keys)
    idx, means = [], []
    for s in range(0, Q, CHUNK):
        _, i = topk(query[s:s + CHUNK], keys_n, kk, keys_normalized=True)
        idx.append(i)
        means.append(ttopk.topk_gather(values, i).mean(dim=1))
    want = torch.cat(means)
    if noise:
        nk = cfg.noise_retrieve_num
        noise_idx = model._noise_indices(torch.Generator().manual_seed(5), Q,
                                         nk, R, want.device)
        noise_sum = ttopk.topk_gather(values, noise_idx).sum(dim=1)
        want = (want * kk + noise_sum) / (kk + nk)
    assert torch.equal(got_idx[0], torch.cat(idx))
    assert torch.equal(got, want)


@pytest.mark.parametrize("path", ["exact", "int8", "plain"])
def test_score_matrix_paths_keep_rag_chunk_rows(graph, monkeypatch, path):
    """The exact sort, int8 scoring and kernel C's plain version build
    their ``(rows, R)`` scores for at most ``rag_chunk`` query rows a pass,
    and together for every query once."""
    if path == "plain":
        monkeypatch.setattr(ttopk, "AUTO_APPROX_THRESHOLD", R // 2)
    cfg = tedge.EdgeModelConfig(
        emb_size=E, rag_chunk=CHUNK,
        retrieve_dtype="int8" if path == "int8" else "input")
    model = tedge.RAGraphEdge(cfg, graph, phase="finetune")
    query, keys, values = _inputs(1)
    rows = []
    name = "sort" if path == "plain" else "topk"
    orig = getattr(torch, name)

    def spy(scores, *args, **kwargs):
        if scores.dim() == 2 and scores.shape[1] == R:
            rows.append(scores.shape[0])
        return orig(scores, *args, **kwargs)
    monkeypatch.setattr(torch, name, spy)
    model._retrieved_mean(query, False, None, (keys, values))
    assert rows and max(rows) <= CHUNK and sum(rows) == Q
