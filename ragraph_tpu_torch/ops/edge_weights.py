"""The edge-dropout keep masks and the per-edge weights of both edge orders
in one pass (``rg_edge_weights``, ``csrc/edge_weights.cu``).

:func:`hash_edge_mask` is the JAX package's stateless dropout hash
(``ragraph_tpu/models/edge/base.py``). A step's dropout is a short list of
draws ``(salt, keep rate)`` whose masks are ANDed (SGL's views AND two);
:func:`edge_weights` turns the draws and the edge norms, with the static
time fold or without time, into the weights in receiver order and, given
``send_perm``, in sender order: the kernel on CUDA tensors,
:func:`edge_weights_plain` (the hash, the fold and ``torch.where`` as the
models compose them) on CPU tensors. The two agree bit for bit: the kernel
hashes in native uint32 arithmetic and rounds the fold's product and sum
apart, as the PyTorch operations do.
"""

from __future__ import annotations

import torch

from ragraph_tpu_torch import native

# draws a launch ANDs
MAX_DRAWS = 2

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in ``[0, 2**32)``. torch has no
    uint32 multiply, and the int64 product would pass 2**63, so the high
    half of ``x`` is multiplied apart and only its low 16 bits kept."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _M32


def keep_threshold(keep_rate: float) -> int:
    """The uint32 hash below which an edge is kept. Clamped: a keep rate
    in ``(1 - 2**-33, 1)`` would round to 2**32, which as a uint32
    threshold wraps to 0 and drops every edge instead of none."""
    return min(round(keep_rate * 4294967296.0), 4294967295)


def hash_edge_mask(salt, edge_ids: torch.Tensor, keep_rate: float):
    """Keep mask from a stateless integer hash of the edge id: the JAX
    package's uint32 arithmetic (a murmur3-style finalizer) in int64 masked
    to 32 bits, bit for bit the same mask for the same ``salt``.

    A pure elementwise function of ``(salt, edge id)``, so the same mask
    exists in sender order by hashing ``graph.send_perm``, without a
    gather. ``salt`` is an int or a 0-d integer tensor; its low 32 bits
    count.
    """
    if keep_rate >= 1.0:
        return torch.ones(edge_ids.shape, dtype=torch.bool,
                          device=edge_ids.device)
    if isinstance(salt, torch.Tensor):
        salt = salt.to(edge_ids.device, torch.int64)
    x = (_mul32(edge_ids.to(torch.int64) & _M32, 0x9E3779B9)
         + (salt & _M32)) & _M32
    x = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x < keep_threshold(keep_rate)


def keep_mask(draws, edge_ids: torch.Tensor) -> torch.Tensor:
    """The AND of :func:`hash_edge_mask` over ``draws`` (``(salt, keep
    rate)`` pairs); every edge kept for none."""
    mask = None
    for salt, rate in draws:
        m = hash_edge_mask(salt, edge_ids, rate)
        mask = m if mask is None else mask & m
    if mask is None:
        return torch.ones(edge_ids.shape, dtype=torch.bool,
                          device=edge_ids.device)
    return mask


def edge_weights_plain(draws, edge_norm, time_norm=None, c=None,
                       send_perm=None, edge_norm_send=None,
                       time_norm_send=None):
    """Plain version of :func:`edge_weights`: per order the fold
    ``edge_norm * 0.5 + time_norm * c`` (or ``edge_norm`` where ``c`` is
    ``None``), then ``+0.0`` where :func:`keep_mask` drops the edge."""
    def order(ids, en, tn):
        w = en if c is None else en * 0.5 + tn * c
        return torch.where(keep_mask(draws, ids), w, 0.0) if draws else w

    ids = torch.arange(edge_norm.shape[0], device=edge_norm.device)
    w = order(ids, edge_norm, time_norm)
    if send_perm is None:
        return w, None
    return w, order(send_perm, edge_norm_send, time_norm_send)


def edge_weights(draws, edge_norm: torch.Tensor,
                 time_norm: torch.Tensor | None = None, c: float | None = None,
                 send_perm: torch.Tensor | None = None,
                 edge_norm_send: torch.Tensor | None = None,
                 time_norm_send: torch.Tensor | None = None):
    """``(w, w_send)``: the f32 weights of the edges kept by every draw of
    ``draws`` (``(salt, keep rate)``, the salt an int or a 0-d integer
    tensor, never read on the host), ``+0.0`` for a dropped edge. ``c``
    set folds in the static time softmax, ``edge_norm * 0.5 + time_norm *
    c``; ``send_perm`` set (int32) also gives the sender order's weights
    from ``edge_norm_send`` and ``time_norm_send``, else ``w_send`` is
    ``None``. Kernel ``rg_edge_weights`` on CUDA tensors, its plain version
    on CPU tensors."""
    if edge_norm.device.type == "cpu":
        return edge_weights_plain(draws, edge_norm, time_norm, c, send_perm,
                                  edge_norm_send, time_norm_send)
    name = "edge_weights"
    dev = edge_norm.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: edge_norm is on {dev}, not CUDA")
    draws = [(salt, rate) for salt, rate in draws if rate < 1.0]
    if len(draws) > MAX_DRAWS:
        raise ValueError(f"{name}: {len(draws)} draws; the kernel ANDs at "
                         f"most {MAX_DRAWS}")
    n = edge_norm.shape[0]
    floats = [edge_norm] + ([time_norm] if c is not None else [])
    if send_perm is not None:
        floats += [edge_norm_send] + ([time_norm_send] if c is not None
                                      else [])
        if send_perm.dtype != torch.int32:
            raise TypeError(f"{name}: send_perm must be int32, got "
                            f"{send_perm.dtype}")
    for t in floats + ([send_perm] if send_perm is not None else []):
        if t is None or t.device != dev or t.shape != (n,) \
                or not t.is_contiguous():
            raise ValueError(f"{name}: every array must be a contiguous "
                             f"({n},) tensor on {dev}")
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError(f"{name}: the norms must be float32")
    salts = [torch.as_tensor(salt, dtype=torch.int64, device=dev)
             for salt, _ in draws]
    thresh = [keep_threshold(rate) for _, rate in draws]
    salts += [None] * (MAX_DRAWS - len(draws))
    thresh += [0] * (MAX_DRAWS - len(draws))
    out = torch.empty_like(edge_norm)
    out_s = torch.empty_like(edge_norm) if send_perm is not None else None

    def ptr(t):
        return None if t is None else t.data_ptr()
    fold = c is not None
    rc = native.lib().rg_edge_weights(
        edge_norm.data_ptr(), ptr(time_norm if fold else None),
        ptr(edge_norm_send if out_s is not None else None),
        ptr(time_norm_send if fold and out_s is not None else None),
        ptr(send_perm), ptr(salts[0]), ptr(salts[1]), thresh[0], thresh[1],
        len(draws), float(c) if fold else 0.0, out.data_ptr(), ptr(out_s), n,
        native.stream_ptr(edge_norm))
    native.check(rc, name)
    native.LAUNCHES[name] += 1
    return out, out_s
