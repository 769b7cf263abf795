"""CSR segment sums of the LightGCN propagation (counterpart of
``ragraph_tpu/ops/pallas_segment.py``).

- :func:`gather_scale_segsum`: ``out[r] = Σ_{e∈[indptr[r], indptr[r+1])}
  w[e]·emb[senders[e]]`` over receiver-sorted CSR. Kernel A on CUDA
  (``csrc/csr_segment.cu`` on the row walk of ``csrc/rg_csr.cuh``, which
  kernel K shares). Its backward is the same kernel on the sender-order
  arrays, as in the JAX custom VJP; the weights get no gradient.
- :func:`walk_plan`: which rows kernels A and K cut into pieces (those of
  more than ``HUB_EDGES`` edges) and where the pieces lie, from ``indptr``
  alone. A wrapper makes it when it is not handed one.
- :func:`sorted_segment_sum_grad`: ``out[r] = Σ msgs[e]`` over CSR segments
  of pre-scaled f32 messages. Kernel B on CUDA. Its backward is
  ``ct[seg_ids]``.
- :func:`segsum_packed2_w`: kernel A's weighted sum with the messages given
  as a half-split packed ``(n/2, 2D)`` matrix (counterpart of
  ``_segsum_packed2_w``). Kernel I on CUDA: A's walk reading each edge's row
  at an address computed from the edge id, with no gather.

Each has a plain PyTorch version (``*_plain``) in this module. A wrapper
runs the plain version only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises.

With ``bf16=True`` the table and the weights are rounded to bf16, and
products and sums are taken in f32, as the TPU kernel does. The CUDA
kernels sum each segment directly in edge order, which is more accurate
than the TPU's prefix difference (``pallas_segment.py:145-148``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ragraph_tpu_torch import native

# Kernels A and K walk a row of at most this many edges with one lane group;
# a longer row is cut into pieces of this many edges (the last one shorter),
# each walked by a group of its own, and its partial sums add in piece order.
HUB_EDGES = 128


class WalkPlan(NamedTuple):
    """The rows that kernels A and K cut into pieces, for one ``indptr``:
    ``long_rows`` (ascending) have more than ``HUB_EDGES`` edges; long row
    ``i``'s pieces are ``pieces[piece_ptr[i]:piece_ptr[i + 1]]``, each a
    ``[begin, end)`` range of ``HUB_EDGES`` edges, the last one shorter."""
    long_rows: torch.Tensor   # (n_long,) int32
    piece_ptr: torch.Tensor   # (n_long + 1,) int32
    pieces: torch.Tensor      # (n_pieces, 2) int32


def walk_plan(indptr: torch.Tensor) -> WalkPlan:
    """The walk plan of ``indptr``, made on its device from ``indptr`` alone.

    Making it reads two counts to the host, so a graph's CSR, fixed across
    a run, is planned once where it is built
    (``models.edge.EdgeGraphArrays``) and the plan handed to each call.
    """
    ip = indptr.long()
    lens = ip[1:] - ip[:-1]
    long_rows = torch.nonzero(lens > HUB_EDGES).flatten()
    counts = (lens[long_rows] + HUB_EDGES - 1) // HUB_EDGES
    piece_ptr = torch.zeros(len(long_rows) + 1, dtype=torch.long,
                            device=ip.device)
    torch.cumsum(counts, 0, out=piece_ptr[1:])
    n_pieces = int(piece_ptr[-1])
    owner = torch.repeat_interleave(
        torch.arange(len(long_rows), device=ip.device), counts,
        output_size=n_pieces)
    row = long_rows[owner]
    begin = ip[row] + HUB_EDGES * (
        torch.arange(n_pieces, device=ip.device) - piece_ptr[owner])
    end = torch.minimum(begin + HUB_EDGES, ip[row + 1])
    return WalkPlan(long_rows.int(), piece_ptr.int(),
                    torch.stack([begin, end], 1).int().contiguous())


def walk_plan_args(plan: WalkPlan, d: int) -> tuple:
    """The plan's arguments of kernels A's and K's C entry points, with the
    ``(n_pieces, d)`` f32 scratch of the pieces' partial sums."""
    partial = torch.empty(len(plan.pieces), d, dtype=torch.float32,
                          device=plan.pieces.device)
    return (HUB_EDGES, plan.long_rows.data_ptr(), plan.piece_ptr.data_ptr(),
            len(plan.long_rows), plan.pieces.data_ptr(), len(plan.pieces),
            partial.data_ptr()), partial


def _segment_ids(indptr: torch.Tensor, n_edges: int) -> torch.Tensor:
    counts = (indptr[1:] - indptr[:-1]).long()
    ids = torch.repeat_interleave(
        torch.arange(len(counts), device=indptr.device), counts)
    if ids.numel() != n_edges:
        raise ValueError(f"indptr covers {ids.numel()} edges, "
                         f"expected {n_edges}")
    return ids


def gather_scale_segsum_plain(table: torch.Tensor, w: torch.Tensor,
                              idx: torch.Tensor, indptr: torch.Tensor,
                              bf16: bool) -> torch.Tensor:
    """Plain version of kernel A (``index_add_`` over segment ids)."""
    t, ww = table.float(), w.float()
    if bf16:
        t = t.to(torch.bfloat16).float()
        ww = ww.to(torch.bfloat16).float()
    msgs = t[idx.long()] * ww[:, None]
    out = torch.zeros(len(indptr) - 1, t.shape[1], dtype=torch.float32,
                      device=t.device)
    return out.index_add_(0, _segment_ids(indptr, len(idx)), msgs)


def segment_sum_plain(msgs: torch.Tensor,
                      indptr: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel B (``index_add_`` over segment ids)."""
    out = torch.zeros(len(indptr) - 1, msgs.shape[1], dtype=torch.float32,
                      device=msgs.device)
    return out.index_add_(0, _segment_ids(indptr, msgs.shape[0]),
                          msgs.float())


def unpack_half_split(msgs2: torch.Tensor, n: int, block: int) -> torch.Tensor:
    """The ``(n, D)`` messages of a half-split packed ``(n/2, 2D)`` matrix:
    packed row ``c·B + i`` holds ``[edge c·2B + i | edge c·2B + B + i]``."""
    d = msgs2.shape[1] // 2
    return (msgs2.reshape(n // (2 * block), block, 2, d).permute(0, 2, 1, 3)
            .reshape(n, d))


def _check_packed2(msgs2: torch.Tensor, w: torch.Tensor, n: int,
                   block: int) -> None:
    if msgs2.dim() != 2 or msgs2.shape[1] % 2:
        raise ValueError(f"segsum_packed2_w: msgs2 must be (n/2, 2D), got "
                         f"shape {tuple(msgs2.shape)}")
    if block <= 0 or n % (2 * block) or msgs2.shape[0] != n // 2:
        raise ValueError(f"segsum_packed2_w: n={n} must be a multiple of "
                         f"2*block={2 * block} and msgs2 must have n/2 rows, "
                         f"got {msgs2.shape[0]}")
    if w.shape != (n,):
        raise ValueError(f"segsum_packed2_w: w must be ({n},), got "
                         f"{tuple(w.shape)}")


def segsum_packed2_w_plain(msgs2: torch.Tensor, w: torch.Tensor,
                           indptr: torch.Tensor, n: int, block: int = 512,
                           bf16: bool = True) -> torch.Tensor:
    """Plain version of kernel I: unpack, round as kernel A does, scale,
    ``index_add_`` over segment ids."""
    _check_packed2(msgs2, w, n, block)
    m, ww = unpack_half_split(msgs2, n, block).float(), w.float()
    if bf16:
        m = m.to(torch.bfloat16).float()
        ww = ww.to(torch.bfloat16).float()
    out = torch.zeros(len(indptr) - 1, m.shape[1], dtype=torch.float32,
                      device=m.device)
    return out.index_add_(0, _segment_ids(indptr, n), m * ww[:, None])


def _check_cuda(name: str, **tensors: tuple) -> None:
    """Check device, dtype and layout of each ``arg=(tensor, dtype, ndim)``."""
    dev = None
    for arg, (t, dtype, ndim) in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, not CUDA")
        dev = dev or t.device
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, not {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} must be {dtype}, got {t.dtype}")
        if t.dim() != ndim or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be a contiguous "
                             f"{ndim}-d tensor, got shape {tuple(t.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")


def _check_width(name: str, d: int) -> None:
    """Kernels A, B and I take any width: an odd one a column a load, a
    wider one than 512 in column slices (csrc/rg_csr.cuh, csr_segment.cu)."""
    if d < 1:
        raise ValueError(f"{name}: row width must be at least 1, got {d}")


def _csr_gather_scale(table: torch.Tensor, w: torch.Tensor,
                      idx: torch.Tensor, indptr: torch.Tensor, bf16: bool,
                      plan: WalkPlan | None = None) -> torch.Tensor:
    """Kernel A on CUDA tensors, its plain version on CPU tensors.

    ``plan`` is ``walk_plan(indptr)``, made here when not given. With
    ``bf16`` the wrapper casts the table to bf16 before the kernel: on the
    card that is faster than rounding the f32 rows inside the kernel
    (PERF.md).
    """
    if table.device.type == "cpu":
        return gather_scale_segsum_plain(table, w, idx, indptr, bf16)
    name = "csr_gather_scale_segsum"
    src = table.to(torch.bfloat16 if bf16 else torch.float32).contiguous()
    n_rows, d = len(indptr) - 1, src.shape[1]
    _check_cuda(name, table=(src, src.dtype, 2), w=(w, torch.float32, 1),
                idx=(idx, torch.int32, 1), indptr=(indptr, torch.int32, 1))
    _check_width(name, d)
    if len(w) != len(idx):
        raise ValueError(f"{name}: {len(w)} weights for {len(idx)} edges")
    plan_args, _partial = walk_plan_args(plan or walk_plan(indptr), d)
    out = torch.empty(n_rows, d, dtype=torch.float32, device=src.device)
    rc = native.lib().rg_csr_gather_scale_segsum(
        src.data_ptr(), w.data_ptr(), idx.data_ptr(), indptr.data_ptr(),
        out.data_ptr(), n_rows, d, int(bf16), *plan_args,
        native.stream_ptr(src))
    native.check(rc, name)
    native.LAUNCHES[name] += 1
    return out


def csr_segment_sum(msgs: torch.Tensor, indptr: torch.Tensor) -> torch.Tensor:
    """Kernel B on CUDA tensors, its plain version on CPU tensors."""
    if msgs.device.type == "cpu":
        return segment_sum_plain(msgs, indptr)
    name = "csr_segment_sum"
    _check_cuda(name, msgs=(msgs, torch.float32, 2),
                indptr=(indptr, torch.int32, 1))
    _check_width(name, msgs.shape[1])
    n_rows, d = len(indptr) - 1, msgs.shape[1]
    out = torch.empty(n_rows, d, dtype=torch.float32, device=msgs.device)
    rc = native.lib().rg_csr_segment_sum(
        msgs.data_ptr(), indptr.data_ptr(), out.data_ptr(), n_rows, d,
        native.stream_ptr(msgs))
    native.check(rc, name)
    native.LAUNCHES[name] += 1
    return out


def segsum_packed2_w(msgs2: torch.Tensor, w: torch.Tensor,
                     indptr: torch.Tensor, n: int, block: int = 512,
                     bf16: bool = True) -> torch.Tensor:
    """``out[r] = Σ_{e∈[indptr[r], indptr[r+1])} w[e]·msg(e)`` with the
    messages in the half-split packed layout (see :func:`unpack_half_split`);
    ``indptr`` must cover the ``n`` edges. With ``bf16`` rows and weights
    are rounded to bf16 and summed in f32. Kernel I on CUDA tensors, its
    plain version on CPU tensors."""
    if msgs2.device.type == "cpu":
        return segsum_packed2_w_plain(msgs2, w, indptr, n, block, bf16)
    name = "csr_segsum_packed2_w"
    _check_packed2(msgs2, w, n, block)
    if n >= 1 << 30:
        raise ValueError(f"{name}: n={n} edges exceed the kernel's 2^30")
    # f32 rows stay f32: under ``bf16`` the kernel rounds them as it reads
    src = msgs2 if bf16 and msgs2.dtype == torch.bfloat16 else msgs2.float()
    n_rows, d = len(indptr) - 1, src.shape[1] // 2
    _check_cuda(name, msgs2=(src, src.dtype, 2), w=(w, torch.float32, 1),
                indptr=(indptr, torch.int32, 1))
    _check_width(name, d)
    out = torch.empty(n_rows, d, dtype=torch.float32, device=src.device)
    rc = native.lib().rg_csr_segsum_packed2_w(
        src.data_ptr(), w.data_ptr(), indptr.data_ptr(), out.data_ptr(),
        n_rows, d, block, int(src.dtype == torch.bfloat16), int(bf16),
        native.stream_ptr(src))
    native.check(rc, name)
    native.LAUNCHES[name] += 1
    return out


class _GatherScaleSegsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, emb, w_recv, w_send, senders, recv_indptr, recv_of_send,
                send_indptr, bf16, recv_plan, send_plan):
        ctx.save_for_backward(w_send, recv_of_send, send_indptr)
        ctx.bf16, ctx.send_plan = bf16, send_plan
        return _csr_gather_scale(emb, w_recv, senders, recv_indptr, bf16,
                                 recv_plan)

    @staticmethod
    def backward(ctx, ct):
        w_send, recv_of_send, send_indptr = ctx.saved_tensors
        d_emb = _csr_gather_scale(ct.contiguous(), w_send, recv_of_send,
                                  send_indptr, ctx.bf16, ctx.send_plan)
        return (d_emb,) + (None,) * 9


def gather_scale_segsum(emb, w_recv, w_send, senders, recv_indptr,
                        recv_of_send, send_indptr, bf16: bool = True,
                        recv_plan: WalkPlan | None = None,
                        send_plan: WalkPlan | None = None):
    """Differentiable fused LightGCN propagation layer (see module doc).
    ``recv_plan`` and ``send_plan`` are the walk plans of ``recv_indptr``
    and ``send_indptr``; a kernel launch without one makes it."""
    return _GatherScaleSegsum.apply(emb, w_recv, w_send, senders,
                                    recv_indptr, recv_of_send, send_indptr,
                                    bf16, recv_plan, send_plan)


class _SortedSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, msgs, indptr, seg_ids):
        ctx.save_for_backward(seg_ids)
        return csr_segment_sum(msgs, indptr)

    @staticmethod
    def backward(ctx, ct):
        (seg_ids,) = ctx.saved_tensors
        return ct[seg_ids.long()].float(), None, None


def sorted_segment_sum_grad(msgs, indptr, seg_ids):
    """Differentiable sorted segment sum; ``seg_ids`` (the sorted receivers)
    serves only the backward, ``d msgs = d out[seg_ids]``."""
    return _SortedSegmentSum.apply(msgs, indptr, seg_ids)
