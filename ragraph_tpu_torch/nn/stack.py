"""GCN stacks, the shared encoder (counterpart of ``ragraph_tpu/nn/stack.py``).

A stack of dense GCN convolutions; in LP (pretrain) mode each layer is
followed by a masked batch norm and dropout. ``stop_at`` and
``decode_from`` split the stack for the fewshot encode/decode pair.
"""

from __future__ import annotations

import torch
from torch import nn

from ragraph_tpu_torch.nn.layers import DenseGCN


class MaskedBatchNorm(nn.Module):
    """Batch norm over the node axis of ``x (N, H)`` with a validity mask.

    Masked rows contribute nothing to the batch statistics. The running
    statistics follow ``torch.nn.BatchNorm1d`` (momentum 0.1, eps 1e-5, the
    unbiased variance for the running value); the batch itself is normalized
    with the biased variance. ``mean`` and ``var`` are buffers, updated in
    place in training mode.
    """

    def __init__(self, features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x, node_mask=None, *,
                use_running_average: bool = False):
        if use_running_average:
            mean, var = self.mean, self.var
        else:
            if node_mask is None:
                cnt = torch.tensor(float(x.shape[0]), dtype=x.dtype,
                                   device=x.device)
                mean = x.mean(dim=0)
                var = ((x - mean) ** 2).mean(dim=0)
            else:
                m = node_mask.to(x.dtype)[:, None]
                cnt = torch.clamp_min(m.sum(), 1.0)
                mean = (x * m).sum(dim=0) / cnt
                var = (((x - mean) ** 2) * m).sum(dim=0) / cnt
            with torch.no_grad():
                unbiased = var * cnt / torch.clamp_min(cnt - 1.0, 1.0)
                self.mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                self.var.mul_(1 - self.momentum).add_(
                    self.momentum * unbiased)
        out = (x - mean) * torch.rsqrt(var + self.eps) * self.scale \
            + self.bias
        if node_mask is not None:
            out = out * node_mask.to(out.dtype)[:, None]
        return out


class GCNStack(nn.Module):
    """``num_layers`` dense GCN convolutions; batch norm and dropout after
    each layer in LP mode."""

    def __init__(self, in_features: int, hidden: int, num_layers: int = 1,
                 dropout: float = 0.3, act: str = "prelu",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_layers = num_layers
        self.dropout = dropout
        self.convs = nn.ModuleList(
            DenseGCN(in_features if i == 0 else hidden, hidden, act=act,
                     generator=generator) for i in range(num_layers))
        self.bns = nn.ModuleList(MaskedBatchNorm(hidden)
                                 for _ in range(num_layers))

    def _layers(self, x, adj, node_mask, layers, lp, deterministic,
                drop_masks, generator):
        for i in layers:
            x = self.convs[i](x, adj, node_mask)
            if lp:
                x = self.bns[i](x, node_mask,
                                use_running_average=deterministic)
                if not deterministic and self.dropout > 0:
                    if drop_masks is not None:
                        keep = drop_masks[i]
                    elif generator is not None:
                        keep = torch.rand(x.shape, generator=generator,
                                          device=x.device) >= self.dropout
                    else:
                        raise ValueError(
                            "GCNStack in LP training mode needs drop_masks "
                            "(one keep mask per layer) or a generator")
                    x = x * keep.to(x.dtype) / (1.0 - self.dropout)
        return x

    def forward(self, x, adj, node_mask=None, *, lp: bool = False,
                deterministic: bool = True, stop_at: int | None = None,
                drop_masks=None, generator: torch.Generator | None = None):
        """Run the stack; ``lp=True`` enables batch norm and dropout
        (pretrain mode); the dropout keep masks come from ``drop_masks``
        or are drawn from ``generator``. ``stop_at=k`` returns after the first ``k`` layers."""
        n_layers = self.num_layers if stop_at is None else stop_at
        return self._layers(x, adj, node_mask, range(n_layers), lp,
                            deterministic, drop_masks, generator)

    def decode_from(self, x, adj, node_mask=None, *, start: int = 1,
                    lp: bool = False, deterministic: bool = True,
                    drop_masks=None,
                    generator: torch.Generator | None = None):
        """Apply layers ``start..num_layers``."""
        return self._layers(x, adj, node_mask,
                            range(start, self.num_layers), lp, deterministic,
                            drop_masks, generator)
