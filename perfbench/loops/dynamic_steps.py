"""The training loop of the dynamic crosses: the loop of
:mod:`perfbench.loops.train_steps` (its set-up, window and measures, by
import: ``EdgeTrainer.step`` on the dataset's batches through the
trainer's prefetch; the unit is a step, ``step_ms`` the window over the
steps completed in it), compared with a reference that draws all of a
step's salts.

An SGL step draws three salts from the step's generator, in this order:
the edge dropout's, then each of the two views'. The reference replays
each step's generator state and takes the three (``step_salts``).

The numbers compared with the reference (which follows steps 1-3 from the
same tables, GRU, batches and salts):

- ``loss_gap``, ``grad_gap`` (every leaf, the GRU's ``gru.*`` among
  them), ``update_gap`` and ``feed_faults``, as ``train_steps`` reads
  them;
- ``meta_gap``: the largest over the layers of ``||M - M_ref|| /
  ||M_ref||`` of the meta model's layers that set-up made (ROLAND's GRU
  reads them as its hidden state).
"""

from __future__ import annotations

import contextlib
import functools
import statistics

import torch

from perfbench import check
from perfbench.loops import train_steps as base

TEST_ROWS = base.TEST_ROWS
SALTS_PER_STEP = 3        # the dropout's, then the two views'
window = base.window
measures = base.measures


def setup(prog) -> None:
    base.setup(prog)
    prog.record["meta_layers"] = list(prog.model.meta_layers)


def step_salts(states, device, n: int = SALTS_PER_STEP) -> list:
    """The ``n`` salts each step drew: the first ``n`` draws of the step's
    generator state, in order."""
    out = []
    for st in states:
        g = torch.Generator(device)
        g.set_state(st)
        out.append([int(torch.randint(0, 1 << 32, (), generator=g,
                                      device=device)) for _ in range(n)])
    return out


def meta_gap(layers: list, ref_layers: list) -> float:
    return max(float((a.float() - b).norm() / b.norm())
               for a, b in zip(layers[1:], ref_layers[1:]))


def _run_reference(cell, prog, device, dtype: str):
    """The reference over the program's first three steps: ``(model,
    losses, first gradients, changes)``."""
    ref = cell["reference"]
    ref.no_tf32()
    model = ref.build(cell["config"], prog.phase, prog.inputs, prog.tables,
                      device, dtype)
    out = ref.train_steps(model, prog.tables["params"],
                          prog.record["batches"],
                          step_salts(prog.record["gen_states"], device))
    return (model, *out)


def readings(cell: dict, prog, device, dtype: str | None = None) -> dict:
    """The cell's numbers. With ``dtype`` (the control), the reference at
    that precision takes the program's place."""
    model, r_loss, r_grad, r_change = _run_reference(cell, prog, device,
                                                     "bf16")
    rg = {n: float(g.norm()) for n, g in r_grad.items()}
    med = statistics.median(rg.values())
    moved = [n for n in rg if rg[n] >= 1e-3 * med]
    rc = {n: float(r_change[n].norm()) for n in moved}
    if dtype is None:
        p = prog.record
    else:
        c_model, loss, grad, change = _run_reference(cell, prog, device,
                                                     dtype)
        p = {"losses": loss,
             "grad_norms": {n: float(g.norm()) for n, g in grad.items()},
             "change_norms": {n: float(c.norm())
                              for n, c in change.items()},
             "meta_layers": c_model.meta_layers}
    return {
        "loss_gap": max(check.rel(a, b, 1e-30) for a, b in
                        zip(p["losses"], r_loss)),
        "grad_gap": check.leaf_gaps(p["grad_norms"], rg, rg),
        "update_gap": check.leaf_gaps(p["change_norms"], rc, moved),
        "meta_gap": meta_gap(p["meta_layers"], model.meta_layers),
        "feed_faults": base.feed_faults(prog.inputs, prog.record["batches"],
                                        int(cell["config"]["num_items"]),
                                        device),
    }


def control(cell: dict, prog, device) -> dict:
    """The reference one precision below the configuration's (float8 with
    a per-tensor scale where it states bfloat16, bfloat16 where it states
    float32) in the program's place."""
    return readings(cell, prog, device, dtype="fp8")


# -- faults planted under the timed path -------------------------------------

@contextlib.contextmanager
def _patched(owner, name: str, value):
    """``owner.name`` replaced while the block runs, then restored (an
    inherited attribute by deleting the replacement)."""
    own = name in vars(owner)
    old = vars(owner).get(name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        if own:
            setattr(owner, name, old)
        else:
            delattr(owner, name)


@contextlib.contextmanager
def views_alike(view_keep: float = 0.9):
    """Both of SGL's views given one mask: the second view's draw is taken
    and the first view's mask (keep rate ``view_keep``) returned in its
    place."""
    from ragraph_tpu_torch.models.edge.plugins import SGLPlugin
    orig = SGLPlugin._drop_masks
    first = []

    def _drop_masks(self, generator, g, keep_rate):
        out = orig(self, generator, g, keep_rate)
        if keep_rate != view_keep:      # the step's dropout: a new step
            first.clear()
            return out
        if not first:
            first.append(out)
        return first[0]
    with _patched(SGLPlugin, "_drop_masks", _drop_masks):
        yield


@contextlib.contextmanager
def meta_dropped():
    """ROLAND's GRU given the layer's own input as its hidden state in
    place of the meta model's layer."""
    from ragraph_tpu_torch.models.edge import dynamic
    from ragraph_tpu_torch.models.edge.plugins import PluginBase
    prop, gru = PluginBase._prop_layer, dynamic.gru_cell
    layer_input = []

    def _prop_layer(self, g, h, *args):
        layer_input[:] = [h]
        return prop(self, g, h, *args)

    def gru_cell(params, x, h):
        return gru(params, x, layer_input[0])
    with _patched(PluginBase, "_prop_layer", _prop_layer), \
            _patched(dynamic, "gru_cell", gru_cell):
        yield


def faults(cell: dict) -> dict:
    """The faults this cell can have, by name."""
    return {"half_batch": base.half_batch,
            "state_unchanged": base.state_unchanged,
            "positive_negatives": base.positive_negatives,
            "views_alike": functools.partial(
                views_alike, float(cell["config"]["view_keep"])),
            "meta_dropped": meta_dropped}
