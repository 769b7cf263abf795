"""The share of the batches the step loop took from the trainer's prefetch
queue that the queue did not yet hold (the program's ``feed.empty`` over
``feed.items`` counters), in %."""

from perfbench.metrics.spans import recording


def read(view):
    rec = recording()
    items = rec.counts.get("feed.items") if rec is not None else None
    if not items:
        return None
    return 100.0 * rec.counts.get("feed.empty", 0) / items
