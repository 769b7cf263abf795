"""Host milliseconds per step that the step loop waits for its next batch
from the trainer's prefetch thread (the benchmark's ``batch_wait`` span)."""


def read(view):
    waits = view.spans.get("batch_wait")
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
