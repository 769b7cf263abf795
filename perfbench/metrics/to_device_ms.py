"""Host milliseconds per step in the program's ``to_device`` span
(``EdgeTrainer._to_device``): the batch's copy to the card, with any wait
for the work queued before it."""

from perfbench.metrics.spans import span_ms


def read(view):
    return span_ms(view, "to_device")
