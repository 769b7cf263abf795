"""Host milliseconds per step in the program's ``step`` span
(``EdgeTrainer.step``): the host's time to issue a step."""

from perfbench.metrics.spans import span_ms


def read(view):
    return span_ms(view, "step")
