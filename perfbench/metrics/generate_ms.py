"""Milliseconds per evaluation of ``RAGraphEdge.generate`` with retrieval,
a span that ends in a synchronize."""


def read(view):
    t = view.spans.get("generate")
    return 1e3 * sum(t) / len(t) if t else None
