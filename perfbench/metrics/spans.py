"""What the per-layer metrics read from the program's own spans and
counters (``ragraph_tpu_torch.train.profiling``). The store holds the
latest recording, which in a traced run is the window's. A program
without that store gives nothing to read."""


def recording():
    """The program's latest recording, or ``None`` where it keeps none."""
    from ragraph_tpu_torch.train import profiling
    read = getattr(profiling, "recorded", None)
    return read() if read is not None else None


def span_ms(view, name: str, device: bool = False):
    """Milliseconds per unit of the window in the program's spans named
    ``name``, summed: on the host's clock, or with ``device`` their device
    intervals. A CPU rehearsal has no device interval, and there the
    host's clock stands in, as the trace's host operations do for the
    device's."""
    rec = recording()
    if rec is None or view.units <= 0:
        return None
    spans = [s for s in rec.spans if s.name == name]
    if not spans:
        return None
    sec = sum(s.device_s if device and s.device_s is not None else s.host_s
              for s in spans)
    return 1e3 * sec / view.units
