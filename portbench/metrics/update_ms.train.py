"""Device milliseconds a train step spends in AdamW: the device interval
of ``repro.train.update`` (the step's own update, on its own gradients),
over the traced steps.  Read from the program's spans
(``repro_torch.obs.span_trace``); None without them, without a device
interval, or when the recorder dropped events."""


def read(rec):
    try:
        from repro_torch.obs import span_trace
    except ImportError:                 # a program without spans
        return None
    tr = span_trace()
    if tr is None or tr.dropped:
        return None
    steps = sum(s.label == "repro.train.step" for s in tr.spans)
    upd = [s.dev for s in tr.spans if s.label == "repro.train.update"]
    if not steps or not upd or None in upd:
        return None
    return 1e3 * sum(d1 - d0 for d0, d1 in upd) / steps
