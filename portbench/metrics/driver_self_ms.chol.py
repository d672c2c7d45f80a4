"""Mean host milliseconds of a compiled run that none of its children
covers (the scan for the next runnable entry, grant bookkeeping, Python
between entries), over the traced factorizations.  Read from the
program's spans (``repro.compiled.run`` less its bind, entries and
release, ``repro_torch.obs.span_trace``); None without them or when the
recorder dropped events."""


def read(rec):
    try:
        from repro_torch.obs import span_trace
    except ImportError:                 # a program without spans
        return None
    tr = span_trace()
    if tr is None or tr.dropped:
        return None
    own = {s.sid: s.t1 - s.t0 for s in tr.spans
           if s.label == "repro.compiled.run"}
    if not own:
        return None
    for s in tr.spans:
        if s.parent in own:
            own[s.parent] -= s.t1 - s.t0
    return 1e3 * sum(own.values()) / len(own)
