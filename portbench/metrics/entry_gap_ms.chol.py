"""Mean device milliseconds a compiled run leaves between its children:
from each child's end event to the next child's start event (the bind,
every program entry, the release), summed over the run, over the traced
factorizations.  Read from the program's spans (``repro.compiled.run``
and its children, ``repro_torch.obs.span_trace``); None without them or
when the recorder dropped events."""


def read(rec):
    try:
        from repro_torch.obs import span_trace
    except ImportError:                 # a program without spans
        return None
    tr = span_trace()
    if tr is None or tr.dropped:
        return None
    runs = [s for s in tr.spans if s.label == "repro.compiled.run"]
    kids = {r.sid: [] for r in runs}
    for s in tr.spans:
        if s.parent in kids:
            kids[s.parent].append(s)
    gaps = 0.0
    for r in runs:
        ch = sorted(kids[r.sid], key=lambda s: s.t0)
        if not ch or any(c.dev is None for c in ch):
            return None
        gaps += sum(max(0.0, b.dev[0] - a.dev[1]) for a, b in zip(ch, ch[1:]))
    return 1e3 * gaps / len(runs) if runs else None
