"""Mean device milliseconds an engine step leaves between its device
work: from the step's start (its admission) to the first prefill, from
each prefill or sample (or decode) to the next, and from the last to the
step's end, over the traced steps.  Read from the program's spans
(``repro.engine.step`` and its children, ``repro_torch.obs.span_trace``);
None without them or when the recorder dropped events."""

WORK = ("repro.engine.prefill", "repro.engine.sample", "repro.engine.decode")


def read(rec):
    try:
        from repro_torch.obs import span_trace
    except ImportError:                 # a program without spans
        return None
    tr = span_trace()
    if tr is None or tr.dropped:
        return None
    steps = [s for s in tr.spans if s.label == "repro.engine.step"]
    work = {s.sid: [] for s in steps}
    for s in tr.spans:
        if s.parent in work and s.label in WORK:
            work[s.parent].append(s)
    if not steps:
        return None
    gaps = 0.0
    for st in steps:
        if st.dev is None or any(w.dev is None for w in work[st.sid]):
            return None
        end = st.dev[0]
        for w in sorted(work[st.sid], key=lambda s: s.t0):
            gaps += max(0.0, w.dev[0] - end)
            end = w.dev[1]
        gaps += max(0.0, st.dev[1] - end)
    return 1e3 * gaps / len(steps)
