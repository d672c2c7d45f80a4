"""The share, in %, of a train step's wall in which an operation ran on the
device: the profiled steps' device-busy seconds a step over the window's
unprofiled seconds a step.  The profiled steps' own wall is not used: the
profiler's host cost a step differs from host to host and can leave the
card waiting where the unprofiled step does not."""


def read(rec):
    tr, f = rec.trace, rec.facts
    if tr is None or tr.busy_s <= 0 or not f.get("steps"):
        return None
    return 100.0 * (tr.busy_s / f["traced_steps"]) / (f["window_s"]
                                                      / f["steps"])
