"""The share, in %, of the traced factorizations' wall in which an
operation ran on the device."""


def read(rec):
    tr = rec.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * tr.busy_s / tr.window_s
