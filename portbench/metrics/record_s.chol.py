"""Seconds of the set-up's record run: the whole graph once under the
dynamic scheduler (dispatch and stealing), synchronised, on the host's
clock."""


def read(rec):
    return rec.facts.get("record_s")
