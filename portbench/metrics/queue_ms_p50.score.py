"""The median, in ms, over the window's requests of the wait from a
request's submit to the start of its prefill (``serving/metrics.py``'s
``queue_wait_s``, taken on the benchmark's side)."""


def read(rec):
    return rec.facts.get("queue_ms_p50")
