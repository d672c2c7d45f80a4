"""Mean milliseconds a compiled run spent copying its tiles into the
captured graphs' storage and back (the compiled driver's ``bind_s``),
over the window's factorizations."""


def read(rec):
    v = rec.counters.get("bind_s")
    return 1e3 * sum(v) / len(v) if v else None
