"""Mean share, in %, of a compiled run's host wall spent outside the
fused segments and task bodies (the compiled driver's
``dispatch_overhead_fraction``), over the window's factorizations."""


def read(rec):
    v = rec.counters.get("dispatch_overhead_fraction")
    return 100.0 * sum(v) / len(v) if v else None
