"""The window's factorizations as a share of the float64 peak, in %:
n^3 / 3 each, over the window's seconds, over 67 TFLOP/s."""

from portbench import yardstick


def read(rec):
    f = rec.facts
    if not f.get("factorizations"):
        return None
    flops = f["factorizations"] * yardstick.cholesky_flops(f["n"])
    return 100.0 * flops / f["window_s"] / yardstick.PEAK_F64_FLOPS
