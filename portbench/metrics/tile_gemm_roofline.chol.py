"""The tile GEMMs' share of their roofline, in %: C(nb + 1, 3) updates at
the byte bound of one (0.352 us at b = 192) over the DMMA kernels' device
time in the traced factorizations."""

from portbench import yardstick


def read(rec):
    tr = rec.trace
    if tr is None:
        return None
    sec, launches = tr.device_s("dmma")
    k = rec.facts.get("traced_factorizations", 0)
    if not sec or not k:
        return None
    nb = rec.facts["n"] // rec.facts["tile"]
    bound = k * yardstick.tile_gemm_count(nb) * yardstick.tile_gemm_bound_s(
        rec.facts["tile"])
    return 100.0 * bound / sec
