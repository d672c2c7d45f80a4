"""AdamW's share of its roofline, in %: 24 bytes a parameter at 3.35 TB/s
over one ``adamw_update`` of the cell's whole tree, timed with CUDA
events after the window."""

from portbench import yardstick


def read(rec):
    s = rec.facts.get("adamw_s")
    if not s or rec.device_type != "cuda":
        return None
    return 100.0 * yardstick.adamw_floor_s(rec.facts["n_params"]) / s
