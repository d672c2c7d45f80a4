"""The device memory the window's steps held at their peak, in GB:
``max_memory_allocated`` after ``reset_peak_memory_stats`` at the
window's start."""


def read(rec):
    b = rec.facts.get("window_peak_bytes")
    return b / 1e9 if b else None
