"""The run's peak of allocated device memory (`max_memory_allocated`)."""


def read(rec):
    return rec["peak_bytes"] / 1e9 if rec["peak_bytes"] else None
