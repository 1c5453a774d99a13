"""step.device_ms_per_round: milliseconds the device was busy (the union of
the profiler's kernel, copy and set intervals) over the traced window's
drive rounds."""


def read(t):
    return t.busy_s * 1e3 / t.rounds if t.rounds and t.busy_s else None
