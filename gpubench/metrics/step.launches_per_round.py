"""step.launches_per_round: device kernels the traced window ran (the
profiler's kernel events: the step's, the drive's queue, the harness's
inputs and taps) over its drive rounds."""


def read(t):
    return t.launches / t.rounds if t.rounds and t.launches else None
