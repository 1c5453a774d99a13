"""state.rebuild_ms: milliseconds of one ``tpu.state.rebuild_lookup_state``
call on the device (CUDA events around each call the harness makes in
the traced window; their mean)."""


def read(t):
    return sum(t.rebuild_ms) / len(t.rebuild_ms) if t.rebuild_ms else None
