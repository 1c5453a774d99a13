"""tick.ms: milliseconds of one ``tpu.kernel.tick_kernel`` call on the device
(CUDA events around each tick the traced window makes; their mean)."""


def read(t):
    return sum(t.tick_ms) / len(t.tick_ms) if t.tick_ms else None
