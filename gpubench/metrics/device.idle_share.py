"""device.idle_share: the share of a drive round's wall time in which no
kernel, copy or set ran on the device, in percent: the profiled units' busy
time a round over the wall time a round of as many units of the same sizes
run untraced (the profiler stretches the window it profiles, not the
device's work)."""


def read(t):
    if not (t.busy_s and t.rounds and t.plain_s and t.plain_rounds):
        return None
    return 100.0 * (1.0 - (t.busy_s / t.rounds) / (t.plain_s / t.plain_rounds))
