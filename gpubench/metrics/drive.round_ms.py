"""drive.round_ms: wall milliseconds of a drive round (``tpu/drive.py``: the
host's launches, its one sync a round and the device's work), over all the
time and all the rounds of units that the traced run times untraced."""


def read(t):
    return t.plain_s * 1e3 / t.plain_rounds if t.plain_rounds else None
