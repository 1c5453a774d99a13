"""csrc_roofline: the least time of all the traced window's launches of the
hand-written kernels (``zeebe_tpu_torch/csrc``: the bytes their calls have
to move over the card's memory rate) as a share of their device time, in
percent."""

from gpubench.trace import HBM_BYTES_PER_S, KERNELS


def read(t):
    busy = sum(t.csrc_seconds(k) for k in KERNELS)
    moved = sum(t.bytes_moved.get(k, 0.0) for k in KERNELS)
    return 100.0 * moved / HBM_BYTES_PER_S / busy if busy and moved else None
