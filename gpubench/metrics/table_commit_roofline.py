"""table_commit_roofline: the least time of the traced window's table_commit launches
(the bytes their calls have to move over the card's memory rate) as a
share of their device time, in percent."""

from gpubench.trace import HBM_BYTES_PER_S


def read(t):
    busy = t.csrc_seconds("table_commit")
    moved = t.bytes_moved.get("table_commit", 0.0)
    return 100.0 * moved / HBM_BYTES_PER_S / busy if busy and moved else None
