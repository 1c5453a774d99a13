"""gather_rows_roofline: the least time of the traced window's gather_rows launches
(the bytes their calls have to move over the card's memory rate) as a
share of their device time, in percent."""

from gpubench.trace import HBM_BYTES_PER_S


def read(t):
    busy = t.csrc_seconds("gather_rows")
    moved = t.bytes_moved.get("gather_rows", 0.0)
    return 100.0 * moved / HBM_BYTES_PER_S / busy if busy and moved else None
