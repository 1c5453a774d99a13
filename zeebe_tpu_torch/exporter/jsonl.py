"""Rotating JSONL audit exporter.

One json document per committed record, append-only files rotated by size
(``audit-p<partition>-<first-position>.jsonl``). The file set is an exact,
replayable image of the partition's record stream:

- **Exactly-once in the file** despite at-least-once delivery: on open the
  exporter scans its newest file for the last durably written position and
  skips re-delivered records at or below it (the broker resumes export
  from the last *acked* position after a crash, which may be behind the
  file tail).
- **Torn-tail tolerant**: a crash mid-line leaves a trailing partial json
  line; open() truncates the file back to the last complete line before
  appending (the same recovery contract as the log storage's torn-tail
  scan).

``read_audit_docs`` replays a directory back into the document sequence —
used by the CI smoke step to assert file⇔log parity.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, List, Optional

from zeebe_tpu_torch.exporter.base import Exporter, ExporterContext, record_to_doc

DEFAULT_ROTATE_BYTES = 64 * 1024 * 1024


class JsonlExporter(Exporter):
    """args: ``path`` (directory, required), ``rotate_bytes`` (optional),
    ``fsync`` (optional bool, default false — flush-per-batch only)."""

    def __init__(self):
        self.directory: Optional[str] = None
        self.rotate_bytes = DEFAULT_ROTATE_BYTES
        self.fsync = False
        self.prefix = "audit"
        self.partition_id = 0
        self._file = None
        self._file_size = 0
        self._last_position = -1
        self._log = None

    # -- lifecycle ----------------------------------------------------------
    def configure(self, context: ExporterContext) -> None:
        args = context.args or {}
        path = args.get("path")
        if not path:
            raise ValueError(
                f"jsonl exporter {context.exporter_id!r}: args.path "
                "(audit directory) is required"
            )
        self.directory = str(path)
        self.rotate_bytes = int(args.get("rotate_bytes", DEFAULT_ROTATE_BYTES))
        self.fsync = bool(args.get("fsync", False))
        self.prefix = str(args.get("prefix", "audit"))
        self.partition_id = context.partition_id
        self._log = context.log()

    def open(self, controller) -> None:
        os.makedirs(self.directory, exist_ok=True)
        files = self._files()
        if files:
            self._recover(files)
        # else: first record opens the first file (named by its position),
        # and _last_position stays -1 — so a WIPED directory under an
        # acked position >= 0 is a hole exactly like a lost tail
        if (
            controller is not None
            and getattr(controller, "acked_position", -1) > self._last_position
        ):
            # the broker's ack (fsync'd raft log) outran the audit lines
            # it covers: the un-fsynced tail was lost with the page cache
            # to an OS/power crash, or the audit directory itself was
            # wiped/unmounted. The director resumes ABOVE the file tail
            # and will never re-deliver the gap — report it, do not
            # silently present a holed audit trail as complete
            from zeebe_tpu_torch.runtime.metrics import count_event

            count_event(
                "exporter_audit_holes",
                "JSONL audit files missing records below the durable "
                "ack (un-fsynced tail lost to an OS crash, or audit "
                "directory lost)",
            )
            self._log.error(
                "audit trail HOLE: acked position %d but the recovered "
                "file tail is %d — records between were lost with the "
                "page cache or the audit directory (set args.fsync=true "
                "to make audit lines durable before they are acked)",
                controller.acked_position, self._last_position,
            )

    def _recover(self, files) -> None:
        # a crash between rotation and the new file's first flush leaves
        # the newest file empty (or torn down to empty) — walk back until
        # a complete line is found, else the dedup tail is -1 and
        # already-persisted records in older files re-write
        for path in reversed(files):
            self._last_position = _recover_file_tail(path)
            if self._last_position >= 0:
                break
        newest = files[-1]
        self._file = self._open_audit(newest)
        self._file_size = os.path.getsize(newest)

    def close(self) -> None:
        if self._file is not None:
            self._file.flush()
            try:
                os.fsync(self._file.fileno())
            except OSError:
                pass
            self._file.close()
            self._file = None

    # -- export -------------------------------------------------------------
    def export_batch(self, records) -> None:
        """Serialize the WHOLE batch into one buffer and issue ONE
        ``write`` + flush per batch (one per file when rotation splits
        it) — per-record writes were a syscall per record on the egress
        hot path. Re-delivered rows (crash resume below the recovered
        file tail) are skipped via the position COLUMN, before any row
        materializes; rotation byte-accounting is unchanged (a record
        lands in the current file whenever its pre-write size is below
        ``rotate_bytes``, exactly like the per-record path did)."""
        positions_col = getattr(records, "positions", None)
        positions = (
            positions_col() if positions_col is not None
            else [r.position for r in records]
        )
        last = self._last_position
        buffer: list = []

        def flush_buffer() -> None:
            if buffer:
                self._file.write("".join(buffer))
                buffer.clear()

        wrote = False
        try:
            for i, position in enumerate(positions):
                if position <= last:
                    continue  # re-delivery below the file tail (crash resume)
                if self._file is None or self._file_size >= self.rotate_bytes:
                    flush_buffer()  # lines belong to the file they sized into
                    self._rotate(position)
                line = json.dumps(
                    record_to_doc(records[i]), separators=(",", ":"),
                    sort_keys=True,
                )
                buffer.append(line + "\n")
                # default ensure_ascii escapes all non-ASCII, so len(line)
                # IS the on-disk byte count and rotate_bytes holds exactly
                self._file_size += len(line) + 1
                last = position
                wrote = True
        finally:
            # a mid-batch failure persists the lines already serialized,
            # exactly like the per-record path (the director re-delivers
            # from the last ack; the dedup tail skips these)
            flush_buffer()
            self._last_position = last
        if wrote:
            self._file.flush()
            if self.fsync:
                os.fsync(self._file.fileno())

    # -- files --------------------------------------------------------------
    def _file_name(self, first_position: int) -> str:
        return os.path.join(
            self.directory,
            f"{self.prefix}-p{self.partition_id}-{first_position:012d}.jsonl",
        )

    def _files(self) -> List[str]:
        return _audit_files(self.directory, self.partition_id, self.prefix)

    def _rotate(self, first_position: int) -> None:
        if self._file is not None:
            self._file.flush()
            try:
                os.fsync(self._file.fileno())
            except OSError:
                pass
            self._file.close()
        path = self._file_name(first_position)
        self._file = self._open_audit(path)
        self._file_size = os.path.getsize(path)

    def _open_audit(self, path: str):
        """Open an audit file for appending — the seam tests wrap to count
        syscall-level writes (the batched ``export_batch`` contract: one
        write per batch per file)."""
        return open(path, "a", encoding="utf-8")


def _audit_files(directory: str, partition_id: int, prefix: str) -> List[str]:
    """The partition's audit files, oldest → newest (one listing shared by
    the exporter and the replay verifier so the name scheme can't drift)."""
    want = f"{prefix}-p{partition_id}-"
    try:
        names = sorted(
            n for n in os.listdir(directory)
            if n.startswith(want) and n.endswith(".jsonl")
        )
    except OSError:
        return []
    return [os.path.join(directory, n) for n in names]


# tail-scan window: widened (doubled) until a valid line is found, so a
# leadership install reads KBs of a near-rotation-size file, not all of it
_TAIL_CHUNK = 64 * 1024


def _recover_file_tail(path: str) -> int:
    """Validate an audit file's tail: truncate torn/corrupt TRAILING lines
    (crash mid-write) and return the last complete line's position (-1
    when none survives). A corrupt line with content after it is NOT a
    torn tail — it is bitrot, and the valid lines following it are intact
    evidence that `read_audit_docs` is designed to detect and raise on:
    those are preserved (reported, never truncated). Scans backwards in
    chunks — the newest file can be ~rotate_bytes large, and slurping +
    json-parsing all of it on every leadership install costs seconds of
    CPU per partition."""
    size = os.path.getsize(path)
    chunk = _TAIL_CHUNK
    while True:
        start = max(0, size - chunk)
        with open(path, "rb") as f:
            f.seek(start)
            data = f.read()
        offset = 0
        if start > 0:
            # the window starts mid-line: lines before the first newline
            # boundary belong to the unscanned (assumed-valid) prefix
            nl = data.find(b"\n")
            if nl < 0:
                chunk *= 2
                continue
            offset = nl + 1
        keep = start + offset
        last_position = -1
        bitrot = False
        while offset < len(data):
            nl = data.find(b"\n", offset)
            if nl < 0:
                break  # trailing torn fragment: cut at `keep` below
            line = data[offset : nl]
            try:
                doc = json.loads(line.decode("utf-8"))
                last_position = int(doc["position"])
            except (ValueError, KeyError, TypeError, UnicodeDecodeError):
                if nl + 1 < len(data):
                    # complete corrupt line with content AFTER it: bitrot,
                    # not a torn tail — preserve it (and everything after)
                    # and keep scanning for the dedup tail
                    bitrot = True
                    keep = start + nl + 1
                    offset = nl + 1
                    continue
                break  # final complete-but-corrupt line: torn-tail, cut
            keep = start + nl + 1
            offset = nl + 1
        if last_position < 0 and start > 0:
            chunk *= 2  # no valid line in this window: widen
            continue
        if bitrot:
            from zeebe_tpu_torch.runtime.metrics import count_event

            count_event(
                "exporter_audit_bitrot",
                "Audit files with a corrupt non-trailing line (bitrot "
                "preserved on disk; read_audit_docs raises on it)",
            )
            logging.getLogger(__name__).error(
                "audit file %s has a corrupt NON-trailing line (bitrot, "
                "not a torn tail) — preserved for forensics; replay via "
                "read_audit_docs will raise on it", os.path.basename(path),
            )
        if keep < size:
            with open(path, "r+b") as f:
                f.truncate(keep)
        return last_position


def read_audit_docs(directory: str, partition_id: int = 0,
                    prefix: str = "audit") -> List[Dict[str, Any]]:
    """Replay a JSONL audit directory into the ordered document list.
    Only the NEWEST file may end in a torn line (crash mid-write, skipped
    exactly like open()); a corrupt line anywhere else is bitrot, not a
    torn tail — raise rather than return a sequence with a silent hole."""
    docs: List[Dict[str, Any]] = []
    paths = _audit_files(directory, partition_id, prefix)
    for path in paths:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    docs.append(json.loads(line))
                except ValueError:
                    # only a TRAILING partial line of the newest file is a
                    # torn tail; a corrupt line with anything after it (or
                    # in an older file) is bitrot — raise, don't return a
                    # silently truncated sequence
                    if path == paths[-1] and not any(l.strip() for l in f):
                        break
                    raise ValueError(
                        f"corrupt audit line in {os.path.basename(path)!r} "
                        "(content follows it or an older file: bitrot, "
                        "not a torn tail)"
                    )
    return docs
