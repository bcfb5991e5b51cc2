"""Append-only interaction log with crash-consistent framing (a copy of
genrec_tpu/data/stream_log.py, which is framework-free: the same bytes on
disk, so a log written by either package reads in the other).

The streaming-training pipeline (docs/training.md "Streaming training")
needs a durable record stream whose tail can be torn by a SIGKILL at ANY
byte and still never yields a partial record to a consumer. The format
is deliberately boring — the guarantees come from the recovery rules,
which tests/test_torch_stream_log.py pins at every byte boundary of the last
frame:

- **Frames**: ``[u32 LE payload_len][u32 LE crc32(payload)][payload]``.
  A frame is committed iff its header AND payload are fully on disk and
  the CRC matches. There is no resync marker: frames are only ever
  parsed front-to-back from a segment start, so a bad length can't
  silently skip into the middle of a later record.
- **Segments**: numbered files ``segment-00000000.log`` … rotated once a
  segment exceeds ``segment_bytes``. Only the LAST segment can legally
  hold a torn tail; an invalid frame in any earlier segment is real
  corruption (data after it would be unreachable) and raises
  :class:`StreamLogCorruptError` instead of being "recovered".
- **Torn-tail recovery**: on writer open, the last segment is scanned
  and truncated to the end of its last valid frame (fsync'd) before any
  new append. Readers apply the same rule without mutating the file:
  an invalid tail frame in the last segment simply isn't yielded.
- **Durability**: every append is flushed + ``os.fsync``'d by default
  (``sync=False`` trades that for throughput; a crash then loses the OS
  write-back window but still never yields a partial record).
- **Cursor**: :class:`CursorStore` persists a reader position with the
  atomic tmp+fsync+rename discipline checkpoints use. The streaming
  trainer stores ``{epoch, next_batch, global_step, data_seed}`` beside
  the record index so the log cursor and `PackedTrainLoop`'s exact
  resume point (core/fault_tolerance.py) name the same record.

Chaos: ``ChaosPlan.die_in_append_at_record`` makes :meth:`append` write
a genuinely torn frame (header + partial payload, fsync'd) and SIGKILL
the process — the recovery path is exercised against real torn bytes,
not simulations (core/chaos.py).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import struct
import zlib

from genrec_tpu_torch.core import chaos

_HEADER = struct.Struct("<II")  # (payload_len, crc32)
HEADER_BYTES = _HEADER.size
_SEGMENT_RE = re.compile(r"^segment-(\d{8})\.log$")
_CURSOR_FORMAT = 1


class StreamLogError(RuntimeError):
    """Base class for stream-log failures."""


class StreamLogCorruptError(StreamLogError):
    """An invalid frame somewhere a torn tail cannot legally be (i.e.
    not at the end of the last segment): committed data is damaged."""


def _segment_name(index: int) -> str:
    return f"segment-{index:08d}.log"


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def list_segments(directory: str) -> list[tuple[int, str]]:
    """Sorted ``(index, abspath)`` for every segment file present."""
    out = []
    for name in os.listdir(directory):
        m = _SEGMENT_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    out.sort()
    return out


def scan_segment(path: str) -> tuple[list[bytes], int, bool]:
    """Parse one segment front-to-back.

    Returns ``(payloads, valid_end, clean)``: the committed payloads, the
    byte offset just past the last VALID frame, and whether that offset
    is the physical end of the file (``clean=False`` means a torn or
    corrupt tail follows).
    """
    payloads: list[bytes] = []
    valid_end = 0
    with open(path, "rb") as f:
        data = f.read()
    n = len(data)
    off = 0
    while off + HEADER_BYTES <= n:
        length, crc = _HEADER.unpack_from(data, off)
        end = off + HEADER_BYTES + length
        if end > n:
            break  # length runs past EOF: torn (or garbled length)
        payload = data[off + HEADER_BYTES:end]
        if zlib.crc32(payload) != crc:
            break  # torn payload or garbled header/payload bytes
        payloads.append(payload)
        off = end
        valid_end = off
    return payloads, valid_end, valid_end == n


class StreamLogWriter:
    """Append-only writer. Safe to reopen after SIGKILL at any byte:
    the constructor truncates a torn tail before the first new append.

    ``records_committed`` after open tells a restarted producer exactly
    how many records survived, so it can resume the source stream
    without loss or duplication.
    """

    def __init__(self, directory: str, *, segment_bytes: int = 1 << 20,
                 sync: bool = True):
        self.directory = os.path.abspath(directory)
        self.segment_bytes = int(segment_bytes)
        self.sync = bool(sync)
        os.makedirs(self.directory, exist_ok=True)
        segments = list_segments(self.directory)
        self._next_record = 0
        if segments:
            for idx, path in segments[:-1]:
                payloads, _, clean = scan_segment(path)
                if not clean:
                    raise StreamLogCorruptError(
                        f"invalid frame mid-log in non-last segment {path}"
                    )
                self._next_record += len(payloads)
            last_idx, last_path = segments[-1]
            payloads, valid_end, clean = scan_segment(last_path)
            self._next_record += len(payloads)
            if not clean:
                # Torn tail from a crash mid-append: drop it durably.
                with open(last_path, "r+b") as f:
                    f.truncate(valid_end)
                    f.flush()
                    os.fsync(f.fileno())
            self._segment_index = last_idx
        else:
            self._segment_index = 0
            # Create segment 0 so the directory always names its tail.
            with open(os.path.join(self.directory, _segment_name(0)), "ab"):
                pass
            _fsync_dir(self.directory)
        self._f = open(self._segment_path(), "ab")

    def _segment_path(self) -> str:
        return os.path.join(self.directory, _segment_name(self._segment_index))

    @property
    def records_committed(self) -> int:
        """Global index the NEXT append will get == records durable."""
        return self._next_record

    def _rotate(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        self._segment_index += 1
        self._f = open(self._segment_path(), "ab")
        _fsync_dir(self.directory)

    def append(self, payload: bytes) -> int:
        """Durably append one record; returns its global record index."""
        if self._f.tell() >= self.segment_bytes:
            self._rotate()
        frame = _HEADER.pack(len(payload), zlib.crc32(payload)) + payload
        record = self._next_record

        def _torn_write():
            # A REAL torn tail for the chaos kill: header plus part of
            # the payload, durably on disk before the SIGKILL lands.
            self._f.write(frame[: HEADER_BYTES + max(0, len(payload) // 2)])
            self._f.flush()
            os.fsync(self._f.fileno())

        chaos.maybe_die_in_append(record, partial_write=_torn_write)
        self._f.write(frame)
        self._f.flush()
        if self.sync:
            os.fsync(self._f.fileno())
        self._next_record += 1
        return record

    def append_many(self, payloads) -> int:
        """Append a batch with ONE fsync at the end; returns the index
        just past the last record appended."""
        sync, self.sync = self.sync, False
        try:
            for p in payloads:
                self.append(p)
        finally:
            self.sync = sync
        self._f.flush()
        if self.sync:
            os.fsync(self._f.fileno())
        return self._next_record

    def close(self) -> None:
        if self._f is not None:
            self._f.flush()
            os.fsync(self._f.fileno())
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class StreamLogReader:
    """Reads committed records; never yields a torn or invalid frame.

    Stateless over the files (every call re-lists segments), so one
    reader instance can tail a log another process is appending to: new
    records simply appear in the next :meth:`read` call.
    """

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)

    def _segments(self):
        segments = list_segments(self.directory)
        for pos, (idx, path) in enumerate(segments):
            payloads, _, clean = scan_segment(path)
            if not clean and pos != len(segments) - 1:
                raise StreamLogCorruptError(
                    f"invalid frame mid-log in non-last segment {path}"
                )
            yield payloads

    def count(self) -> int:
        """Number of committed records currently readable."""
        return sum(len(p) for p in self._segments())

    def read(self, start: int = 0, max_records: int | None = None) -> list[bytes]:
        """Committed records ``[start, start + max_records)`` (fewer if
        the log is shorter)."""
        out: list[bytes] = []
        skip = start
        for payloads in self._segments():
            if skip >= len(payloads):
                skip -= len(payloads)
                continue
            out.extend(payloads[skip:])
            skip = 0
            if max_records is not None and len(out) >= max_records:
                return out[:max_records]
        return out


@dataclasses.dataclass(frozen=True)
class Cursor:
    """A durable reader position: ``record`` is the global index of the
    next UNCONSUMED record; ``meta`` carries the consumer's own resume
    coordinates (the streaming trainer stores its
    ``{epoch, next_batch, global_step, data_seed}`` resume point here so
    log position and train position commit together)."""

    record: int
    meta: dict


class CursorStore:
    """Atomic (tmp + fsync + rename + dir fsync) JSON cursor file — the
    same commit discipline the checkpoint layer uses, so a crash between
    any two syscalls leaves either the old cursor or the new one, never
    a torn file."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    def load(self) -> Cursor | None:
        try:
            with open(self.path) as f:
                raw = json.load(f)
        except FileNotFoundError:
            return None
        except (json.JSONDecodeError, OSError) as e:
            raise StreamLogCorruptError(
                f"unreadable cursor file {self.path}: {e}"
            ) from e
        if raw.get("format") != _CURSOR_FORMAT:
            raise StreamLogCorruptError(
                f"cursor format {raw.get('format')!r} != {_CURSOR_FORMAT}"
            )
        return Cursor(record=int(raw["record"]), meta=dict(raw.get("meta", {})))

    def save(self, record: int, meta: dict | None = None) -> None:
        tmp = self.path + ".tmp"
        payload = {"format": _CURSOR_FORMAT, "record": int(record),
                   "meta": meta or {}}
        with open(tmp, "w") as f:
            json.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        _fsync_dir(os.path.dirname(self.path) or ".")
