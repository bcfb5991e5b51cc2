"""Crash-consistency properties of the port's append-only stream log
(genrec_tpu_torch/data/stream_log.py, a copy of the JAX package's
framework-free module): tests/test_stream_log.py's cases run against the
port's copy, and the two packages' logs are held to each other — a log
written by either reads in the other, and the same appends write the same
segment bytes.

The load-bearing test is the byte-boundary property sweep: for a
committed log, EVERY possible truncation point and EVERY single-bit
garble of the tail segment must recover to an exact prefix of the
original records — a consumer can never observe a partial or corrupted
payload, only fewer records. The SIGKILL-mid-append half (a REAL torn
frame written by ``ChaosPlan.die_in_append_at_record`` before the kill)
lives in tests/test_torch_pipeline.py.
"""

import os
import shutil

import pytest

from genrec_tpu_torch.data.stream_log import (
    HEADER_BYTES,
    Cursor,
    CursorStore,
    StreamLogCorruptError,
    StreamLogReader,
    StreamLogWriter,
    list_segments,
    scan_segment,
)


def _payloads(n, start=0):
    """Deterministic, length-varied payloads (incl. an empty one)."""
    return [bytes((start + i) % 256 for _ in range(i % 7)) + f"r{start + i}".encode()
            for i in range(n)]


# ---------------------------------------------------------------------------
# roundtrip / rotation / tailing
# ---------------------------------------------------------------------------


def test_roundtrip_and_records_committed(tmp_path):
    d = str(tmp_path / "log")
    payloads = _payloads(9)
    with StreamLogWriter(d) as w:
        for i, p in enumerate(payloads):
            assert w.append(p) == i
        assert w.records_committed == 9
    r = StreamLogReader(d)
    assert r.count() == 9
    assert r.read() == payloads
    assert r.read(3) == payloads[3:]
    assert r.read(3, 2) == payloads[3:5]
    assert r.read(100) == []
    # Reopen: the writer resumes the global index where it left off.
    with StreamLogWriter(d) as w:
        assert w.records_committed == 9
        assert w.append(b"ten") == 9
    assert StreamLogReader(d).read(9) == [b"ten"]


def test_rotation_spans_segments(tmp_path):
    d = str(tmp_path / "log")
    payloads = _payloads(40)
    with StreamLogWriter(d, segment_bytes=64) as w:
        for p in payloads:
            w.append(p)
    assert len(list_segments(d)) > 1
    assert StreamLogReader(d).read() == payloads
    # append_many batches the fsync but commits every record.
    with StreamLogWriter(d, segment_bytes=64) as w:
        assert w.append_many([b"a", b"b"]) == 42
    assert StreamLogReader(d).count() == 42


def test_reader_tails_a_live_writer(tmp_path):
    d = str(tmp_path / "log")
    w = StreamLogWriter(d)
    r = StreamLogReader(d)
    assert r.count() == 0
    w.append(b"one")
    assert r.read() == [b"one"]  # same reader, no reopen
    w.append(b"two")
    assert r.read(1) == [b"two"]
    w.close()


# ---------------------------------------------------------------------------
# the byte-boundary property sweep
# ---------------------------------------------------------------------------


def _build_reference(tmp_path, segment_bytes=10 ** 9):
    d = str(tmp_path / "ref")
    payloads = _payloads(6)
    with StreamLogWriter(d, segment_bytes=segment_bytes) as w:
        for p in payloads:
            w.append(p)
    (_, path), = list_segments(d)[-1:]
    return d, payloads, path


def _frame_ends(payloads):
    ends, off = [0], 0
    for p in payloads:
        off += HEADER_BYTES + len(p)
        ends.append(off)
    return ends


def test_truncate_at_every_byte_recovers_exact_prefix(tmp_path):
    """SIGKILL can stop a write after ANY byte: truncating the tail
    segment at every offset must (a) read back as an exact record
    prefix, (b) let a reopened writer resume appending from exactly
    records_committed, with nothing lost, duplicated, or torn."""
    ref, payloads, ref_seg = _build_reference(tmp_path)
    total = os.path.getsize(ref_seg)
    ends = _frame_ends(payloads)
    for cut in range(total + 1):
        d = str(tmp_path / f"cut{cut}")
        shutil.copytree(ref, d)
        (_, seg), = list_segments(d)
        with open(seg, "r+b") as f:
            f.truncate(cut)
        expect = sum(1 for e in ends[1:] if e <= cut)
        # Reader: exact prefix, no mutation of the file.
        assert StreamLogReader(d).read() == payloads[:expect], cut
        # Writer recovery: torn tail dropped durably, append continues.
        with StreamLogWriter(d) as w:
            assert w.records_committed == expect, cut
            assert w.append(b"resumed") == expect
        got = StreamLogReader(d).read()
        assert got == payloads[:expect] + [b"resumed"], cut
        shutil.rmtree(d)


def test_garble_every_byte_never_yields_corrupt_payload(tmp_path):
    """Flip one bit at every byte of the tail segment: recovery must
    yield SOME exact prefix of the original records — never a record
    whose bytes differ from what was appended (CRC32 catches any
    single-bit damage to header or payload)."""
    ref, payloads, ref_seg = _build_reference(tmp_path)
    total = os.path.getsize(ref_seg)
    for pos in range(total):
        d = str(tmp_path / f"flip{pos}")
        shutil.copytree(ref, d)
        (_, seg), = list_segments(d)
        with open(seg, "r+b") as f:
            f.seek(pos)
            b = f.read(1)
            f.seek(pos)
            f.write(bytes([b[0] ^ 0x40]))
        got = StreamLogReader(d).read()
        assert got == payloads[:len(got)], pos
        with StreamLogWriter(d) as w:
            n = w.records_committed
            assert n == len(got), pos
            w.append(b"after")
        assert StreamLogReader(d).read() == payloads[:n] + [b"after"], pos
        shutil.rmtree(d)


def test_corruption_in_non_last_segment_raises(tmp_path):
    """A torn tail is only legal at the END of the log. Damage in an
    earlier segment makes everything after it unreachable — that is real
    data loss, and both reader and writer must refuse loudly instead of
    'recovering' by silently dropping committed records."""
    d = str(tmp_path / "log")
    with StreamLogWriter(d, segment_bytes=48) as w:
        for p in _payloads(20):
            w.append(p)
    segs = list_segments(d)
    assert len(segs) >= 3
    _, first = segs[0]
    with open(first, "r+b") as f:
        f.truncate(os.path.getsize(first) - 1)
    with pytest.raises(StreamLogCorruptError):
        StreamLogReader(d).read()
    with pytest.raises(StreamLogCorruptError):
        StreamLogWriter(d)


def test_scan_segment_reports_clean_flag(tmp_path):
    d = str(tmp_path / "log")
    with StreamLogWriter(d) as w:
        w.append(b"aaa")
        w.append(b"bbbb")
    (_, seg), = list_segments(d)
    payloads, end, clean = scan_segment(seg)
    assert payloads == [b"aaa", b"bbbb"] and clean
    with open(seg, "ab") as f:
        f.write(b"\x05\x00\x00\x00")  # torn header fragment
    payloads2, end2, clean2 = scan_segment(seg)
    assert payloads2 == payloads and end2 == end and not clean2


# ---------------------------------------------------------------------------
# durable cursor
# ---------------------------------------------------------------------------


def test_cursor_roundtrip_and_atomicity(tmp_path):
    store = CursorStore(str(tmp_path / "cursor.json"))
    assert store.load() is None
    store.save(16, meta={"epoch": 1, "global_step": 2, "data_seed": 0})
    cur = store.load()
    assert cur == Cursor(record=16,
                         meta={"epoch": 1, "global_step": 2, "data_seed": 0})
    store.save(32)
    assert store.load().record == 32
    # The atomic-rename discipline leaves no tmp file behind.
    assert os.listdir(tmp_path) == ["cursor.json"]


def test_cursor_refuses_torn_or_foreign_file(tmp_path):
    p = str(tmp_path / "cursor.json")
    store = CursorStore(p)
    with open(p, "w") as f:
        f.write('{"format": 1, "rec')  # torn pre-atomic write
    with pytest.raises(StreamLogCorruptError):
        store.load()
    with open(p, "w") as f:
        f.write('{"format": 99, "record": 3}')
    with pytest.raises(StreamLogCorruptError):
        store.load()


# ---------------------------------------------------------------------------
# the two packages' logs
# ---------------------------------------------------------------------------


def _write(writer_cls, d, payloads, **kw):
    with writer_cls(d, **kw) as w:
        for p in payloads:
            w.append(p)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_logs_cross_read_between_packages(tmp_path, direction):
    """A log written by one package reads back whole in the other, across
    rotated segments, and its writer resumes at the same record index."""
    from genrec_tpu.data import stream_log as jax_log
    from genrec_tpu_torch.data import stream_log as port_log

    src, dst = ((jax_log, port_log) if direction == "jax_to_port"
                else (port_log, jax_log))
    d = str(tmp_path / "log")
    payloads = _payloads(30)
    _write(src.StreamLogWriter, d, payloads, segment_bytes=64)
    assert len(dst.list_segments(d)) > 1
    assert dst.StreamLogReader(d).read() == payloads
    with dst.StreamLogWriter(d, segment_bytes=64) as w:
        assert w.records_committed == 30
        assert w.append(b"next") == 30
    assert src.StreamLogReader(d).read(30) == [b"next"]
    store = dst.CursorStore(str(tmp_path / "cursor.json"))
    store.save(16, meta={"epoch": 1})
    assert src.CursorStore(store.path).load() == src.Cursor(record=16, meta={"epoch": 1})


def test_segment_bytes_equal_between_packages(tmp_path):
    """The same appends (rotation included) write the same files, byte for
    byte, in either package."""
    from genrec_tpu.data.stream_log import StreamLogWriter as JaxWriter

    payloads = _payloads(40)
    _write(JaxWriter, str(tmp_path / "jax"), payloads, segment_bytes=64)
    _write(StreamLogWriter, str(tmp_path / "port"), payloads, segment_bytes=64)
    jax_segs = list_segments(str(tmp_path / "jax"))
    port_segs = list_segments(str(tmp_path / "port"))
    assert [i for i, _ in jax_segs] == [i for i, _ in port_segs] and len(port_segs) > 1
    for (_, a), (_, b) in zip(jax_segs, port_segs):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), b
