"""Compact binary trace segment format (``.ctrace``).

Chrome-trace JSON spends most of a segment's bytes repeating the same
strings: every span re-spells its stage name, every event re-spells
``"ph"``/``"pid"``/``"args"``/the trace id. For a week-long streaming
run (ROADMAP: a Perfetto-protobuf-like format would shrink disk 3-5x)
that redundancy is the disk bill. This codec removes it while staying
LOSSLESS for the JSON-able event dicts the spool writes:

- every distinct string (keys and values alike) is interned ONCE per
  segment, in first-use order, as an inline string-definition record —
  the decoder rebuilds the table by reading records in order, so there
  is no separate table section to seek to and a truncated file is
  still detectable;
- integers are LEB128 varints (zigzag for negatives), floats are raw
  IEEE-754 doubles (8 bytes, exact round-trip), bools/None are single
  tags, dicts/lists recurse;
- the file is self-describing: an 8-byte magic+version, a varint-length
  JSON header (the segment's ``otherData`` — trace_id, rank, run_id,
  counts), then a varint event count followed by exactly that many
  event records. A reader that hits EOF early, or a header promising
  more events than the records deliver, reports truncation instead of
  returning a silently short trace.

The port's own copy of ``lightgbm_tpu/obs/trace_compact.py``: the same
magic and records, so each package decodes the other's segments.
Stdlib-only with NO package-relative imports, for the same reason as
:mod:`obs.openmetrics`: a report script can load it by path. The
streaming writer side lives in
:mod:`obs.trace` (``LIGHTGBM_TPU_TRACE_FORMAT=compact``), which feeds
:class:`SegmentEncoder` incrementally so memory stays bounded at the
encoded bytes of the open segment — same contract as the JSON spool.
"""
from __future__ import annotations

import json
import struct
from typing import Dict, List, Optional, Tuple

MAGIC = b"LGTPUCT1"
EXTENSION = ".ctrace"
# record kinds
kRecString = 0x01   # varint len + utf-8 bytes; defines the next id
kRecEvent = 0x02    # one tagged value (the event dict)
# value tags
kTagStr = 0x10      # varint interned-string id
kTagInt = 0x11      # zigzag varint
kTagF64 = 0x12      # 8 raw little-endian IEEE-754 bytes
kTagTrue = 0x13
kTagFalse = 0x14
kTagNull = 0x15
kTagDict = 0x16     # varint n + n * (varint key-string-id, value)
kTagList = 0x17     # varint n + n * value

_pack_f64 = struct.Struct("<d").pack
_unpack_f64 = struct.Struct("<d").unpack_from


def _normalize(v):
    """Canonicalize to the JSON value model (what json.dumps would
    have written): dict keys become strings, tuples become lists,
    anything exotic degrades to ``str(v)`` — the spool only carries
    JSON-able dicts (events.py coerces), so this is a safety net, not
    a fidelity loss vs the JSON format."""
    if isinstance(v, bool) or v is None \
            or isinstance(v, (int, float, str)):
        return v
    if isinstance(v, dict):
        return {str(k): _normalize(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_normalize(x) for x in v]
    return str(v)


def _write_varint(buf: bytearray, n: int) -> None:
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            buf.append(b | 0x80)
        else:
            buf.append(b)
            return


def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63) if n < 0 else (n << 1)


def _unzigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


class SegmentEncoder:
    """Incremental event-stream encoder for one segment.

    ``add_event`` appends records to an internal buffer;
    ``segment_bytes(header)`` assembles the final file image. The
    string table is embedded in the record stream, so the buffer is
    already its final on-disk form — ``encoded_size`` is the exact
    byte cost so far, which is what the spool's size-based rotation
    check needs (the JSON spool sums serialized line lengths the same
    way)."""

    def __init__(self) -> None:
        self._strings: Dict[str, int] = {}
        self._buf = bytearray()
        self.n_events = 0

    @property
    def encoded_size(self) -> int:
        return len(self._buf)

    def _intern(self, s: str) -> int:
        sid = self._strings.get(s)
        if sid is None:
            sid = len(self._strings)
            self._strings[s] = sid
            raw = s.encode("utf-8")
            self._buf.append(kRecString)
            _write_varint(self._buf, len(raw))
            self._buf += raw
        return sid

    def _intern_strings(self, v) -> None:
        """Pre-pass: define every string of ``v`` BEFORE the event
        record opens. Definition records may only sit at record
        boundaries — a definition interleaved inside a dict/list body
        would land where the decoder expects a value tag."""
        if isinstance(v, str):
            self._intern(v)
        elif isinstance(v, dict):
            for k, x in v.items():
                self._intern(k)
                self._intern_strings(x)
        elif isinstance(v, list):
            for x in v:
                self._intern_strings(x)

    def _value(self, v) -> None:
        buf = self._buf
        # bool before int: isinstance(True, int) is True
        if isinstance(v, bool):
            buf.append(kTagTrue if v else kTagFalse)
        elif isinstance(v, str):
            sid = self._strings[v]  # pre-interned
            buf.append(kTagStr)
            _write_varint(buf, sid)
        elif isinstance(v, int):
            buf.append(kTagInt)
            _write_varint(buf, _zigzag(v))
        elif isinstance(v, float):
            buf.append(kTagF64)
            buf += _pack_f64(v)
        elif v is None:
            buf.append(kTagNull)
        elif isinstance(v, dict):
            buf.append(kTagDict)
            _write_varint(buf, len(v))
            for k, x in v.items():
                _write_varint(buf, self._strings[k])
                self._value(x)
        else:  # list (normalized)
            buf.append(kTagList)
            _write_varint(buf, len(v))
            for x in v:
                self._value(x)

    def add_event(self, ev: dict) -> None:
        ev = _normalize(ev)
        self._intern_strings(ev)
        self._buf.append(kRecEvent)
        self._value(ev)
        self.n_events += 1

    def segment_bytes(self, header: dict) -> bytes:
        """The complete self-describing file image: magic, header JSON,
        event count, records."""
        hdr = json.dumps(header, sort_keys=True).encode("utf-8")
        out = bytearray(MAGIC)
        _write_varint(out, len(hdr))
        out += hdr
        _write_varint(out, self.n_events)
        out += self._buf
        return bytes(out)


def encode_events(events: List[dict],
                  header: Optional[dict] = None) -> bytes:
    """One-shot encode (bench shrink measurement, tests)."""
    enc = SegmentEncoder()
    for ev in events:
        enc.add_event(ev)
    return enc.segment_bytes(header or {})


class _Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, pos: int = 0) -> None:
        self.data = data
        self.pos = pos

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise ValueError("truncated compact segment "
                             "(unexpected EOF at byte %d)" % self.pos)
        b = self.data[self.pos]
        self.pos += 1
        return b

    def varint(self) -> int:
        shift = 0
        n = 0
        while True:
            b = self.byte()
            n |= (b & 0x7F) << shift
            if not b & 0x80:
                return n
            shift += 7
            if shift > 63:
                raise ValueError("varint overflow at byte %d" % self.pos)

    def raw(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated compact segment "
                             "(unexpected EOF at byte %d)" % self.pos)
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out


def _read_value(r: _Reader, strings: List[str]):
    tag = r.byte()
    if tag == kTagStr:
        sid = r.varint()
        if sid >= len(strings):
            raise ValueError("undefined string id %d at byte %d"
                             % (sid, r.pos))
        return strings[sid]
    if tag == kTagInt:
        return _unzigzag(r.varint())
    if tag == kTagF64:
        return _unpack_f64(r.raw(8))[0]
    if tag == kTagTrue:
        return True
    if tag == kTagFalse:
        return False
    if tag == kTagNull:
        return None
    if tag == kTagDict:
        n = r.varint()
        out = {}
        for _ in range(n):
            sid = r.varint()
            if sid >= len(strings):
                raise ValueError("undefined string id %d at byte %d"
                                 % (sid, r.pos))
            out[strings[sid]] = _read_value(r, strings)
        return out
    if tag == kTagList:
        n = r.varint()
        return [_read_value(r, strings) for _ in range(n)]
    raise ValueError("unknown value tag 0x%02x at byte %d"
                     % (tag, r.pos - 1))


def decode_segment(data: bytes) -> Tuple[dict, List[dict]]:
    """``(header, events)`` from one compact segment image. Raises
    ValueError on a bad magic, a truncated stream, or an event count
    mismatch — a crash mid-write must be DETECTED, not silently
    shortened (the atomic tmp+rename finalize means a finalized
    ``.ctrace`` never trips this; only a torn copy does)."""
    if data[:len(MAGIC)] != MAGIC:
        raise ValueError("not a compact trace segment "
                         "(bad magic %r)" % data[:len(MAGIC)])
    r = _Reader(data, len(MAGIC))
    hdr_len = r.varint()
    try:
        header = json.loads(r.raw(hdr_len).decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError("corrupt compact segment header: %s" % e)
    n_events = r.varint()
    strings: List[str] = []
    events: List[dict] = []
    while len(events) < n_events:
        kind = r.byte()
        if kind == kRecString:
            n = r.varint()
            strings.append(r.raw(n).decode("utf-8"))
        elif kind == kRecEvent:
            events.append(_read_value(r, strings))
        else:
            raise ValueError("unknown record kind 0x%02x at byte %d"
                             % (kind, r.pos - 1))
    if r.pos != len(r.data):
        raise ValueError("trailing garbage after %d events (%d bytes)"
                         % (n_events, len(r.data) - r.pos))
    return header, events


def read_segment(path: str) -> dict:
    """Load one ``.ctrace`` file as the SAME Chrome-trace document the
    JSON spool writes (metadata events first, ``otherData`` = header):
    the lossless convert target, and what trace_report's validate /
    merge / summarize consume without knowing the format exists."""
    with open(path, "rb") as f:
        data = f.read()
    header, events = decode_segment(data)
    # the JSON writer puts lane-metadata events first; the incremental
    # encoder appends them at finalize (lanes are only known then), so
    # restore the convention here — consumers dedupe metadata by value,
    # not position, but byte-for-byte doc parity keeps convert trivial
    meta = [e for e in events if isinstance(e, dict) and e.get("ph") == "M"]
    rest = [e for e in events
            if not (isinstance(e, dict) and e.get("ph") == "M")]
    return {"traceEvents": meta + rest, "displayTimeUnit": "ms",
            "otherData": header}


def is_compact_file(path: str) -> bool:
    if path.endswith(EXTENSION):
        return True
    try:
        with open(path, "rb") as f:
            return f.read(len(MAGIC)) == MAGIC
    except OSError:
        return False
