"""Streaming JPEG container parser (the port's copy of compeg_tpu/parser.py).

Parses the JPEG/JFIF marker-segment structure into typed segment objects.
This is the Python twin of the native C++ parser in ``native/compeg_host.cpp``
(the C++ one is used on the hot path; this one is the readable spec and test
oracle — the same role the reference keeps a CPU model around for).

Behavioral parity notes (vs the reference implementation):
 - Validates that the stream starts with SOI ``FF D8`` (reference:
   src/file.rs:19-27).
 - Iterates ``FF xx`` marker segments, skipping fill bytes: any number of
   ``FF`` bytes may precede a marker code (reference: src/file.rs:37-44).
 - Stops at EOI and exposes trailing bytes via :attr:`JpegParser.remaining`
   (reference: src/file.rs:100-106, 164-191).
 - A segment whose declared length disagrees with the parsed structure is a
   warning, not an error (reference: src/file.rs:79-90).
 - After SOS, scans the entropy-coded data for the next marker, treating
   RST0-7 as part of the scan data (reference: src/file.rs:164-191).

The parser intentionally parses *more* than the decoder supports: progressive
frames, grayscale, 16-bit quant tables, etc. all parse fine (and are covered
by golden tests); the decode-envelope check lives in :mod:`compeg_tpu_torch.metadata`.
"""

from __future__ import annotations

import logging
import struct
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

from .errors import CompegError, bail

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Marker codes
# ---------------------------------------------------------------------------

SOI = 0xD8
EOI = 0xD9
SOS = 0xDA
DQT = 0xDB
DNL = 0xDC
DRI = 0xDD
DHP = 0xDE
COM = 0xFE
TEM = 0x01

# SOF0..SOF15 occupy 0xC0..0xCF minus DHT(0xC4)/JPG(0xC8)/DAC(0xCC).
SOF0 = 0xC0  # baseline sequential DCT
SOF1 = 0xC1  # extended sequential
SOF2 = 0xC2  # progressive
SOF3 = 0xC3  # lossless
DHT = 0xC4
JPG = 0xC8
DAC = 0xCC

RST0 = 0xD0
RST7 = 0xD7

APP0 = 0xE0
APP15 = 0xEF


def is_sof(marker: int) -> bool:
    return 0xC0 <= marker <= 0xCF and marker not in (DHT, JPG, DAC)


def is_rst(marker: int) -> bool:
    return RST0 <= marker <= RST7


def marker_name(marker: int) -> str:
    fixed = {
        SOI: "SOI", EOI: "EOI", SOS: "SOS", DQT: "DQT", DNL: "DNL",
        DRI: "DRI", DHP: "DHP", COM: "COM", TEM: "TEM", DHT: "DHT",
        JPG: "JPG", DAC: "DAC",
    }
    if marker in fixed:
        return fixed[marker]
    if is_sof(marker):
        return f"SOF{marker - 0xC0}"
    if is_rst(marker):
        return f"RST{marker - RST0}"
    if APP0 <= marker <= APP15:
        return f"APP{marker - APP0}"
    return f"0x{marker:02X}"


# ---------------------------------------------------------------------------
# Bounds-checked big-endian cursor (the reference's `Reader`,
# src/file.rs:268-355)
# ---------------------------------------------------------------------------


class Reader:
    """Bounds-checked big-endian cursor over a bytes-like object."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def remaining(self) -> int:
        return len(self.data) - self.pos

    def u8(self) -> int:
        if self.pos >= len(self.data):
            bail("unexpected end of data")
        b = self.data[self.pos]
        self.pos += 1
        return b

    def u16(self) -> int:
        if self.pos + 2 > len(self.data):
            bail("unexpected end of data")
        (v,) = struct.unpack_from(">H", self.data, self.pos)
        self.pos += 2
        return v

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            bail("unexpected end of data")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def length_prefixed(self) -> "Reader":
        """Read a JPEG 16-bit segment length (which includes its own two
        bytes) and return a sub-reader over the payload
        (reference: src/file.rs:340-354)."""
        ln = self.u16()
        if ln < 2:
            bail(f"invalid segment length {ln}")
        payload = self.take(ln - 2)
        return Reader(payload)


# ---------------------------------------------------------------------------
# Typed segments
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class QuantTable:
    """One table from a DQT segment (spec letters Pq/Tq/Qk;
    reference: src/file.rs:543-594)."""

    precision: int  # Pq: 0 = 8-bit, 1 = 16-bit
    dest: int  # Tq: destination slot 0-3
    values: Tuple[int, ...]  # Qk: 64 entries in zigzag order


@dataclass(frozen=True)
class DqtSegment:
    tables: Tuple[QuantTable, ...]


@dataclass(frozen=True)
class HuffmanTable:
    """One table from a DHT segment (Tc/Th/Li/Vij;
    reference: src/file.rs:596-661)."""

    table_class: int  # Tc: 0 = DC, 1 = AC
    dest: int  # Th: destination slot
    counts: Tuple[int, ...]  # Li: 16 code counts by length 1..16
    values: Tuple[int, ...]  # Vij: concatenated symbol values


@dataclass(frozen=True)
class DhtSegment:
    tables: Tuple[HuffmanTable, ...]


@dataclass(frozen=True)
class DriSegment:
    """Restart interval definition (Ri; reference: src/file.rs:663-690)."""

    restart_interval: int


@dataclass(frozen=True)
class FrameComponent:
    """Ci/Hi/Vi/Tqi (reference: src/file.rs:792-844)."""

    id: int
    h_sample: int
    v_sample: int
    qtable: int


@dataclass(frozen=True)
class SofSegment:
    """Start-of-frame (reference: src/file.rs:692-790)."""

    marker: int  # the SOFn marker code (0xC0..0xCF)
    precision: int  # P: sample precision in bits
    height: int  # Y
    width: int  # X
    components: Tuple[FrameComponent, ...]

    @property
    def sof_index(self) -> int:
        return self.marker - 0xC0


@dataclass(frozen=True)
class ScanComponent:
    """Csj/Tdj/Taj (reference: src/file.rs:908-943)."""

    id: int
    dc_table: int
    ac_table: int


@dataclass(frozen=True)
class SosSegment:
    """Start-of-scan header + location of the entropy-coded data
    (reference: src/file.rs:846-906)."""

    components: Tuple[ScanComponent, ...]
    ss: int  # spectral selection start
    se: int  # spectral selection end
    ah: int  # successive approximation high
    al: int  # successive approximation low
    data_offset: int  # absolute offset of the entropy-coded data
    data_len: int  # length of the entropy-coded data (excl. terminating marker)


@dataclass(frozen=True)
class Jfif:
    """Typed view of a JFIF APP0 payload (version, pixel density, thumbnail;
    reference: src/file.rs:399-497)."""

    major: int
    minor: int
    density_unit: int  # 0 none, 1 dpi, 2 dots/cm
    x_density: int
    y_density: int
    thumb_width: int
    thumb_height: int


@dataclass(frozen=True)
class AppSegment:
    n: int  # APPn index 0-15
    data: bytes

    def jfif(self) -> Optional[Jfif]:
        """Parse the payload as JFIF when this is a JFIF APP0."""
        if self.n != 0 or not self.data.startswith(b"JFIF\x00"):
            return None
        if len(self.data) < 14:
            return None
        d = self.data
        return Jfif(
            major=d[5],
            minor=d[6],
            density_unit=d[7],
            x_density=(d[8] << 8) | d[9],
            y_density=(d[10] << 8) | d[11],
            thumb_width=d[12],
            thumb_height=d[13],
        )


@dataclass(frozen=True)
class ComSegment:
    text: bytes


@dataclass(frozen=True)
class RawSegment:
    """A segment kind we don't model; payload kept verbatim."""

    marker: int
    data: bytes


@dataclass(frozen=True)
class Segment:
    offset: int  # offset of the 0xFF marker byte
    marker: int
    kind: object  # one of the dataclasses above, or None for bare markers

    @property
    def name(self) -> str:
        return marker_name(self.marker)


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------


class JpegParser:
    """Streaming segment iterator over a JPEG byte stream.

    Usage::

        p = JpegParser(data)
        for seg in p:
            ...
        trailing = p.remaining()
    """

    def __init__(self, data: bytes):
        self.data = data
        self.r = Reader(data)
        self._done = False
        if self.r.remaining() < 2 or self.r.u8() != 0xFF or self.r.u8() != SOI:
            bail("missing SOI marker")

    def remaining(self) -> bytes:
        """Bytes after the EOI marker (reference: src/file.rs:100-106)."""
        return self.data[self.r.pos :]

    def __iter__(self) -> Iterator[Segment]:
        while True:
            seg = self.next_segment()
            if seg is None:
                return
            yield seg

    def next_segment(self) -> Optional[Segment]:
        if self._done or self.r.remaining() == 0:
            return None
        r = self.r
        # Expect 0xFF, then skip fill bytes (repeated 0xFF).
        offset = r.pos
        b = r.u8()
        if b != 0xFF:
            bail(f"expected marker, found byte 0x{b:02X} at offset {offset}")
        marker = r.u8()
        while marker == 0xFF:  # fill bytes
            offset = r.pos - 1
            marker = r.u8()

        if marker == EOI:
            self._done = True
            return Segment(offset, marker, None)
        if marker == 0x00:
            # `FF 00` outside a scan is byte-stuffing leaked into marker
            # position — always malformed (the reference errors identically,
            # src/file.rs:43-45; see PARITY.md).
            bail(f"invalid marker 0x00 at offset {offset}")
        if is_rst(marker) or marker == TEM:
            # Bare markers with no payload (RST outside a scan is unusual but
            # representable).
            return Segment(offset, marker, None)

        kind: object
        if marker == DQT:
            kind = self._parse_dqt(r.length_prefixed())
        elif marker == DHT:
            kind = self._parse_dht(r.length_prefixed())
        elif marker == DRI:
            kind = self._parse_dri(r.length_prefixed())
        elif is_sof(marker):
            kind = self._parse_sof(marker, r.length_prefixed())
        elif marker == SOS:
            kind = self._parse_sos(r)
        elif APP0 <= marker <= APP15:
            sub = r.length_prefixed()
            kind = AppSegment(marker - APP0, sub.data)
        elif marker == COM:
            sub = r.length_prefixed()
            kind = ComSegment(sub.data)
        else:
            sub = r.length_prefixed()
            kind = RawSegment(marker, sub.data)
        return Segment(offset, marker, kind)

    # -- per-kind payload parsers -------------------------------------------

    @staticmethod
    def _skip_excess(r: Reader, what: str) -> None:
        """Warn about (and skip) declared-but-unparsed payload bytes — the
        reference accepts such sloppy-but-decodable files with a warning
        (src/file.rs:79-90) rather than rejecting them."""
        if r.remaining() > 0:
            log.warning(
                "%d trailing byte(s) in %s segment payload; skipping",
                r.remaining(),
                what,
            )
            r.take(r.remaining())

    @staticmethod
    def _parse_dqt(r: Reader) -> DqtSegment:
        tables: List[QuantTable] = []
        while r.remaining() >= 65:  # 1 (Pq/Tq) + at least 64 values
            pqtq = r.u8()
            pq, tq = pqtq >> 4, pqtq & 0xF
            if pq not in (0, 1):
                bail(f"invalid DQT precision {pq}")
            if tq > 3:
                bail(f"invalid DQT destination {tq}")
            if pq == 0:
                vals = tuple(r.take(64))
            else:
                raw = r.take(128)
                vals = tuple(struct.unpack(">64H", raw))
            tables.append(QuantTable(pq, tq, vals))
        if not tables:
            bail("DQT segment with no complete table")
        JpegParser._skip_excess(r, "DQT")
        return DqtSegment(tuple(tables))

    @staticmethod
    def _parse_dht(r: Reader) -> DhtSegment:
        tables: List[HuffmanTable] = []
        while r.remaining() >= 17:  # 1 (Tc/Th) + 16 counts
            tcth = r.u8()
            tc, th = tcth >> 4, tcth & 0xF
            if tc not in (0, 1):
                bail(f"invalid DHT class {tc}")
            if th > 3:
                bail(f"invalid DHT destination {th}")
            counts = tuple(r.take(16))
            total = sum(counts)
            if total > 256:
                bail(f"DHT declares {total} codes")
            values = tuple(r.take(total))
            tables.append(HuffmanTable(tc, th, counts, values))
        if not tables:
            bail("DHT segment with no complete table")
        JpegParser._skip_excess(r, "DHT")
        return DhtSegment(tuple(tables))

    @staticmethod
    def _parse_dri(r: Reader) -> DriSegment:
        return DriSegment(r.u16())

    @staticmethod
    def _parse_sof(marker: int, r: Reader) -> SofSegment:
        precision = r.u8()
        height = r.u16()
        width = r.u16()
        ncomp = r.u8()
        comps: List[FrameComponent] = []
        for _ in range(ncomp):
            cid = r.u8()
            hv = r.u8()
            tq = r.u8()
            comps.append(FrameComponent(cid, hv >> 4, hv & 0xF, tq))
        return SofSegment(marker, precision, height, width, tuple(comps))

    def _parse_sos(self, r: Reader) -> SosSegment:
        sub = r.length_prefixed()
        ncomp = sub.u8()
        comps: List[ScanComponent] = []
        for _ in range(ncomp):
            cs = sub.u8()
            tdta = sub.u8()
            comps.append(ScanComponent(cs, tdta >> 4, tdta & 0xF))
        ss = sub.u8()
        se = sub.u8()
        ahal = sub.u8()
        if sub.remaining() != 0:
            log.warning("SOS header has %d unparsed bytes", sub.remaining())
        # Scan the entropy-coded data for the terminating marker. RSTn and
        # byte-stuffed FF 00 belong to the scan (reference: src/file.rs:164-191):
        # the native search where the host library is built, else numpy's.
        # An error in the native search is raised, never hidden by the other.
        from . import native

        data_offset = r.pos
        find = native.find_scan_end if native.available() else scan_end
        r.pos = find(self.data, r.pos)
        return SosSegment(
            tuple(comps), ss, se, ahal >> 4, ahal & 0xF, data_offset, r.pos - data_offset
        )


def scan_end(data: bytes, offset: int = 0) -> int:
    """Offset of the marker terminating the scan that starts at ``offset``,
    vectorized: the first FF whose successor is a real marker (not 00, not
    RST0-7, not another FF); ``len(data)`` if there is none. The numpy twin
    of :func:`compeg_tpu_torch.native.find_scan_end`."""
    import numpy as np

    # (The second byte of a stuffed FF00 / RSTn pair is never 0xFF, so a
    # simple "FF followed by a real marker code" test cannot misfire on a
    # consumed byte — no sequential pair tracking is needed.)
    arr = np.frombuffer(data, dtype=np.uint8, count=len(data) - offset,
                        offset=offset)
    if arr.size > 1:
        ffs = np.nonzero(arr[:-1] == 0xFF)[0]
        nxt = arr[ffs + 1]
        real = (nxt != 0x00) & (nxt != 0xFF) & ((nxt < 0xD0) | (nxt > 0xD7))
        hits = ffs[real]
        if hits.size:
            return offset + int(hits[0])
    return offset + arr.size


def parse_segments(data: bytes) -> List[Segment]:
    """Parse all segments of ``data`` eagerly."""
    return list(JpegParser(data))


def dump_segments(data: bytes) -> str:
    """Render every parsed segment to text for golden-file tests (the same
    idea as the reference's parser snapshot dumps, src/file/tests.rs:9-55)."""
    lines = []
    try:
        p = JpegParser(data)
        for seg in p:
            lines.append(f"{seg.offset:#08x} {seg.name}: {seg.kind!r}")
        tail = p.remaining()
        if tail:
            lines.append(f"trailing: {len(tail)} bytes")
    except CompegError as e:
        lines.append(f"error: {e}")
    return "\n".join(lines) + "\n"
