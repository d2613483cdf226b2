"""Canonical Huffman table machinery (the port's copy of
compeg_tpu/huffman.py; the CUDA kernels read ``limits``, ``delta`` and
``values`` as plain device tables, see ops/entropy.py).

The reference builds a 2-level *lookup table* per DHT (256-entry L1 indexed by
the first 8 code bits + an L2 spill table; reference: src/huffman.rs:33-119)
because its GPU threads can gather from table memory cheaply. TPU vector
lanes cannot gather, so this engine uses a different, gather-free decode
scheme built on the *canonical* structure of JPEG Huffman codes
(ITU T.81 Annex C):

  * all codes of length L form one contiguous range of code values, and
  * the 16-bit left-aligned code intervals are sorted by length.

From a DHT's ``(Li, Vij)`` we derive, per table:

  ``limits[L]``  = ``(maxcode[L] + 1) << (16 - L)`` — the exclusive upper end
                   of length-L codes when left-aligned in 16 bits. The code
                   length of a peeked 16-bit word ``c16`` is then
                   ``1 + sum(c16 >= limits[L] for L in 1..15)`` — 15 vector
                   compares, no memory indexing.
  ``delta[L]``   = ``valptr[L] - mincode[L]`` so the symbol ordinal is
                   ``(c16 >> (16 - L)) + delta[L]``.
  ``value_words``= the symbol values (ordinal order) packed 4-per-u32 so a
                   TPU lane can fetch its value with a small select tree plus
                   a dynamic-shift extract.

The same canonical data drives the encoder (tests) and the golden CPU decoder.

Annex K default tables are installed by :mod:`compeg_tpu_torch.metadata` so MJPEG
streams with no DHT decode, matching the reference (src/lib.rs:608-613).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np

from .errors import bail

MAX_CODE_LEN = 16
# Upper bound on packed value words per table: 256 values / 4 per word.
MAX_VALUE_WORDS = 64


@dataclass(frozen=True)
class CanonicalTable:
    """Gather-free decode representation of one Huffman table."""

    counts: Tuple[int, ...]  # Li, 16 entries
    values: Tuple[int, ...]  # Vij in canonical (ordinal) order
    # limits[L] for L in 0..16; limits[0] = 0; entries are exclusive upper
    # bounds of the left-aligned 16-bit code range of length L. For lengths
    # with no codes the limit equals the previous one (zero-width interval).
    limits: Tuple[int, ...]
    # delta[L] = valptr[L] - mincode[L]; 0 for lengths with no codes.
    delta: Tuple[int, ...]
    max_len: int

    @property
    def num_values(self) -> int:
        return len(self.values)

    def value_words(self, pad_to: int = MAX_VALUE_WORDS) -> np.ndarray:
        """Symbol values packed 4 per u32, little-endian within the word:
        ``value[k] = (words[k >> 2] >> ((k & 3) * 8)) & 0xFF``."""
        n = len(self.values)
        nwords = (n + 3) // 4
        if nwords > pad_to:
            bail(f"huffman table with {n} values exceeds {pad_to * 4}")
        words = np.zeros(pad_to, dtype=np.uint32)
        for k, v in enumerate(self.values):
            words[k >> 2] |= np.uint32(v) << np.uint32((k & 3) * 8)
        return words

    # -- scalar decode (golden decoder / tests) -----------------------------

    def code_length(self, c16: int) -> int:
        """Length of the code at the top of the 16 peeked bits."""
        ln = 1
        for j in range(1, MAX_CODE_LEN):
            if c16 >= self.limits[j]:
                ln += 1
        return ln

    def decode(self, c16: int) -> Tuple[int, int]:
        """Decode the code in the top bits of ``c16``; returns (value, bits).

        Invalid codes (c16 beyond the last limit) raise.
        """
        ln = self.code_length(c16)
        if c16 >= self.limits[self.max_len]:
            bail("invalid huffman code")
        k = (c16 >> (16 - ln)) + self.delta[ln]
        return self.values[k], ln

    # -- encode side (used by the test-asset encoder) -----------------------

    def encode_map(self) -> Dict[int, Tuple[int, int]]:
        """value -> (code, length) for every symbol in the table."""
        out: Dict[int, Tuple[int, int]] = {}
        code = 0
        k = 0
        for ln in range(1, MAX_CODE_LEN + 1):
            for _ in range(self.counts[ln - 1]):
                out[self.values[k]] = (code, ln)
                code += 1
                k += 1
            code <<= 1
        return out


def build_table(counts: Sequence[int], values: Sequence[int]) -> CanonicalTable:
    """Build the canonical decode parameters from DHT ``(Li, Vij)``.

    Follows the Annex C code-assignment flowcharts: codes of length L are
    assigned consecutively starting from ``(mincode[L-1] + count[L-1]) << 1``.
    Cached: streams re-send identical DHTs every frame.
    """
    return _build_table_cached(tuple(counts), tuple(values))


@functools.lru_cache(maxsize=256)
def _build_table_cached(
    counts: Tuple[int, ...], values: Tuple[int, ...]
) -> CanonicalTable:
    if len(counts) != 16:
        bail("DHT must declare 16 code counts")
    total = sum(counts)
    if total != len(values):
        bail(f"DHT declares {total} codes but provides {len(values)} values")
    if total == 0 or total > 256:
        bail(f"DHT with {total} values is not decodable")

    limits = [0] * (MAX_CODE_LEN + 1)
    delta = [0] * (MAX_CODE_LEN + 1)
    code = 0
    k = 0
    max_len = 0
    for ln in range(1, MAX_CODE_LEN + 1):
        cnt = counts[ln - 1]
        mincode = code
        valptr = k
        code += cnt
        k += cnt
        if code > (1 << ln):
            bail(f"DHT over-subscribed at length {ln}")
        # Exclusive upper bound of length-ln codes, left-aligned to 16 bits.
        limits[ln] = code << (16 - ln)
        if cnt:
            delta[ln] = valptr - mincode
            max_len = ln
        code <<= 1
    # Lengths past max_len: pin the limit to 2**16 so they never match, and
    # lengths below max_len keep their (monotone) limits so the compare-sum
    # length computation lands on populated lengths only.
    for ln in range(max_len + 1, MAX_CODE_LEN + 1):
        limits[ln] = 1 << 16
    return CanonicalTable(
        counts=tuple(counts),
        values=tuple(values),
        limits=tuple(limits),
        delta=tuple(delta),
        max_len=max_len,
    )


# ---------------------------------------------------------------------------
# ITU T.81 Annex K.3 default tables (public spec data). Installed as defaults
# so MJPEG streams that ship no DHT decode, matching the reference
# (src/lib.rs:608-613).
# ---------------------------------------------------------------------------

# K.3.1 luminance DC
DC_LUMA_COUNTS = (0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0)
DC_LUMA_VALUES = tuple(range(12))

# K.3.1 chrominance DC
DC_CHROMA_COUNTS = (0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0)
DC_CHROMA_VALUES = tuple(range(12))

# K.3.2 luminance AC
AC_LUMA_COUNTS = (0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D)
AC_LUMA_VALUES = (
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12,
    0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
    0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0,
    0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16,
    0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
    0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
    0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
    0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98,
    0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
    0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5,
    0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4,
    0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA,
    0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA,
)

# K.3.2 chrominance AC
AC_CHROMA_COUNTS = (0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77)
AC_CHROMA_VALUES = (
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21,
    0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
    0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0,
    0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34,
    0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
    0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
    0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
    0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96,
    0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
    0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
    0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2,
    0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9,
    0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA,
)


def default_tables() -> Dict[Tuple[int, int], CanonicalTable]:
    """Annex K defaults keyed by (table_class, dest): class 0=DC 1=AC."""
    return {
        (0, 0): build_table(DC_LUMA_COUNTS, DC_LUMA_VALUES),
        (0, 1): build_table(DC_CHROMA_COUNTS, DC_CHROMA_VALUES),
        (1, 0): build_table(AC_LUMA_COUNTS, AC_LUMA_VALUES),
        (1, 1): build_table(AC_CHROMA_COUNTS, AC_CHROMA_VALUES),
    }
