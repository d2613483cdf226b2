"""Whole-file analysis: parse a JPEG into a decode-ready ``ImageData`` (the
port's copy of compeg_tpu/metadata.py).

This is the analogue of the reference's ``ImageData`` analyzer
(src/lib.rs:576-851): it walks the segment stream, enforces the supported
envelope, installs Annex K default Huffman tables up front (so MJPEG streams
with no DHT decode, reference src/lib.rs:608-613), and derives the decode
geometry (MCU grid, restart intervals, DU layout).

Envelope differences from the reference (deliberate widenings):
 - the reference accepts only 4:2:2 (Y 2x1, C 1x1; src/lib.rs:650-665);
   this engine also accepts 4:4:4 (all 1x1) and 4:2:0 (Y 2x2, C 1x1),
   because the kernels are written against a generic per-MCU DU layout.
 - grayscale (single-component) frames are accepted with a trivial layout;
   declared sampling factors are ignored (normalized to 1x1), matching
   libjpeg: a single-component scan's MCU is one data unit and the
   component spans the full frame regardless of Hi/Vi (T.81 A.2.2 — the
   reference corpus' blank_800x280.jpg / grayscale_*_sampling2x2.jpg).
 - three-component frames whose component IDs are 'R','G','B' decode as
   RGB (no YCbCr conversion), libjpeg's color-space inference for the
   JFIF-less RGB case (the reference corpus' rgb.jpg).
Everything else matches: SOF0 only, 8-bit precision, baseline scan header
Ss=0/Se=63/Ah=Al=0, component order in scan == frame order, 8-bit qtables.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import parser as P
from .errors import CompegError, bail
from .huffman import CanonicalTable, build_table, default_tables


@dataclass(frozen=True)
class ComponentInfo:
    """Decode-ready info for one frame component."""

    id: int
    h_sample: int
    v_sample: int
    qtable: int  # quantization table slot
    dc_table: int  # DHT slot selected by the scan header (Td)
    ac_table: int  # DHT slot selected by the scan header (Ta)


@dataclass
class ImageData:
    """Everything needed to decode one image, CPU-side."""

    width: int
    height: int
    components: List[ComponentInfo]
    # Quantization tables by slot, zigzag order, widened to i32.
    qtables: Dict[int, np.ndarray]
    # Canonical huffman tables keyed by (class 0=DC/1=AC, slot).
    htables: Dict[Tuple[int, int], CanonicalTable]
    restart_interval: int  # in MCUs; == total MCUs when no DRI was present
    scan_data: bytes
    # Zero-copy handle on the entropy-coded span within the source buffer
    # (the native pack reads straight from `source` at `scan_offset`).
    source: Optional[bytes] = None
    scan_offset: int = 0
    # "ycbcr" (default), "rgb" (component IDs R,G,B: no color transform,
    # libjpeg's inference for JFIF-less 3-component frames), or "gray".
    color_space: str = "ycbcr"

    # Derived geometry:
    max_h: int = 0
    max_v: int = 0
    width_mcus: int = 0
    height_mcus: int = 0
    total_mcus: int = 0
    total_restart_intervals: int = 0
    dus_per_mcu: int = 0
    # du_to_comp[i] = component index supplying the i-th DU of each MCU.
    du_to_comp: Tuple[int, ...] = ()
    had_dri: bool = False

    # ------------------------------------------------------------------

    @property
    def mcu_width(self) -> int:
        return self.max_h * 8

    @property
    def mcu_height(self) -> int:
        return self.max_v * 8

    def parallelism(self) -> int:
        """Number of independently decodable restart segments — the size of
        the data-parallel grid (reference: src/lib.rs:838-846). Below ~10000
        a CPU decoder is likely faster than a device round-trip."""
        return self.total_restart_intervals

    def qtable_for_comp(self, comp: int) -> np.ndarray:
        return self.qtables[self.components[comp].qtable]

    def dc_table_for_comp(self, comp: int) -> CanonicalTable:
        return self.htables[(0, self.components[comp].dc_table)]

    def ac_table_for_comp(self, comp: int) -> CanonicalTable:
        return self.htables[(1, self.components[comp].ac_table)]


def _derive_du_layout(comps: List[ComponentInfo]) -> Tuple[int, ...]:
    """DU-slot -> component mapping for one interleaved MCU: components in
    frame order, each contributing Vi*Hi consecutive DUs."""
    layout: List[int] = []
    for i, c in enumerate(comps):
        layout.extend([i] * (c.h_sample * c.v_sample))
    return tuple(layout)


def _infer_color_space(comps: List[ComponentInfo]) -> str:
    """libjpeg's color-space inference (jdmaster/jdcolor): single component
    is grayscale; component IDs 'R','G','B' mean the samples are already RGB
    and no YCbCr->RGB transform applies (reference corpus rgb.jpg); anything
    else is YCbCr."""
    if len(comps) == 1:
        return "gray"
    if len(comps) == 3 and tuple(c.id for c in comps) == (0x52, 0x47, 0x42):
        return "rgb"
    return "ycbcr"


SUPPORTED_SAMPLINGS = {
    # (tuple of (h, v) per component in frame order)
    ((2, 1), (1, 1), (1, 1)),  # 4:2:2 — the reference's envelope
    ((1, 1), (1, 1), (1, 1)),  # 4:4:4
    ((2, 2), (1, 1), (1, 1)),  # 4:2:0
    ((1, 2), (1, 1), (1, 1)),  # 4:4:0 (vertically subsampled chroma)
    ((4, 1), (1, 1), (1, 1)),  # 4:1:1 (DV-camera horizontal subsampling)
    ((1, 1),),  # grayscale
}

# Same hard cap as the reference (wgpu dispatch limit x workgroup size,
# src/lib.rs:295-298). Our grids are not dispatch-limited, but the cap
# bounds the device buffers a hostile/degenerate file can demand.
MAX_RESTART_INTERVALS = 64 * 65535


def analyze(data: bytes, use_native: Optional[bool] = None) -> ImageData:
    """Parse + validate ``data`` into an :class:`ImageData`.

    Uses the native C++ one-pass parser when available (falling back to the
    Python parser, which also produces the detailed error messages for
    malformed files). Raises :class:`CompegError` for anything outside the
    supported envelope; the caller should fall back to a general software
    decoder.
    """
    if use_native is not False:
        try:
            from . import native

            if native.available():
                return _finish_analysis(_native_raw(data, native), data)
        except CompegError:
            pass  # re-parse in Python for the canonical error/behavior
    return _analyze_python(data)


def _native_raw(data: bytes, native) -> dict:
    """Run the C++ parser and lift its flat struct into the same raw dict the
    Python walk produces."""
    info = native.parse(bytes(data))
    qtables = {
        t: np.ctypeslib.as_array(info.qtab[t]).astype(np.int32)
        for t in range(4)
        if info.qtab_present[t]
    }
    htables = dict(default_tables())
    for i in range(info.n_huff):
        counts = tuple(info.ht_counts[i])
        values = tuple(info.ht_values[i][: info.ht_nvalues[i]])
        htables[(info.ht_class[i], info.ht_dest[i])] = build_table(counts, values)
    comps = [
        dict(
            id=info.comp_id[k],
            h=info.comp_h[k],
            v=info.comp_v[k],
            q=info.comp_q[k],
            dc=info.comp_dc[k],
            ac=info.comp_ac[k],
        )
        for k in range(info.ncomp)
    ]
    return dict(
        sof_marker=info.sof_marker,
        precision=info.precision,
        width=info.width,
        height=info.height,
        comps=comps,
        qtables=qtables,
        htables=htables,
        ri=info.restart_interval if info.has_dri else None,
        ss=info.ss,
        se=info.se,
        ah=info.ah,
        al=info.al,
        scan_offset=info.scan_offset,
        scan_len=info.scan_len,
        scan_comp_ids=list(info.scan_comp_id[: info.scan_ncomp]),
    )


def _finish_analysis(raw: dict, data: bytes) -> ImageData:
    """Shared envelope validation + geometry derivation."""
    if raw["sof_marker"] != P.SOF0:
        bail(
            "only baseline (SOF0) is supported, got "
            f"{P.marker_name(raw['sof_marker'])}"
        )
    if raw["precision"] != 8:
        bail(f"only 8-bit precision is supported, got {raw['precision']}")
    if raw["width"] == 0 or raw["height"] == 0:
        bail("zero image dimension")
    if len(raw["comps"]) == 1:
        # Single-component scan: the MCU is one data unit and the component
        # spans the full frame whatever Hi/Vi declare (T.81 A.2.2, libjpeg
        # jdinput.c) — normalize the declared sampling to 1x1 so e.g. a
        # grayscale frame declared 2x2 decodes like libjpeg does.
        raw["comps"][0]["h"] = raw["comps"][0]["v"] = 1
    sampling = tuple((c["h"], c["v"]) for c in raw["comps"])
    if sampling not in SUPPORTED_SAMPLINGS:
        bail(f"unsupported component sampling {sampling}")
    if raw["ss"] != 0 or raw["se"] != 63 or raw["ah"] != 0 or raw["al"] != 0:
        bail("non-baseline scan header")
    # Scan components must be the frame components, in frame order
    # (reference: src/lib.rs:742-745). Both analyzers enforce this so a
    # malformed file cannot analyze successfully on one path and fail on
    # the other.
    scan_ids = raw["scan_comp_ids"]
    if len(scan_ids) != len(raw["comps"]):
        bail("scan/frame component count mismatch")
    for fc, sid in zip(raw["comps"], scan_ids):
        if fc["id"] != sid:
            bail("scan component order must match frame order")

    comps: List[ComponentInfo] = []
    for c in raw["comps"]:
        if c["q"] not in raw["qtables"]:
            bail(f"component references missing qtable {c['q']}")
        for cls, slot in ((0, c["dc"]), (1, c["ac"])):
            if (cls, slot) not in raw["htables"]:
                bail(f"component references missing huffman table ({cls},{slot})")
        comps.append(ComponentInfo(c["id"], c["h"], c["v"], c["q"], c["dc"], c["ac"]))

    img = ImageData(
        width=raw["width"],
        height=raw["height"],
        components=comps,
        color_space=_infer_color_space(comps),
        qtables=raw["qtables"],
        htables=raw["htables"],
        restart_interval=0,
        scan_data=data[raw["scan_offset"] : raw["scan_offset"] + raw["scan_len"]],
        source=bytes(data),
        scan_offset=raw["scan_offset"],
    )
    ri = raw["ri"]
    img.max_h = max(c.h_sample for c in comps)
    img.max_v = max(c.v_sample for c in comps)
    img.width_mcus = -(-img.width // (8 * img.max_h))
    img.height_mcus = -(-img.height // (8 * img.max_v))
    img.total_mcus = img.width_mcus * img.height_mcus
    img.had_dri = ri is not None and ri > 0
    img.restart_interval = ri if img.had_dri else img.total_mcus
    img.total_restart_intervals = -(-img.total_mcus // img.restart_interval)
    if img.total_restart_intervals > MAX_RESTART_INTERVALS:
        bail(
            f"image has {img.total_restart_intervals} restart intervals, "
            f"more than the supported {MAX_RESTART_INTERVALS}"
        )
    img.du_to_comp = _derive_du_layout(comps)
    img.dus_per_mcu = len(img.du_to_comp)
    return img


def _analyze_python(data: bytes) -> ImageData:
    """Pure-Python analysis path (fallback + test oracle)."""
    qtables: Dict[int, np.ndarray] = {}
    htables: Dict[Tuple[int, int], CanonicalTable] = dict(default_tables())
    sof: Optional[P.SofSegment] = None
    sos: Optional[P.SosSegment] = None
    ri: Optional[int] = None
    scan_data = b""

    for seg in P.JpegParser(bytes(data)):
        k = seg.kind
        if isinstance(k, P.SofSegment):
            if sof is not None:
                bail("multiple SOF segments")
            sof = k
        elif isinstance(k, P.DqtSegment):
            for t in k.tables:
                if t.precision != 0:
                    bail("16-bit quantization tables are not supported")
                qtables[t.dest] = np.array(t.values, dtype=np.int32)
        elif isinstance(k, P.DhtSegment):
            for t in k.tables:
                htables[(t.table_class, t.dest)] = build_table(t.counts, t.values)
        elif isinstance(k, P.DriSegment):
            ri = k.restart_interval
        elif isinstance(k, P.SosSegment):
            if sos is not None:
                bail("multiple scans are not supported")
            sos = k
            scan_data = data[k.data_offset : k.data_offset + k.data_len]

    if sof is None:
        bail("missing SOF segment")
    if sos is None:
        bail("missing SOS segment")

    # -- envelope checks (reference: src/lib.rs:627-754) --------------------
    if sof.marker != P.SOF0:
        bail(f"only baseline (SOF0) is supported, got {P.marker_name(sof.marker)}")
    if sof.precision != 8:
        bail(f"only 8-bit precision is supported, got {sof.precision}")
    if sof.width == 0 or sof.height == 0:
        bail("zero image dimension")
    single = len(sof.components) == 1
    # Single-component scans ignore declared Hi/Vi (see _finish_analysis).
    sampling = tuple(
        (1, 1) if single else (c.h_sample, c.v_sample) for c in sof.components
    )
    if sampling not in SUPPORTED_SAMPLINGS:
        bail(f"unsupported component sampling {sampling}")
    if sos.ss != 0 or sos.se != 63 or sos.ah != 0 or sos.al != 0:
        bail("non-baseline scan header")
    if len(sos.components) != len(sof.components):
        bail("scan/frame component count mismatch")
    for fc, sc in zip(sof.components, sos.components):
        if fc.id != sc.id:
            bail("scan component order must match frame order")

    comps: List[ComponentInfo] = []
    for fc, sc in zip(sof.components, sos.components):
        if fc.qtable not in qtables:
            bail(f"component references missing qtable {fc.qtable}")
        for cls, slot in ((0, sc.dc_table), (1, sc.ac_table)):
            if (cls, slot) not in htables:
                bail(f"component references missing huffman table ({cls},{slot})")
        h, v = (1, 1) if single else (fc.h_sample, fc.v_sample)
        comps.append(
            ComponentInfo(fc.id, h, v, fc.qtable, sc.dc_table, sc.ac_table)
        )

    img = ImageData(
        width=sof.width,
        height=sof.height,
        components=comps,
        color_space=_infer_color_space(comps),
        qtables=qtables,
        htables=htables,
        restart_interval=0,
        scan_data=scan_data,
        source=bytes(data),
        scan_offset=sos.data_offset,
    )

    # -- geometry (reference: src/lib.rs:768-793) ---------------------------
    img.max_h = max(c.h_sample for c in comps)
    img.max_v = max(c.v_sample for c in comps)
    img.width_mcus = -(-sof.width // (8 * img.max_h))
    img.height_mcus = -(-sof.height // (8 * img.max_v))
    img.total_mcus = img.width_mcus * img.height_mcus
    img.had_dri = ri is not None and ri > 0
    # No DRI (or Ri=0): the whole scan is one giant interval, parallelism 1.
    img.restart_interval = ri if img.had_dri else img.total_mcus
    img.total_restart_intervals = -(-img.total_mcus // img.restart_interval)
    if img.total_restart_intervals > MAX_RESTART_INTERVALS:
        bail(
            f"image has {img.total_restart_intervals} restart intervals, "
            f"more than the supported {MAX_RESTART_INTERVALS}"
        )
    img.du_to_comp = _derive_du_layout(comps)
    img.dus_per_mcu = len(img.du_to_comp)
    return img
