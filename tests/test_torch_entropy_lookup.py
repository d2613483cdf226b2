"""The kernels' Huffman symbol lookup (csrc/entropy.cuh ``decode_symbol``): a
first-level lookup on the top ``LUT_BITS`` bits of the window and, where its
entry is 0, the compare loop from level ``LUT_BITS + 1`` (``decode_long``).

A numpy emulation of those two functions reads each table as
``ops/entropy.pack_tables`` packs it for the card and must give, on every
one of the 65,536 16-bit windows, the code length, clipped ordinal and value
of the plain twin's compare loop (``ops/entropy._symbol``): for the tables of
the test streams and the 4K frame, the Annex K tables, a JAX
``EntropyPlan``'s, and seeded random canonical tables (every ``max_len``
from 1 to 16, single codes, a full 16-bit code space). Where the lookup
answers, the ordinal is the one whose value the entry holds; where the loop
does, it is checked itself. Invalid and all-ones windows are among the
65,536."""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from compeg_tpu import analyze as jax_analyze  # noqa: E402
from compeg_tpu import scan as S  # noqa: E402
from compeg_tpu.ops import entropy as JE  # noqa: E402
from compeg_tpu_torch import huffman, testdata  # noqa: E402
from compeg_tpu_torch.metadata import analyze  # noqa: E402
from compeg_tpu_torch.ops import _build  # noqa: E402
from compeg_tpu_torch.ops import entropy as E  # noqa: E402
from compeg_tpu_torch.tools import compare_csrc, exp_table_packing  # noqa: E402

WINDOWS = np.arange(1 << 16, dtype=np.int64)
BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "bench_assets", "bench4k.jpg")


def header_constants() -> dict:
    """The ``constexpr int`` constants of csrc/entropy.cuh, evaluated."""
    with open(os.path.join(_build.CSRC, "entropy.cuh")) as f:
        text = f.read()
    env = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", text):
        env[name] = eval(expr.replace("/", "//"), {}, dict(env))
    return env


def kernel_lookup(halves: np.ndarray, lut_bits: int):
    """``decode_symbol``'s code length and value of every window, as the
    kernel reads the packed table ``halves`` (uint16), and the clipped
    ordinal of ``decode_long`` where the first level has no entry (-1
    elsewhere)."""
    lay = E.table_layout(lut_bits)
    h = halves.astype(np.int64)
    e = h[lay["TAB_LUT"] + (WINDOWS >> (16 - lut_bits))]
    slow = e == 0
    c16 = WINDOWS[slow]
    ln = np.full(c16.shape, lut_bits + 1)
    for j in range(lut_bits + 1, 16):
        ln += c16 >= h[lay["TAB_LIMITS"] + j]
    ln = np.minimum(ln, h[lay["TAB_MAX_LEN"]])
    k = np.minimum(((c16 >> (16 - ln)) + h[lay["TAB_DELTA"] + ln]) & 0xFFFF,
                   h[lay["TAB_NUM_VALUES"]] - 1)
    at = 2 * lay["TAB_VALUES"]
    values = halves.view(np.uint8)[at:at + 256].astype(np.int64)
    e[slow] = ln << 8 | values[k]
    ordinal = np.full(WINDOWS.shape, -1)
    ordinal[slow] = k
    return e >> 8, e & 0xFF, ordinal


def check_tables(tables: E.EntropyTables, lut_bits: int) -> int:
    """Every table of ``tables`` on every window against ``_symbol``;
    returns the number of windows the compare loop answered."""
    table_of, packed = E.pack_tables(tables, lut_bits)
    assert packed.shape == (len(set(table_of)),
                            E.table_layout(lut_bits)["TAB_WORDS"])
    halves = packed.numpy().view(np.uint16)
    words = torch.from_numpy(WINDOWS << 16)  # c16 at the top, bit 0 on
    idx = torch.arange(len(WINDOWS))
    slow_windows = 0
    for c in range(tables.limits.shape[0]):
        for cls in (0, 1):
            tab = (tables.limits[c, cls].long(), tables.delta[c, cls].long(),
                   tables.values[c, cls].long(), int(tables.max_len[c, cls]),
                   int(tables.num_values[c, cls]))
            value, s, _, n = E._symbol(words, 1, idx, torch.zeros_like(idx),
                                       tab, dc=False)
            ln_ref = (n - s).numpy()
            limits, delta, values, max_len, nv = (
                t.numpy() if isinstance(t, torch.Tensor) else t for t in tab)
            k_ref = np.clip((WINDOWS >> (16 - ln_ref)) + delta[ln_ref], 0,
                            nv - 1)
            ln, val, k = kernel_lookup(halves[table_of[2 * c + cls]],
                                       lut_bits)
            assert np.array_equal(ln, ln_ref), np.flatnonzero(ln != ln_ref)[:5]
            assert np.array_equal(val, value.numpy())
            assert np.array_equal(values[k_ref], val)
            slow = k >= 0
            assert np.array_equal(k[slow], k_ref[slow])
            assert slow.any() == (max_len > lut_bits)
            slow_windows += int(slow.sum())
    return slow_windows


def from_canonical(pairs) -> E.EntropyTables:
    """EntropyTables of ``[(dc, ac), ...]`` CanonicalTable pairs."""
    rows = [[(t.limits, t.delta, E._padded(t.values), t.max_len, t.num_values)
             for t in pair] for pair in pairs]
    return E._tables(rows, "cpu", False)


def random_table(rng, max_len: int) -> huffman.CanonicalTable:
    """A random canonical table with codes up to ``max_len`` bits, at most
    256 of them, the code space full or not."""
    counts = [0] * 16
    counts[max_len - 1] = 1
    space = (1 << 16) - (1 << (16 - max_len))
    total = 1
    for ln in range(1, max_len + 1):
        cap = min(space >> (16 - ln), 256 - total)
        n = int(rng.binomial(cap, 0.35)) if cap > 0 else 0
        counts[ln - 1] += n
        space -= n << (16 - ln)
        total += n
    values = rng.choice(256, total, replace=False).tolist()
    return huffman.build_table(counts, values)


@pytest.mark.parametrize("lut_bits", [8, 9])
def test_lookup_equals_compare_loop_on_the_test_streams(lut_bits):
    vec = testdata.load()
    streams = [vec[k].tobytes() for k in vec if k.startswith("jpeg_")]
    streams += [vec["zrl_jpeg"].tobytes(), vec["wrap_jpeg"].tobytes()]
    with open(BENCH, "rb") as f:
        streams.append(f.read())
    seen = set()
    for data in streams:
        tables = E.tables_from_image(analyze(data))
        key = tables.packed.numpy().tobytes()
        if key not in seen:
            seen.add(key)
            check_tables(tables, lut_bits)
    assert len(seen) >= 2  # the encoder's Annex K tables and bench4k's own


@pytest.mark.parametrize("lut_bits", [8, 9])
def test_lookup_equals_compare_loop_on_the_annex_k_tables(lut_bits):
    t = huffman.default_tables()
    tables = from_canonical([(t[0, 0], t[1, 0]), (t[0, 1], t[1, 1])])
    assert tables.table_of == (0, 1, 2, 3)
    # max_len 16 AC tables: some windows take the loop, the DC ones none
    assert check_tables(tables, lut_bits) > 0


def test_lookup_equals_compare_loop_on_a_jax_plan():
    vec = testdata.load()
    data = vec["jpeg_0"].tobytes()
    img = jax_analyze(data)
    plan = JE.plan_from_image(img, S.preprocess(img.scan_data,
                                                img.total_restart_intervals))
    tables = E.tables_from_plan(plan)
    check_tables(tables, E.LUT_BITS)
    assert torch.equal(tables.packed, E.tables_from_image(analyze(data)).packed)


@pytest.mark.parametrize("lut_bits", [8, 9])
def test_lookup_equals_compare_loop_on_random_canonical_tables(lut_bits):
    rng = np.random.default_rng(6)
    tabs = [random_table(rng, max_len) for max_len in range(1, 17)]
    tabs += [random_table(rng, int(m)) for m in rng.integers(9, 17, 8)]
    single = [huffman.build_table([int(i == ln - 1) for i in range(16)], [v])
              for ln, v in ((1, 7), (9, 0), (10, 0xF0), (16, 0xFF))]
    full16 = huffman.build_table([1] * 15 + [2], list(range(17)))
    full8 = huffman.build_table([0] * 7 + [256] + [0] * 8, list(range(256)))
    tabs += single + [full16, full8]
    assert sorted({t.max_len for t in tabs}) == list(range(1, 17))
    for i in range(0, len(tabs), 6):
        group = tabs[i:i + 6] + tabs[:max(0, i + 6 - len(tabs))]
        check_tables(from_canonical(list(zip(group[0::2], group[1::2]))),
                     lut_bits)


def test_packed_layout_is_the_headers():
    """ops/entropy.table_layout is the layout csrc/entropy.cuh reads, and
    a component's tables are packed once however often they recur."""
    c = header_constants()
    lay = E.table_layout()
    assert {k: c[k] for k in lay} == lay
    assert c["LUT_BITS"] == E.LUT_BITS
    assert compare_csrc.tree_lut_bits(_build.CSRC) == E.LUT_BITS
    assert lay["TAB_HALVES"] % 8 == 0  # tables stay 16-byte aligned
    assert c["MAX_TABLES"] == 6
    vec = testdata.load()
    i = list(vec["labels"]).index("422 ri=1 24x40")
    tables = E.tables_from_image(analyze(vec[f"jpeg_{i}"].tobytes()))
    assert tables.table_of == (0, 1, 2, 3, 2, 3)  # Cb and Cr share theirs
    p = _build.make_params(1, 1, 1, 1, (0, 0, 1, 2), samplings=[(2, 1), (1, 1),
                                                                (1, 1)],
                           table_of=tables.table_of)
    assert (p.ntables, list(p.table_of)) == (4, [0, 1, 2, 3, 2, 3])
    with pytest.raises(ValueError, match="table_of"):
        _build.make_params(1, 1, 1, 1, (0,), samplings=[(1, 1)],
                           table_of=(0, 2))


def test_per_component_packing_maps_every_table_to_its_own_row():
    """tools/exp_table_packing's unshared packing: one row for each
    component's DC and AC table, each the row the shared packing maps it
    to."""
    vec = testdata.load()
    i = list(vec["labels"]).index("422 ri=1 24x40")
    tables = E.tables_from_image(analyze(vec[f"jpeg_{i}"].tobytes()))
    each = exp_table_packing.per_component(tables)
    assert each.table_of == tuple(range(6)) and each.packed.shape[0] == 6
    for k, row in enumerate(tables.table_of):
        assert torch.equal(each.packed[k], tables.packed[row])
    assert tables.table_of == (0, 1, 2, 3, 2, 3)  # the input is unchanged


def test_trees_before_the_lookup_get_the_int32_tables():
    """compare_csrc hands a tree without LUT_BITS the [C, 2, 292] int32
    tables it reads: limits, delta, max_len, num_values, values."""
    vec = testdata.load()
    tables = E.tables_from_image(analyze(vec["jpeg_2"].tobytes()))
    old = compare_csrc.legacy_packed(tables)
    assert tuple(old.shape) == (3, 2, 292) and old.dtype == torch.int32
    assert torch.equal(old[..., :17], tables.limits)
    assert torch.equal(old[..., 34], tables.max_len)
    assert torch.equal(old[..., 36:], tables.values)
    assert compare_csrc.tree_lut_bits(os.path.dirname(BENCH)) is None
