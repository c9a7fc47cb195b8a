"""The port's multi-field CSV decoder against the JAX package's.

``parse_fields`` decodes every numeric field of a CSV scan in one pass
(one kernel launch on the card).  On the CPU its wrapper runs the plain
version, ``parse_fields_ref``, which must be bitwise equal to the JAX
package's Pallas ``parse_i32`` (interpret mode) and its scan's
``_parse_i32`` / ``_parse_f32``, and to the port's one-field plain
versions, over random field sets at odd offsets of row matrices of
several widths.  The decoder's host-side word plan must cover exactly
the 16-byte words that hold a field byte, and the blocks' windows must
hold every byte they decode.  A CSV scan must call the decode helper
once with all of its numeric fields.  Tolerance: none.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.filter_project import kernel as JK  # noqa: E402
from repro.relational import physical as JP  # noqa: E402
from repro_torch.kernels.filter_project import kernel as TK  # noqa: E402
from repro_torch.kernels.filter_project import ops as TO  # noqa: E402
from repro_torch.kernels.filter_project import ref as TR  # noqa: E402
from repro_torch.relational import physical as TP  # noqa: E402

JAX_BLOCK = 8


def _rows(n: int, width: int, seed: int) -> np.ndarray:
    """``(n, width)`` rows of ASCII digits, a run of '0' rows and, past
    four fifths, zero-byte padding rows (digit -48), as a scan's raw
    matrix has them."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(48, 58, (n, width)).astype(np.uint8)
    raw[n // 3:n // 3 + n // 9] = 48
    raw[n - n // 5:] = 0
    return raw


def _fields(rng, width: int, k: int):
    """``k`` random (offset, width) fields of a ``width``-byte row,
    overlapping or not, at any (mostly odd) offset."""
    return [(int(rng.integers(0, width - w + 1)), int(w))
            for w in rng.choice((10, 8), k)]


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _jax_field(raw: np.ndarray, off: int, w: int) -> np.ndarray:
    field = np.ascontiguousarray(raw[:, off:off + w])
    if w == 8:
        return np.asarray(JP._parse_f32(jnp.asarray(field)))
    n = field.shape[0]
    pad = np.full((-(-n // JAX_BLOCK) * JAX_BLOCK, 10), 48, np.uint8)
    pad[:n] = field
    pallas = np.asarray(JK.parse_i32(jnp.asarray(pad), block=JAX_BLOCK,
                                     interpret=True))[:n]
    assert np.array_equal(pallas, np.asarray(JP._parse_i32(
        jnp.asarray(field))))
    return pallas


# n of 1, not a multiple of the 256-row block, and 4096; rows 90 bytes
# (store_sales) and other widths, odd and even
@pytest.mark.parametrize("n,width", [(1, 90), (300, 90), (4096, 90),
                                     (300, 61), (1000, 37), (4096, 128)])
def test_parse_fields_equals_jax_package_and_one_field_decoders(n, width):
    rng = np.random.default_rng(n * 131 + width)
    raw = _rows(n, width, seed=n + width)
    host = torch.from_numpy(raw)
    fields = _fields(rng, width, 6)
    want = [_jax_field(raw, off, w) for off, w in fields]
    for got in (TR.parse_fields_ref(host, fields),
                TK.parse_fields(host, fields), TO.parse_fields(host, fields),
                TP._parse_fields(host, fields)):
        assert len(got) == len(fields)
        for g, w, (off, width_) in zip(got, want, fields):
            one = (TR.parse_i32_ref if width_ == 10 else TR.parse_f32_ref)(
                host[:, off:off + width_])
            assert g.dtype == (torch.int32 if width_ == 10
                               else torch.float32) and g.shape == (n,)
            assert np.array_equal(_bits(g.numpy()), _bits(w)), (off, width_)
            assert np.array_equal(_bits(g.numpy()), _bits(one.numpy()))


def test_parse_fields_reads_views_in_place_and_checks_fields():
    raw = torch.from_numpy(_rows(64, 90, seed=3))
    view = raw[:, 5:77]          # not 16-byte aligned, rows wider
    assert view.stride() == (90, 1)
    fields = [(0, 10), (61, 10), (3, 8)]
    got = TK.parse_fields(view, fields)
    want = TR.parse_fields_ref(raw, [(off + 5, w) for off, w in fields])
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert TK.parse_fields(view, []) == []
    for bad in ([(0, 9)], [(-1, 10)], [(68, 8)]):
        with pytest.raises(ValueError):
            TK.parse_fields(view, bad)


def test_parse_fields_launches_nothing_on_cpu_and_refuses_other_devices():
    before = dict(TK.LAUNCHES)
    TK.parse_fields(torch.from_numpy(_rows(32, 90, seed=4)), [(0, 10)])
    assert TK.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        TK.parse_fields(torch.empty((4, 90), dtype=torch.uint8,
                                    device="meta"), [(0, 10), (10, 8)])
    assert TK.LAUNCHES == before


# ---------------------------------------------------------------------------
# the decoder's word plan, and the kernel's staging and decode over it
# ---------------------------------------------------------------------------
def _field_words(stride: int, fields, rows: int) -> set:
    """Brute force: the 16-byte words that hold a field byte of ``rows``
    rows ``stride`` bytes apart."""
    return {(r * stride + off + k) // 16 for r in range(rows)
            for off, w in fields for k in range(w)}


@pytest.mark.parametrize("stride", [90, 61, 37, 128, 10, 16, 200, 1000])
def test_word_plan_covers_exactly_the_field_words(stride):
    rng = np.random.default_rng(stride)
    width = min(stride, 90)
    for k in (1, 3, 10):
        shift = int(rng.integers(0, 16))     # an unaligned view's base
        fields = [(off + shift, w) for off, w in _fields(rng, width, k)]
        plan = TK.field_word_plan(stride, fields)
        rows = plan.period_rows
        assert rows == 16 // math.gcd(stride, 16)
        assert rows * stride == 16 * plan.period_words
        # the staged words are exactly those that hold a field byte
        assert list(plan.words) == sorted(_field_words(stride, fields, rows))
        # each (row, field) starts where its bytes are, and its bytes
        # are contiguous in the packed words
        for j in range(rows):
            for f, (off, w) in enumerate(fields):
                at = plan.at[j * len(fields) + f]
                first = j * stride + off
                assert 16 * plan.words[at // 16] + at % 16 == first
                last = (first + w - 1) // 16
                assert plan.words[at // 16 + last - first // 16] == last


def test_field_groups_keep_each_launch_within_its_plan():
    fields = tuple((k * 200, 10) for k in range(40))
    groups = TK._field_groups(8001, fields)     # odd: a 16-row period
    assert [g[0] for g in groups] == sorted(g[0] for g in groups)
    assert groups[0][0] == 0 and groups[-1][1] == 40
    for start, stop, plan in groups:
        assert 1 <= stop - start <= TK.MAX_FIELDS
        assert len(plan.words) <= TK._MAX_PLAN_WORDS
        assert plan == TK.field_word_plan(8001, fields[start:stop])
    one = TK._field_groups(90, ((40, 10),))
    assert len(one) == 1 and len(one[0][2].words) <= 32
    zero = TK.field_word_plan(0, [(3, 10)])      # every row the same bytes
    assert (zero.period_rows, zero.period_words) == (1, 0)


def _kernel_model(raw: np.ndarray, fields, lo_pad: int = 0):
    """csrc/csv_parse.cu in numpy: the rows (a view's bytes inside a flat
    allocation, ``lo_pad`` bytes in) are split into runs of whole
    periods as the launch sizes them; each run's planned words are
    staged packed (bytes outside the allocation read as 0), and each
    (row, field) is decoded from the packed words at its plan offset."""
    n, width = raw.shape
    mem = np.zeros(lo_pad + raw.size + 5, np.uint8)
    lo, hi = lo_pad, lo_pad + raw.size
    mem[lo:hi] = raw.reshape(-1)
    base, shift = lo & ~15, lo & 15          # the view starts at lo
    stride = width
    plan = TK.field_word_plan(stride, [(o + shift, w) for o, w in fields])
    pw = 16 * len(plan.words)
    periods = max(1, min(24 * 1024 // pw, 1024 // plan.period_rows))
    run_rows = periods * plan.period_rows
    outs = [np.zeros(n, np.int32 if w == 10 else np.float32)
            for _, w in fields]
    for r0 in range(0, n, run_rows):
        rows = min(run_rows, n - r0)
        buf = np.zeros((-(-rows // plan.period_rows), pw), np.uint8)
        w0 = r0 // plan.period_rows * plan.period_words
        for per in range(buf.shape[0]):
            for s, w in enumerate(plan.words):
                src = base + (w0 + per * plan.period_words + w) * 16
                for k in range(16):
                    if lo <= src + k < hi:
                        buf[per, 16 * s + k] = mem[src + k]
        for r in range(rows):
            j, per = r % plan.period_rows, r // plan.period_rows
            for f, (_, w) in enumerate(fields):
                at = plan.at[j * len(fields) + f]
                digits = torch.from_numpy(buf[per, at:at + w][None].copy())
                outs[f][r0 + r] = (TR.parse_i32_ref if w == 10
                                   else TR.parse_f32_ref)(digits).numpy()[0]
    return outs


@pytest.mark.parametrize("n,width,lo_pad", [(300, 90, 0), (77, 61, 5),
                                            (40, 37, 3), (1100, 16, 0)])
def test_kernel_model_equals_plain_version(n, width, lo_pad):
    rng = np.random.default_rng(n + width)
    raw = _rows(n, width, seed=n)
    fields = _fields(rng, width, 5 if width > 16 else 1)
    got = _kernel_model(raw, fields, lo_pad)
    want = TR.parse_fields_ref(torch.from_numpy(raw), fields)
    for g, w in zip(got, want):
        assert np.array_equal(_bits(g), _bits(w.numpy()))


# ---------------------------------------------------------------------------
# a CSV scan decodes all of its numeric fields in one call
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("partitioned", [False, True])
def test_csv_scan_decodes_its_numeric_fields_in_one_call(monkeypatch,
                                                         partitioned):
    from repro_torch.relational.partition import Partitioning
    from repro_torch.relational.tpcds import (build_tpcds_session,
                                              generate_tpcds_catalog)

    sess = build_tpcds_session(scale_rows=3_000, fmt="csv", device="cpu")
    if partitioned:
        from repro_torch.relational.datagen import make_storage

        schema, nrows, cols = generate_tpcds_catalog(3_000)["store_sales"]
        storage, typed = make_storage("store_sales", schema, nrows, "csv",
                                      cols=cols)
        sess.register(storage, typed,
                      partitioning=Partitioning("ss_store_sk", "range", 4))
    calls = []
    decode = TP._parse_fields

    def spy(raw, fields):
        calls.append(list(fields))
        return decode(raw, fields)

    monkeypatch.setattr(TP, "_parse_fields", spy)
    names = ("ss_item_sk", "ss_quantity", "ss_wholesale_cost",
             "ss_net_profit")
    t = sess.run_one(sess.table("store_sales").select(*names)).table
    assert len(calls) == 1
    offsets = sess.catalog["store_sales"].schema.csv_offsets()
    assert sorted(calls[0]) == sorted(offsets[n] for n in names)
    # the same columns as the one-field plain versions of the raw rows
    raw = torch.from_numpy(sess.catalog["store_sales"].csv_bytes)
    got = t.to_numpy()
    _, nrows, cols = generate_tpcds_catalog(3_000)["store_sales"]
    for name in names:
        off, w = offsets[name]
        one = (TR.parse_i32_ref if w == 10 else TR.parse_f32_ref)(
            raw[:, off:off + w]).numpy()
        assert np.array_equal(np.sort(_bits(got[name][:t.nrows])),
                              np.sort(_bits(one[:t.nrows])))
    assert np.array_equal(np.sort(got["ss_item_sk"][:t.nrows]),
                          np.sort(cols["ss_item_sk"]))
