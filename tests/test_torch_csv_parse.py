"""The port's CSV-decode kernels module against the JAX package's.

Seeded numpy digit fields go through the JAX package's Pallas
``parse_i32`` (interpret mode), its plain ``parse_i32_ref`` and its
scan's ``_parse_i32`` / ``_parse_f32``, and through the port's wrappers
on CPU tensors (which run the plain torch versions), ``ref.py`` and the
port's scan decoder.  Tolerance: none; every int32 and every f32 bit
pattern must be equal, on the cases the card sweep of ``chip_smoke.py``
holds the CUDA kernels to: 10-digit values past 2^31 (which wrap modulo
2^32), rows of zero bytes (the padding rows past the live count, whose
digits decode as -48), rows of ASCII zeros, fields read as strided views
at odd offsets of a raw row matrix, and row counts that are and are not
a multiple of the kernel's block.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.filter_project import kernel as JK  # noqa: E402
from repro.kernels.filter_project import ref as JR  # noqa: E402
from repro.relational import physical as JP  # noqa: E402
from repro_torch.kernels.filter_project import kernel as TK  # noqa: E402
from repro_torch.kernels.filter_project import ops as TO  # noqa: E402
from repro_torch.kernels.filter_project import ref as TR  # noqa: E402
from repro_torch.relational import physical as TP  # noqa: E402

ROW = 90              # store_sales' CSV row width
I32_OFF, F32_OFF = 3, 17   # odd offsets of the two fields in a row
JAX_BLOCK = 8


def _digits(values: np.ndarray, width: int) -> np.ndarray:
    """Zero-padded ASCII digits of non-negative ``values``."""
    out = np.zeros((len(values), width), np.uint8)
    v = values.astype(np.int64)
    for k in range(width - 1, -1, -1):
        out[:, k] = v % 10 + 48
        v //= 10
    return out


def _raw(n: int, seed: int) -> np.ndarray:
    """An ``(n, ROW)`` raw row matrix: random bytes around a 10-digit
    field (values up to 9,999,999,999) and an 8-digit field; the last
    rows are zero bytes (padding), two rows hold ASCII zeros and two the
    largest values."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (n, ROW)).astype(np.uint8)
    ints = rng.integers(0, 10**10, n)
    ints[:4] = [0, 9_999_999_999, 2**31 - 1, 2**31]
    fracs = rng.integers(0, 10**8, n)
    fracs[:2] = [0, 99_999_999]
    raw[:, I32_OFF:I32_OFF + 10] = _digits(ints, 10)
    raw[:, F32_OFF:F32_OFF + 8] = _digits(fracs, 8)
    raw[-(n // 5):] = 0
    return raw


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _port(raw: np.ndarray):
    t = torch.from_numpy(raw)
    fi, ff = t[:, I32_OFF:I32_OFF + 10], t[:, F32_OFF:F32_OFF + 8]
    assert fi.stride() == (ROW, 1)          # a view, not a copy
    return {
        "i32": [TK.parse_i32(fi), TO.parse_i32(fi), TR.parse_i32_ref(fi),
                TP._parse_fields(fi, [(0, 10)])[0]],
        "f32": [TK.parse_f32(ff), TO.parse_f32(ff), TR.parse_f32_ref(ff),
                TP._parse_fields(ff, [(0, 8)])[0]],
    }


# row counts: a multiple of the JAX kernel's block and of the CUDA
# kernel's 256-thread block, and neither
@pytest.mark.parametrize("n", [512, 1000, 37])
def test_port_parse_equals_jax_package_bitwise(n):
    raw = _raw(n, seed=n)
    fi = np.ascontiguousarray(raw[:, I32_OFF:I32_OFF + 10])
    ff = np.ascontiguousarray(raw[:, F32_OFF:F32_OFF + 8])
    n_pad = -(-n // JAX_BLOCK) * JAX_BLOCK
    fi_pad = np.full((n_pad, 10), 48, np.uint8)
    fi_pad[:n] = fi
    want_i = {
        "pallas": np.asarray(JK.parse_i32(jnp.asarray(fi_pad),
                                          block=JAX_BLOCK,
                                          interpret=True))[:n],
        "ref": np.asarray(JR.parse_i32_ref(jnp.asarray(fi))),
        "scan": np.asarray(JP._parse_i32(jnp.asarray(fi))),
    }
    want_f = np.asarray(JP._parse_f32(jnp.asarray(ff)))
    got = _port(raw)
    for name, w in want_i.items():
        assert w.dtype == np.int32
        for g in got["i32"]:
            assert g.dtype == torch.int32 and g.shape == (n,)
            assert np.array_equal(g.numpy(), w), name
    assert want_f.dtype == np.float32
    for g in got["f32"]:
        assert g.dtype == torch.float32 and g.shape == (n,)
        assert np.array_equal(_bits(g.numpy()), _bits(want_f))


def test_values_past_2_31_wrap_and_padding_rows_decode_as_minus_48():
    raw = _raw(40, seed=1)
    got = _port(raw)
    i32, f32 = got["i32"][0].numpy(), got["f32"][0].numpy()
    assert i32[1] == np.int64(9_999_999_999 - 2**33).astype(np.int32)
    assert i32[2] == 2**31 - 1 and i32[3] == -2**31
    pad = np.int64(-48 * 1_111_111_111) % 2**32
    assert (i32[-8:] == np.int64(pad).astype(np.uint32).astype(np.int32)
            ).all()
    assert f32[0] == 0.0 and f32[1] == np.float32(0.99999999)
    assert (f32[-8:] < 0).all()
    ints = _digits(np.arange(5), 10)
    assert TK.parse_i32(torch.from_numpy(ints)).tolist() == [0, 1, 2, 3, 4]


def test_parse_wrappers_launch_nothing_on_cpu_and_refuse_other_devices():
    before = dict(TK.LAUNCHES)
    _port(_raw(64, seed=2))
    assert TK.LAUNCHES == before
    for fn, w in ((TK.parse_i32, 10), (TK.parse_f32, 8)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(torch.empty((4, w), dtype=torch.uint8, device="meta"))
    assert TK.LAUNCHES == before


def test_csv_scan_decodes_the_columnar_values():
    """A CSV session's scan (both decoders through the port's physical
    scan) returns the typed columns the table was written from."""
    from repro_torch.relational.tpcds import (build_tpcds_session,
                                              generate_tpcds_catalog)

    sess = build_tpcds_session(scale_rows=3_000, fmt="csv", device="cpu")
    _, nrows, cols = generate_tpcds_catalog(3_000)["store_sales"]
    t = sess.run_one(sess.table("store_sales")
                     .select("ss_item_sk", "ss_quantity",
                             "ss_wholesale_cost")).table.to_numpy()
    assert np.array_equal(t["ss_item_sk"], cols["ss_item_sk"])
    assert np.array_equal(t["ss_quantity"], cols["ss_quantity"])
    frac = np.clip(cols["ss_wholesale_cost"].astype(np.float64) * 1e8, 0,
                   99_999_999).astype(np.int64)
    want = TR.parse_f32_ref(torch.from_numpy(_digits(frac, 8))).numpy()
    assert np.array_equal(_bits(t["ss_wholesale_cost"]), _bits(want))
