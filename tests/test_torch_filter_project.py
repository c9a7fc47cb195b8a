"""The port's filter-scan kernels module against the JAX package's.

Seeded numpy inputs go through the JAX Pallas kernels (interpret mode)
and the port's wrappers on CPU tensors (which run the plain torch
versions); masks and counts must be exactly equal.  The kernel's
bytecode is held to the program it encodes by decoding it back and by
a numpy interpreter of the kernel's per-row semantics.  int64 beyond
2^53 is held against numpy and ``tests/oracle.py`` (the JAX package's
x64 route does not run in this environment).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from oracle import eval_pred  # noqa: E402
from repro.kernels.filter_project import kernel as JK  # noqa: E402
from repro.kernels.filter_project import ops as JO  # noqa: E402
from repro.relational import expr as JE  # noqa: E402
from repro_torch.kernels.filter_project import kernel as TK  # noqa: E402
from repro_torch.kernels.filter_project import ops as TO  # noqa: E402
from repro_torch.kernels.filter_project import ref as TR  # noqa: E402
from repro_torch.relational import expr as TE  # noqa: E402

CPU = torch.device("cpu")
N, NROWS, BLOCK = 3000, 2711, 512    # N is not a multiple of BLOCK


def _columns(seed: int):
    """i32 / f32 / i32 columns with many equal values (both packages)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(-20, 20, N).astype(np.int32),
            (rng.integers(-20, 20, N) * 0.5).astype(np.float32),
            rng.integers(-20, 20, N).astype(np.int32)]


def _pad(host, block):
    n = ((len(host[0]) + block - 1) // block) * block
    out = []
    for h in host:
        p = np.zeros(n, h.dtype)
        p[: len(h)] = h
        out.append(p)
    return out


def _jax_literal(host, prog):
    cols = tuple(jnp.asarray(c) for c in _pad(host, BLOCK))
    m, c = JK.filter_scan(cols, prog, NROWS, block=BLOCK, interpret=True)
    return np.asarray(m), np.asarray(c)


def _jax_batch(host, prog, ic, fc):
    cols = tuple(jnp.asarray(c) for c in _pad(host, BLOCK))
    m, c = JK.filter_scan_batch(cols, prog, NROWS, jnp.asarray(ic),
                                jnp.asarray(fc), block=BLOCK,
                                interpret=True)
    return np.asarray(m), np.asarray(c)


def _port_cols(host):
    return [torch.from_numpy(c) for c in _pad(host, BLOCK)]


# one case per opcode family; each is a whole program over i32/f32
LITERAL_PROGRAMS = {
    "lt-le-gt-ge": (("lt", 0, 5), ("le", 1, -2.5), ("or",), ("gt", 2, -3),
                    ("ge", 0, -10), ("and",), ("and",)),
    "eq-ne-not": (("eq", 0, 3), ("ne", 1, 0.5), ("not",), ("or",)),
    "fractional-fold": (("lt", 0, 3.5), ("ge", 2, -1.5), ("and",),
                        ("eq", 0, 2.5), ("or",), ("ne", 2, 0.25), ("and",)),
    "fold-to-const": (("gt", 0, 1e12 + 0.5), ("le", 2, -1e12 - 0.5),
                      ("or",)),
    "col-col-mixed": (("ltc", 0, 1), ("gec", 0, 2), ("or",), ("eqc", 1, 2),
                      ("nec", 0, 2), ("and",), ("or",), ("lec", 2, 1),
                      ("gtc", 1, 0), ("and",), ("or",)),
    "in-const": (("in", 0, (3, 4.0, 5.5, 2**40, -7)), ("in", 1, (1.5, 2)),
                 ("or",), ("const", True), ("and",), ("const", False),
                 ("or",)),
}


@pytest.mark.parametrize("name", sorted(LITERAL_PROGRAMS))
def test_literal_program_matches_jax(name):
    prog = LITERAL_PROGRAMS[name]
    host = _columns(1)
    jm, jc = _jax_literal(host, prog)
    tm, tc = TK.filter_scan(_port_cols(host), prog, NROWS, block=BLOCK)
    assert np.array_equal(jm, tm.numpy())
    assert np.array_equal(jc, tc.numpy())
    assert int(tm[NROWS:].sum()) == 0


SLOTTED_PROGRAMS = {
    "i32-slots": ((("gt", 0, ("$i", 0)), ("le", 2, ("$i", 1)), ("and",)),
                  2, 0),
    "f32-slots": ((("ge", 1, ("$f", 0)), ("ne", 1, ("$f", 1)), ("and",),
                   ("eq", 0, ("$i", 0)), ("or",)), 1, 2),
    "slots-and-literals": ((("lt", 0, ("$i", 0)), ("in", 2, (1, 2, 3)),
                            ("or",), ("gtc", 0, 1), ("not",), ("and",),
                            ("ne", 1, 0.0), ("and",)), 1, 0),
}


@pytest.mark.parametrize("n_q", [1, 3, 8])
@pytest.mark.parametrize("name", sorted(SLOTTED_PROGRAMS))
def test_slotted_batch_matches_jax(name, n_q):
    prog, ki, kf = SLOTTED_PROGRAMS[name]
    host = _columns(2)
    rng = np.random.default_rng(n_q)
    ic = rng.integers(-20, 20, (n_q, max(ki, 1))).astype(np.int32)
    fc = (rng.integers(-20, 20, (n_q, max(kf, 1))) * 0.5).astype(np.float32)
    jm, jc = _jax_batch(host, prog, ic, fc)
    tm, tc = TK.filter_scan_batch(_port_cols(host), prog, NROWS,
                                  torch.from_numpy(ic),
                                  torch.from_numpy(fc), block=BLOCK)
    assert np.array_equal(jm, tm.numpy())
    assert np.array_equal(jc, tc.numpy())


def test_filter_mask_batch_pads_like_jax():
    """ops pads unpadded columns to the block and cuts the mask back."""
    host = _columns(3)
    prog, iv, fv = JO.compile_predicate_slots(
        JE.and_(JE.cmp("a", ">", 2), JE.cmp("b", "<", 1.5)), ("a", "b"),
        {"a": "i32", "b": "f32"})
    tprog, tiv, tfv = TO.compile_predicate_slots(
        TE.and_(TE.cmp("a", ">", 2), TE.cmp("b", "<", 1.5)), ("a", "b"),
        {"a": "i32", "b": "f32"})
    assert (prog, iv, fv) == (tprog, tiv, tfv)
    ic, fc = JO.pack_consts([iv, (5,)], [fv, (0.0,)])
    tic, tfc = TO.pack_consts([tiv, (5,)], [tfv, (0.0,)])
    assert np.array_equal(ic, tic) and np.array_equal(fc, tfc)
    jm, jc = JO.filter_mask_batch(
        tuple(jnp.asarray(c) for c in host[:2]), prog, NROWS, ic, fc,
        block=BLOCK, use_pallas=True, interpret=True)
    tm, tc = TO.filter_mask_batch(
        [torch.from_numpy(c) for c in host[:2]], tprog, NROWS, tic, tfc,
        block=BLOCK)
    assert tm.shape == (2, N)
    assert np.array_equal(np.asarray(jm), tm.numpy())
    assert np.array_equal(np.asarray(jc), tc.numpy())


# ---------------------------------------------------------------------------
# the kernel's bytecode
# ---------------------------------------------------------------------------
def _interpret(enc, cols, nrows, ic=None, fc=None):
    """numpy model of the CUDA kernel's per-row semantics: ints compare
    in int64, f32 in f32, the stack is a list of bool rows."""
    n = cols[0].shape[0]
    n_q = 1 if ic is None else ic.shape[0]
    lit_i, lit_f = enc.lit_i.numpy(), enc.lit_f.numpy()
    iv = [c.astype(np.int64) if c.dtype != np.float32 else None
          for c in cols]
    fv = [c.astype(np.float32) for c in cols]
    cmp = [np.less, np.less_equal, np.greater, np.greater_equal, np.equal,
           np.not_equal]
    out = np.zeros((n_q, n), bool)
    for q in range(n_q):
        st = []
        for op, c, a, b in enc.words.numpy().tolist():
            if op == TK.OP_CMP_INT_LIT:
                st.append(cmp[c](iv[a], lit_i[b]))
            elif op == TK.OP_CMP_F32_LIT:
                st.append(cmp[c](fv[a], lit_f[b]))
            elif op == TK.OP_CMP_SLOT_I:
                s = ic[q, b]
                st.append(cmp[c](fv[a], np.float32(s)) if iv[a] is None
                          else cmp[c](iv[a], np.int64(s)))
            elif op == TK.OP_CMP_SLOT_F:
                st.append(cmp[c](fv[a], fc[q, b]))
            elif op == TK.OP_CMP_CC_INT:
                st.append(cmp[c](iv[a], iv[b]))
            elif op == TK.OP_CMP_CC_F32:
                st.append(cmp[c](fv[a], fv[b]))
            elif op == TK.OP_IN_INT:
                st.append(np.isin(iv[a], lit_i[b:b + c]))
            elif op == TK.OP_IN_F32:
                st.append(np.isin(fv[a], lit_f[b:b + c]))
            elif op == TK.OP_CONST:
                st.append(np.full(n, bool(c)))
            elif op == TK.OP_NOT:
                st.append(~st.pop())
            else:
                y, x = st.pop(), st.pop()
                st.append(x & y if op == TK.OP_AND else x | y)
        (m,) = st
        out[q] = m & (np.arange(n) < nrows)
    return out


@pytest.mark.parametrize("name", sorted(LITERAL_PROGRAMS)
                         + sorted(SLOTTED_PROGRAMS))
def test_bytecode_semantics_match_plain_version(name):
    host = _columns(4)
    dtypes = [torch.int32, torch.float32, torch.int32]
    if name in LITERAL_PROGRAMS:
        prog, ic, fc = LITERAL_PROGRAMS[name], None, None
        want = TR.eval_program(prog, [torch.from_numpy(c) for c in host])
        want = (want & (torch.arange(N) < NROWS))[None]
    else:
        prog, ki, kf = SLOTTED_PROGRAMS[name]
        rng = np.random.default_rng(5)
        ic = rng.integers(-20, 20, (3, max(ki, 1))).astype(np.int32)
        fc = (rng.integers(-20, 20, (3, max(kf, 1))) * 0.5).astype(
            np.float32)
        want = TR.eval_program(prog, [torch.from_numpy(c) for c in host],
                               torch.from_numpy(ic), torch.from_numpy(fc))
        want = want & (torch.arange(N) < NROWS)
    enc = TK.encode_program(prog, dtypes, CPU)
    assert np.array_equal(_interpret(enc, host, NROWS, ic, fc),
                          want.numpy())


def test_decode_roundtrips_unfolded_programs():
    dtypes = [torch.int32, torch.float32, torch.int64]
    progs = [
        (("lt", 0, 5), ("ge", 1, 2.5), ("and",), ("ne", 2, 2**60), ("or",)),
        (("gt", 0, ("$i", 0)), ("le", 1, ("$f", 1)), ("not",), ("and",)),
        (("eqc", 0, 1), ("ltc", 2, 0), ("or",), ("in", 2, (2**55, -3)),
         ("and",), ("const", True), ("or",)),
        (("in", 1, (0.5, -1.25)), ("gec", 1, 1), ("and",)),
    ]
    for prog in progs:
        enc = TK.encode_program(prog, dtypes, CPU)
        assert TK.decode_program(enc) == prog


def test_encoder_folds_on_the_host():
    dtypes = [torch.int32, torch.float32]
    enc = TK.encode_program(
        (("lt", 0, 3.5), ("eq", 0, 2.5), ("or",), ("gt", 0, 1e12 + 0.5),
         ("or",), ("in", 0, (1, 2.5, 2**40, 4.0)), ("and",),
         ("lt", 1, 0.1), ("and",)), dtypes, CPU)
    assert TK.decode_program(enc) == (
        ("lt", 0, 4), ("const", False), ("or",), ("const", False),
        ("or",), ("in", 0, (1, 4)), ("and",),
        ("lt", 1, float(np.float32(0.1))), ("and",))


def test_encoder_rejects_what_the_kernel_cannot_run():
    with pytest.raises(OverflowError):
        TK.encode_program((("gt", 0, 2**31),), [torch.int32], CPU)
    deep = tuple(("gt", 0, i) for i in range(65)) + (("and",),) * 64
    with pytest.raises(RuntimeError):
        TK.encode_program(deep, [torch.int32], CPU)
    with pytest.raises(RuntimeError):
        TK.encode_program((("gt", 16, 0),), [torch.int32] * 17, CPU)
    with pytest.raises(RuntimeError):
        TK.encode_program((("gt", 0, 1), ("and",)), [torch.int32], CPU)


# ---------------------------------------------------------------------------
# int64 beyond 2^53, against numpy and the row-wise oracle
# ---------------------------------------------------------------------------
BIG = 2**53


def test_i64_beyond_2_53_is_exact():
    rng = np.random.default_rng(6)
    a = (BIG + rng.integers(-4, 5, 257)).astype(np.int64)
    cols = [torch.from_numpy(a)]
    prog = (("gt", 0, BIG + 1), ("eq", 0, BIG - 3), ("or",),
            ("in", 0, (BIG + 3, BIG + 0.5)), ("or",))
    mask, _ = TK.filter_scan(cols, prog, 257, block=257)
    want = (a > BIG + 1) | (a == BIG - 3) | (a == BIG + 3) | (a == BIG)
    assert np.array_equal(mask.numpy(), want)
    assert np.array_equal(_interpret(TK.encode_program(prog, [torch.int64],
                                                       CPU), [a], 257)[0],
                          want)
    # neighbours that f64 would merge stay apart
    one = torch.tensor([BIG + 1], dtype=torch.int64)
    m1, _ = TK.filter_scan([one], (("gt", 0, BIG),), 1, block=1)
    assert bool(m1[0]) and float(BIG + 1) == float(BIG)


def test_i64_expr_matches_row_oracle():
    rng = np.random.default_rng(7)
    a = (BIG + rng.integers(-5, 6, 300)).astype(np.int64)
    pred = TE.or_(TE.cmp("big", ">=", BIG + 2), TE.cmp("big", "==", BIG - 1),
                  TE.isin("big", (BIG + 1, BIG - 5)),
                  TE.cmp("big", "<", BIG - 3.5))
    got = TE.eval_expr(pred, {"big": torch.from_numpy(a)}).numpy()
    jpred = JE.or_(JE.cmp("big", ">=", BIG + 2),
                   JE.cmp("big", "==", BIG - 1),
                   JE.cmp("big", "==", BIG + 1),
                   JE.cmp("big", "==", BIG - 5),
                   JE.cmp("big", "<", BIG - 4))
    want = [eval_pred(jpred, {"big": int(v)}, None) for v in a]
    assert got.tolist() == want
    prog, _, _ = TO.compile_predicate_slots(pred, ("big",), {"big": "i64"})
    mask, _ = TK.filter_scan([torch.from_numpy(a)], prog, 300, block=300)
    assert mask.numpy().tolist() == want


# ---------------------------------------------------------------------------
# literal casts: the cases where torch and jnp differ by default
# ---------------------------------------------------------------------------
def test_out_of_range_int_literal_raises_like_jax():
    a = np.arange(10, dtype=np.int32)
    with pytest.raises(OverflowError):
        JE.eval_expr(JE.cmp("a", ">", 2**40), {"a": jnp.asarray(a)})
    with pytest.raises(OverflowError):
        TE.eval_expr(TE.cmp("a", ">", 2**40), {"a": torch.from_numpy(a)})
    with pytest.raises(OverflowError):
        TR.eval_program((("gt", 0, 2**40),), [torch.from_numpy(a)])


def test_f32_compare_rounds_the_literal_like_jax():
    """An f32 column compared with a Python float compares in f32."""
    a = np.array([0.1, 0.2, 0.3, 16777217.0, 1e-8], np.float32)
    for op, v in ((">", 0.1), ("<=", 0.3), ("==", 16777217.0),
                  ("!=", 0.2), (">=", 1e-8)):
        want = np.asarray(JE.eval_expr(JE.cmp("x", op, v),
                                       {"x": jnp.asarray(a)}))
        got = TE.eval_expr(TE.cmp("x", op, v), {"x": torch.from_numpy(a)})
        assert np.array_equal(want, got.numpy()), (op, v)
