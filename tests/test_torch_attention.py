"""The attention kernels' plain versions against the JAX package.

The same seeded numpy inputs go through the JAX package's Pallas
kernels (interpret mode, as ``tests/test_kernels.py`` runs them on the
CPU) and through the port's kernel wrappers, which on CPU tensors run
their plain torch versions.  Tolerance: f32 throughout, 1e-5 absolute
(both sum in f32 in another order; outputs are averages of unit-normal
values).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.kernel import \
    decode_attention as j_decode
from repro.kernels.flash_attention.kernel import flash_attention as j_flash
from repro_torch.kernels.decode_attention import kernel as DK
from repro_torch.kernels.decode_attention import ops as DO
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ops as FO
from repro_torch.kernels.flash_attention.ref import decode_ref, mha_ref
from torch_parity import one_torch_thread  # noqa: F401

ATOL = 1e-5
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# (B, Hq, Hkv, T, S, D, causal, window, block): T < S puts query row i at
# key position i + S - T; the Pallas kernel needs T and S in whole blocks
FLASH_CASES = [
    (1, 2, 2, 64, 64, 32, True, None, 32),      # group 1
    (2, 4, 2, 64, 128, 32, True, None, 32),     # group 2, offset
    (1, 8, 2, 64, 192, 64, True, None, 64),     # group 4, offset
    (1, 4, 1, 128, 128, 64, True, 48, 64),      # sliding window
    (2, 4, 2, 32, 128, 32, True, 40, 32),       # window + offset
    (1, 4, 4, 64, 64, 64, False, None, 32),     # bidirectional
    (1, 8, 2, 64, 64, 32, False, 24, 32),       # bidirectional window
]


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[f"c{i}" for i in range(len(FLASH_CASES))])
def test_flash_plain_version_matches_the_pallas_kernel(case):
    b, hq, hkv, t, s, d, causal, window, block = case
    q, k, v = _inputs(FLASH_CASES.index(case), (b, hq, t, d),
                      (b, hkv, s, d), (b, hkv, s, d))
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=causal, window=window,
                              block_q=block, block_k=block, interpret=True))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = FK.flash_attention(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # the plain-impl route of ops computes the same thing on the CPU
    plain = FO.attention(tq, tk, tv, causal, window, None, "xla")
    assert torch.equal(plain, got)


# (B, Hq, Hkv, S, D, kv_len, window, block)
DECODE_CASES = [
    (2, 2, 2, 128, 32, (1, 77), None, 64),      # group 1, kv_len 1
    (2, 4, 2, 128, 32, (128, 3), None, 64),     # group 2
    (3, 8, 2, 192, 64, (1, 100, 192), None, 64),  # group 4
    (2, 8, 2, 256, 64, (200, 1), 48, 64),       # window, kv_len 1
    (1, 4, 1, 128, 64, (90,), 16, 32),          # window inside a block
    (2, 4, 4, 64, 32, (64, 33), None, 32),      # full cache
]


@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=[f"c{i}" for i in range(len(DECODE_CASES))])
def test_decode_plain_version_matches_the_pallas_kernel(case):
    b, hq, hkv, s, d, lens, window, block = case
    q, k, v = _inputs(DECODE_CASES.index(case), (b, hq, d),
                      (b, hkv, s, d), (b, hkv, s, d))
    kv_len = np.asarray(lens, np.int32)
    want = np.asarray(j_decode(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(kv_len),
                               window=window, block_k=block,
                               interpret=True))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = DK.decode_attention(tq, tk, tv, torch.from_numpy(kv_len),
                              window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    plain = DO.decode(tq, tk, tv, torch.from_numpy(kv_len), window=window,
                      impl="xla")
    assert torch.equal(plain, got)


@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=[f"c{i}" for i in range(len(DECODE_CASES))])
def test_decode_lse_against_numpy(case):
    """``return_lse``: the log-sum-exp of each row's scaled logits over
    its live keys against numpy's, with the first row's keys all dead
    (kv_len 0: -inf and a zero output); the output is the one without
    it."""
    b, hq, hkv, s, d, lens, window, _ = case
    q, k, v = _inputs(10 + DECODE_CASES.index(case), (b, hq, d),
                      (b, hkv, s, d), (b, hkv, s, d))
    kv_len = np.asarray((0,) + lens[1:], np.int32)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = DK.decode_attention(tq, tk, tv, torch.from_numpy(kv_len),
                                   window=window, return_lse=True)
    assert lse.shape == (b, hq) and lse.dtype == torch.float32
    assert torch.equal(out, DK.decode_attention(
        tq, tk, tv, torch.from_numpy(kv_len), window=window))
    kx = np.repeat(k, hq // hkv, axis=1).astype(np.float64)
    logits = np.einsum("bhd,bhsd->bhs", q.astype(np.float64), kx) / d ** 0.5
    pos = np.arange(s)[None, :]
    live = pos < kv_len[:, None]
    if window is not None:
        live &= pos >= kv_len[:, None] - window
    want = np.full((b, hq), -np.inf)
    for i in range(b):
        if live[i].any():
            x = logits[i][:, live[i]]
            top = x.max(-1, keepdims=True)
            want[i] = np.log(np.exp(x - top).sum(-1)) + top[:, 0]
    np.testing.assert_allclose(lse.numpy(), want, atol=ATOL, rtol=1e-6)
    assert torch.isneginf(lse[0]).all() and not out[0].any()
    assert torch.isfinite(lse[1:]).all()


def test_decode_is_the_last_row_of_causal_attention():
    """One decode step over a cache of n live keys equals the last query
    row of causal attention over those n keys."""
    q, k, v = _inputs(3, (2, 4, 1, 32), (2, 2, 50, 32), (2, 2, 50, 32))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    full = mha_ref(tq, tk, tv, causal=True)[:, :, -1]
    pad = torch.zeros(2, 2, 64, 32)
    pk, pv = pad.clone(), pad.clone()
    pk[:, :, :50], pv[:, :, :50] = tk, tv
    one = decode_ref(tq[:, :, 0], pk, pv, torch.tensor([50, 50]))
    np.testing.assert_allclose(one.numpy(), full.numpy(), atol=ATOL, rtol=0)


def test_bf16_inputs_give_bf16_outputs_in_f32_math():
    q, k, v = _inputs(4, (1, 4, 16, 32), (1, 2, 16, 32), (1, 2, 16, 32))
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got = FK.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    want = mha_ref(tq.float(), tk.float(), tv.float()).bfloat16()
    assert torch.equal(got, want)


def test_wrappers_count_no_launch_on_the_cpu():
    before = (dict(DK.LAUNCHES), dict(FK.LAUNCHES))
    q, k, v = _inputs(5, (1, 2, 8, 32), (1, 2, 8, 32), (1, 2, 8, 32))
    FK.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    DK.decode_attention(torch.from_numpy(q[:, :, 0]), torch.from_numpy(k),
                        torch.from_numpy(v), torch.tensor([8]))
    assert (DK.LAUNCHES, FK.LAUNCHES) == before


def test_decode_split_plan_covers_the_cache():
    """Every live key of the cache falls in exactly one CTA's share of
    the cluster, whatever the shape and the live range, and the cluster
    stays within the kernel's 16."""
    for b, hkv, s, d in ((1, 8, 1024, 128), (2, 2, 300, 32),
                         (1, 1, 64, 256), (4, 8, 17, 64)):
        n_split = DK.split_plan(hkv, s, d, n_sms=132)
        assert 1 <= n_split <= 8
        for lo, hi in ((0, s), (0, 1), (s // 3, s), (max(s - 48, 0), s),
                       (0, 0)):
            hits = [0] * s
            for begin, end in DK.split_ranges(n_split, lo, hi):
                for key in range(begin, end):
                    hits[key] += 1
            assert hits == [int(lo <= key < hi) for key in range(s)]


def test_decode_reads_a_rank_share_of_the_cache_in_place():
    """A rank's share of a contiguous cache, narrowed along batch rows,
    kv heads and slots as the key-split decode narrows its replica, is
    read in place at the cache's batch and head strides (a size-1 dim's
    stride counts for nothing); a layout whose slot rows do not follow
    one another, or k and v at different strides, is copied first."""
    k = torch.zeros(4, 8, 64, 32)
    v = torch.zeros(4, 8, 64, 32)
    assert DK.kv_strides(k, v) == (8 * 64 * 32, 64 * 32)
    head = (k.narrow(1, 3, 1).narrow(2, 16, 16),
            v.narrow(1, 3, 1).narrow(2, 16, 16))
    assert not head[0].is_contiguous()
    assert DK.kv_strides(*head) == (8 * 64 * 32, 0)
    assert DK.kv_strides(k[:1, 2:5, 8:40], v[:1, 2:5, 8:40]) == (0, 64 * 32)
    assert DK.kv_strides(k.transpose(1, 2), v.transpose(1, 2)) is None
    wide = torch.zeros(4, 8, 128, 32).narrow(2, 0, 64)     # v's slots
    assert DK.kv_strides(k, wide) is None
    assert DK.kv_strides(k.narrow(3, 0, 16), v.narrow(3, 0, 16)) is None
