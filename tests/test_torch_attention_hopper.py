"""The Hopper attention kernels' arithmetic and plan, on the CPU.

The bf16 forward kernel (``flash_fwd_wgmma_kernel``) computes S = Q K^T
in f32 on tensor cores, runs the online softmax in f32 and rounds P to
bf16 before it multiplies V.  :func:`emulate_wgmma_forward` repeats that
arithmetic in plain torch, tile by tile as the kernel walks the causal /
window band, so the CPU shows that rounding P fits the card check's
bf16 limit (``chip_smoke.ATTN_ATOL``) against ``mha_ref`` at the S1
sweep's shapes, and agrees with the JAX package's Pallas kernel
(interpret mode) on the same seeded inputs.

The decode kernel splits each batch row's live keys over a cluster of
``split_plan`` CTAs and merges their partials in rank order:
:func:`emulate_cluster_decode` repeats that partition and merge, which
must cover every live key once, match ``decode_ref`` (f32, 1e-5 as the
plain versions' parity tests) and give a row the same bits whatever
batch it is served in.
"""
import importlib.util
import inspect
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as j_flash
from repro_torch.kernels.decode_attention import kernel as DK
from repro_torch.kernels.flash_attention.ref import decode_ref, mha_ref
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)
BF16_ATOL = chip_smoke.ATTN_ATOL["torch.bfloat16"]
F32_ATOL = 1e-5
TILE = 64             # the kernel's query rows and keys a tile
LOG2E = 1.4426950408889634


def _row_band(pos, s, causal, window):
    hi = min(pos + 1, s) if causal else s
    lo = max(0, pos - window + 1) if window is not None else 0
    return lo, hi


def emulate_wgmma_forward(q, k, v, *, causal=True, window=None,
                          sm_scale=None):
    """The bf16 kernel's arithmetic: per 64-row query tile, the KV tiles
    of 64 keys from the tile's first band key, f32 scores, base-2 online
    softmax with the row sum in f32, P rounded to bf16, f32 accumulator,
    one division and one rounding to bf16 at the end."""
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = hq // hkv
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    scale = (sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)) \
        * LOG2E
    out = torch.empty(b, hq, t, d, dtype=torch.bfloat16)
    for t0 in range(0, t, TILE):
        rows = torch.arange(t0, min(t0 + TILE, t))
        bands = [_row_band(int(r) + s - t, s, causal, window) for r in rows]
        lo = torch.tensor([x[0] for x in bands])[:, None]
        hi = torch.tensor([x[1] for x in bands])[:, None]
        k_begin, k_end = bands[0][0], bands[-1][1]
        qt = q[:, :, rows].float()
        m = torch.full((b, hq, len(rows), 1), -math.inf)
        l = torch.zeros(b, hq, len(rows), 1)
        acc = torch.zeros(b, hq, len(rows), d)
        for j0 in range(k_begin, k_end, TILE):
            keys = torch.arange(j0, j0 + TILE)
            live = (keys[None] >= lo) & (keys[None] < hi) \
                & (keys[None] < s)
            kk = keys.clamp(max=s - 1)
            sc = torch.einsum("bhrd,bhkd->bhrk", qt, kf[:, :, kk]) * scale
            sc = torch.where(live, sc, -math.inf)
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            m_use = torch.where(m_new == -math.inf, 0.0, m_new)
            alpha = torch.exp2(m - m_use)
            p = torch.exp2(sc - m_use)
            l = l * alpha + p.sum(-1, keepdim=True)
            pb = p.to(torch.bfloat16).float()
            acc = acc * alpha + torch.einsum("bhrk,bhkd->bhrd", pb,
                                             vf[:, :, kk])
            m = m_new
        out[:, :, rows] = (acc / l.clamp(min=1e-30)).to(torch.bfloat16)
    return out


def _bf16(gen, *shape):
    return torch.randn(*shape, generator=gen).to(torch.bfloat16)


# the S1 sweep's forward shapes: (T, S) with ragged tiles and T < S
SWEEP_TS = ((100, 160), (130, 130), (1, 70))
SWEEP_MASKS = ((True, None), (True, 48), (False, None), (False, 48))
SWEEP = [(d, group, ts, mask)
         for d in (32, 64, 128, 256)
         for group in (1, 2, 3, 4, 5) + ((16,) if d == 256 else ())
         for ts in SWEEP_TS for mask in SWEEP_MASKS]


@pytest.mark.parametrize("d,group", sorted({(c[0], c[1]) for c in SWEEP}))
def test_bf16_p_stays_inside_the_card_limit_on_the_sweep(d, group):
    gen = torch.Generator().manual_seed(1000 * d + group)
    hkv = 2
    for t, s in SWEEP_TS:
        q = _bf16(gen, 1, hkv * group, t, d)
        k, v = _bf16(gen, 1, hkv, s, d), _bf16(gen, 1, hkv, s, d)
        for causal, window in SWEEP_MASKS:
            got = emulate_wgmma_forward(q, k, v, causal=causal,
                                        window=window)
            want = mha_ref(q, k, v, causal=causal, window=window)
            err = float((got.float() - want.float()).abs().max())
            assert err <= BF16_ATOL, (t, s, causal, window, err)


@pytest.mark.parametrize("t,s,causal,window", [
    (1024, 1024, True, None),     # the sweep's long causal case
    (64, 1000, True, 200),        # T < S: causal offset and a window
])
def test_bf16_p_stays_inside_the_card_limit_at_granite_heads(t, s, causal,
                                                             window):
    gen = torch.Generator().manual_seed(t + s)
    q = _bf16(gen, 1, 32, t, 128)
    k, v = _bf16(gen, 1, 8, s, 128), _bf16(gen, 1, 8, s, 128)
    got = emulate_wgmma_forward(q, k, v, causal=causal, window=window)
    want = mha_ref(q, k, v, causal=causal, window=window)
    assert float((got.float() - want.float()).abs().max()) <= BF16_ATOL


# (B, Hq, Hkv, T, S, D, causal, window, block) the Pallas kernel takes
JAX_CASES = [
    (1, 4, 2, 128, 128, 64, True, None, 64),
    (1, 8, 2, 64, 192, 128, True, 48, 64),
    (2, 4, 4, 64, 64, 32, False, None, 32),
]


@pytest.mark.parametrize("case", JAX_CASES,
                         ids=[f"c{i}" for i in range(len(JAX_CASES))])
def test_emulation_agrees_with_the_pallas_kernel(case):
    b, hq, hkv, t, s, d, causal, window, block = case
    rng = np.random.default_rng(JAX_CASES.index(case))
    # bf16-representable inputs, so both sides read the same values
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               .to(torch.bfloat16)
               for sh in ((b, hq, t, d), (b, hkv, s, d), (b, hkv, s, d)))
    want = np.asarray(j_flash(*(jnp.asarray(x.float().numpy())
                                for x in (q, k, v)),
                              causal=causal, window=window, block_q=block,
                              block_k=block, interpret=True))
    got = emulate_wgmma_forward(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_ATOL,
                               rtol=0)


def emulate_cluster_decode(q, k, v, kv_len, *, window=None, n_sms=132):
    """The decode kernel's partition and merge: each row's live keys in
    ``split_plan`` shares, a base-2 online-softmax partial per share,
    the partials merged in rank order."""
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = hq // hkv
    n_split = DK.split_plan(hkv, s, d, n_sms)
    scale = LOG2E / math.sqrt(d)
    out = torch.empty_like(q)
    for row in range(b):
        n = min(int(kv_len[row]), s)
        lo = max(0, n - window) if window is not None else 0
        qr = q[row].float().reshape(hkv, g, d)
        parts = []
        for begin, end in DK.split_ranges(n_split, lo, n):
            if end <= begin:
                parts.append((torch.full((hkv, g, 1), -math.inf),
                              torch.zeros(hkv, g, 1),
                              torch.zeros(hkv, g, d)))
                continue
            sc = torch.einsum("hgd,hkd->hgk", qr,
                              k[row, :, begin:end].float()) * scale
            m = sc.amax(-1, keepdim=True)
            p = torch.exp2(sc - m)
            parts.append((m, p.sum(-1, keepdim=True),
                          torch.einsum("hgk,hkd->hgd", p,
                                       v[row, :, begin:end].float())))
        mm = torch.stack([p[0] for p in parts]).amax(0)
        mu = torch.where(mm == -math.inf, 0.0, mm)
        ll, acc = torch.zeros_like(parts[0][1]), torch.zeros_like(
            parts[0][2])
        for m, l, a in parts:
            wt = torch.exp2(m - mu)
            ll, acc = ll + l * wt, acc + a * wt
        out[row] = (acc / ll.clamp(min=1e-30)).reshape(hq, d).to(q.dtype)
    return out


def test_split_plan_reads_no_batch_and_keeps_the_cluster_portable():
    assert list(inspect.signature(DK.split_plan).parameters) == \
        ["hkv", "s", "d", "n_sms"]
    for hkv in (1, 2, 8, 32, 128):
        for s in (1, 17, 300, 1024, 8192):
            for d in DK.HEAD_DIMS:
                for n_sms in (132, 114, 8):
                    n = DK.split_plan(hkv, s, d, n_sms)
                    assert 1 <= n <= DK.MAX_CLUSTER <= 8
                    assert n & (n - 1) == 0
                    # no more CTAs than fill the SMs at batch 1, and no
                    # more shares than a full cache has minimum shares
                    min_keys = DK._MIN_SPLIT_BYTES // (4 * d)
                    assert n == 1 or (n <= n_sms // hkv
                                      and n <= -(-s // min_keys))


@pytest.mark.parametrize("n_split", [1, 2, 3, 4, 8])
def test_split_ranges_cover_every_live_key_once(n_split):
    for s in (1, 5, 64, 300, 1024):
        for lo, hi in ((0, s), (0, 1), (s // 2, s), (max(0, s - 7), s),
                       (0, 0), (3, 3)):
            ranges = DK.split_ranges(n_split, lo, hi)
            assert len(ranges) == n_split
            hits = [0] * (s + 1)
            for begin, end in ranges:
                for key in range(begin, end):
                    hits[key] += 1
            assert hits == [int(lo <= key < hi) for key in range(s + 1)]
            starts = [b for b, e in ranges if e > b]
            assert starts == sorted(starts)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 48])
def test_cluster_merge_matches_decode_ref_and_ignores_the_batch(dtype,
                                                                window):
    rng = np.random.default_rng(7)
    b, hq, hkv, s, d = 8, 16, 4, 1024, 64
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               .to(dtype) for sh in ((b, hq, d), (b, hkv, s, d),
                                     (b, hkv, s, d)))
    lens = torch.tensor([1, 37, 128, 257, 300, 511, 777, 1024])
    got = emulate_cluster_decode(q, k, v, lens, window=window)
    want = decode_ref(q.float(), k.float(), v.float(), lens,
                      window=window)
    atol = F32_ATOL if dtype == torch.float32 else BF16_ATOL
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               atol=atol, rtol=0)
    for row in range(b):
        alone = emulate_cluster_decode(q[row:row + 1], k[row:row + 1],
                                       v[row:row + 1], lens[row:row + 1],
                                       window=window)
        assert torch.equal(alone, got[row:row + 1])


def test_flash_strides_of_size_one_dims_are_dense():
    """The f32 kernel takes dense (B, H, rows, D) blocks and checks the
    strides it is given.  A single KV head split off a projection (the
    shape recurrentgemma's local layers give) is contiguous to torch with
    the row stride on its head dim: the wrapper reports the dense stride
    there, and what a strided multi-head view reports is its own."""
    from repro_torch.kernels.flash_attention.kernel import _strides

    b, t, d = 2, 40, 32
    k = torch.zeros(b, t, d).reshape(b, t, 1, d).transpose(1, 2)
    assert k.is_contiguous() and k.stride(1) == d
    assert list(_strides(k)) == [t * d, t * d, d]
    q = torch.zeros(1, t, 4 * d).reshape(1, t, 4, d).transpose(1, 2)
    assert list(_strides(q)) == [4 * t * d, d, 4 * d]
    dense = q.contiguous()
    assert list(_strides(dense)) == list(dense.stride()[:3])
