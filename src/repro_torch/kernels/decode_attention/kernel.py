"""Flash-decode for Hopper (CUDA C++, ``csrc/decode_attention.cu``).

:func:`decode_attention` launches the kernel for CUDA tensors and runs
the plain torch version in ``ref.py`` only for CPU tensors.  One call is
one launch: clusters of :func:`split_plan` CTAs share each batch row's
live keys and combine their partials over distributed shared memory.
Each launch adds one to :data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from .. import _build
from .ref import decode_ref

HEAD_DIMS = (32, 64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
MAX_CLUSTER = 8            # CTAs sharing a row's keys: the portable limit
_MIN_SPLIT_BYTES = 16384   # f32 bytes of K a split should hold at a full cache

LAUNCHES = {"decode_attention": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load(_SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.decode_attention_launch.argtypes = [
            p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, i, p, p]
        lib.decode_attention_launch.restype = i
        _LIB = lib
    return _LIB


def split_plan(hkv: int, s: int, d: int, n_sms: int) -> int:
    """Cluster size ``n_split``: CTAs that share one batch row's live
    keys of one kv head.  Enough that hkv x n_split CTAs fill the SMs at
    batch 1, at most :data:`MAX_CLUSTER`, no more than a full cache of
    ``s`` keys gives ``_MIN_SPLIT_BYTES // (4 d)`` keys each, and a power
    of two.  It reads the cache's shape, never the batch or the live
    lengths, so a row's result does not depend on the batch it is
    served in."""
    min_keys = max(1, _MIN_SPLIT_BYTES // (4 * d))
    want = min(MAX_CLUSTER, max(1, n_sms // hkv), max(1, -(-s // min_keys)))
    return 1 << (want.bit_length() - 1)


def split_ranges(n_split: int, lo: int, hi: int) -> List[Tuple[int, int]]:
    """The key range [begin, end) of each CTA of a cluster over the live
    keys [lo, hi), as the kernel computes it: equal contiguous shares in
    rank order, the last ones short or empty (end <= begin)."""
    per = -(-max(hi - lo, 0) // n_split)
    return [(lo + r * per, min(hi, lo + (r + 1) * per))
            for r in range(n_split)]


_N_SMS: Dict[int, int] = {}


def _sm_count(device: torch.device) -> int:
    idx = torch.cuda.current_device() if device.index is None \
        else device.index
    if idx not in _N_SMS:
        _N_SMS[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _N_SMS[idx]


def _check(q, k, v, kv_len) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, not "
                         f"{q.device.type}")
    if q.ndim != 3 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError("q must be (B, Hq, D) and k, v (B, Hkv, S, D)")
    b, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[1]:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype of "
                         f"{list(_DTYPE_CODE)}")
    if kv_len.shape != (b,) or kv_len.device != q.device \
            or k.device != q.device or v.device != q.device:
        raise ValueError("kv_len must be (B,) and every tensor on one "
                         "device")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor, *,
                     sm_scale: Optional[float] = None,
                     window: Optional[int] = None) -> torch.Tensor:
    """q: (B, Hq, D); k, v: (B, Hkv, S, D); kv_len: (B,) live lengths.
    Returns (B, Hq, D) in q's dtype."""
    if q.device.type == "cpu":
        return decode_ref(q, k, v, kv_len, sm_scale=sm_scale, window=window)
    _check(q, k, v, kv_len)
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    # 16-byte vector loads: contiguous and aligned
    q, k, v = (x if x.is_contiguous() and x.data_ptr() % 16 == 0 else
               x.clone(memory_format=torch.contiguous_format)
               for x in (q, k, v))
    if kv_len.dtype != torch.int32:
        kv_len = kv_len.to(torch.int32)
    kv_len = kv_len.contiguous()
    scale = sm_scale if sm_scale is not None else 1.0 / (d ** 0.5)
    n_split = split_plan(hkv, s, d, _sm_count(q.device))
    out = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(), b,
            hq, hkv, s, d, _DTYPE_CODE[q.dtype],
            -1 if window is None else int(window), float(scale), n_split,
            out.data_ptr())
    rc = _build.launch_on(q.device, _lib().decode_attention_launch, args)
    if rc != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error {rc}")
    LAUNCHES["decode_attention"] += 1
    return out
