"""Flash-decode for Hopper (CUDA C++, ``csrc/decode_attention.cu``).

:func:`decode_attention` launches the kernel for CUDA tensors and runs
the plain torch version in ``ref.py`` only for CPU tensors.  Each
launch adds one to :data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from .. import _build
from .ref import decode_ref

HEAD_DIMS = (32, 64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
_SPLIT_BLOCKS_PER_SM = 2   # split the cache until ~2 blocks per SM

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
            p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, i, i, p, p, p,
            p, p]
        lib.decode_attention_launch.restype = i
        _LIB = lib
    return _LIB


def split_plan(batch: int, hkv: int, s: int, d: int,
               n_sms: int) -> tuple:
    """(n_split, keys_per_split): whole tiles of ``4096 // d`` keys (the
    kernel's ``kTileElems / D``) per split, with enough splits that the
    batch x hkv x n_split blocks give each SM about two."""
    tile = 4096 // d
    n_tiles = -(-s // tile)
    want = max(1, -(-_SPLIT_BLOCKS_PER_SM * n_sms // (batch * hkv)))
    per_split = -(-n_tiles // min(want, n_tiles)) * tile
    return -(-s // per_split), per_split


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
    if (hq // k.shape[1]) * d > 8192:
        raise ValueError("group x head dim exceeds the kernel's 8192")
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
    dev = q.device
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    kv_len = kv_len.to(torch.int32).contiguous()
    scale = sm_scale if sm_scale is not None else 1.0 / (d ** 0.5)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_split, per_split = split_plan(b, hkv, s, d, n_sms)
    part_m = torch.empty((b, hq, n_split), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b, hq, n_split, d), dtype=torch.float32,
                           device=dev)
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(), b,
            hq, hkv, s, d, _DTYPE_CODE[q.dtype],
            -1 if window is None else int(window), float(scale), n_split,
            per_split, part_m.data_ptr(), part_l.data_ptr(),
            part_acc.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error {rc}")
    LAUNCHES["decode_attention"] += 1
    return out
