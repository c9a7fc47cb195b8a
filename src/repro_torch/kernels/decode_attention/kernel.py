"""Flash-decode for Hopper (CUDA C++, ``csrc/decode_attention.cu``).

:func:`decode_attention` launches the kernel for CUDA tensors and runs
the plain torch version in ``ref.py`` only for CPU tensors.  One call is
one launch: clusters of :func:`split_plan` CTAs share each batch row's
live keys and combine their partials over distributed shared memory.
Each launch adds one to :data:`LAUNCHES`.  With ``return_lse`` it also
writes each row's log-sum-exp, which lets a caller merge the rows of
several key shards (``ops.py``); without it the kernel writes none.
The kernel reads k and v at their batch and head strides, so a rank's
share of a cache (a view narrowed along heads and slots) is read in
place; :func:`kv_strides` says which layouts it takes, and any other
is copied first.

The launch is also the CUDA implementation of the custom operator
``torch.ops.repro_torch.decode_attention``.  A CUDA tensor takes the
operator while a dispatch mode is active (``FlopCounterMode``, the dry
run's counter), so that the mode sees the kernel as one operator, and
calls the launch directly otherwise: the operator's dispatch costs tens
of microseconds a call on the host, and serving calls this kernel once
an attention layer and token.  A fake tensor (a ``FakeTensorMode``
trace, as the multi-device dry run makes) takes the operator on any
device, and its fake implementation returns an empty output of the
kernel's shape, dtype and device (and a (B, Hq) f32 log-sum-exp, or an
empty one where none is asked for: the operator returns both) and
computes nothing: the trace counts the kernel, not the plain version.
Its flop formula (:func:`decode_flops`) counts 4 D flops per key per batch row and query
head (q K^T and P V, 2 D each) over every slot of the cache, at most
``window`` of them: the live lengths are data, which a formula over
shapes cannot read, so it counts a full cache, as the dry run's decode
cells pass one; a key shard's cache is the shard's slots.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import _get_current_dispatch_mode
from torch.utils.flop_counter import register_flop_formula

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
        ll = ctypes.c_longlong
        lib.decode_attention_launch.argtypes = [
            p, p, p, p, i, i, i, i, ll, ll, i, i, i, ctypes.c_float, i, p, p,
            p]
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
    if q.device.type != "cuda" and not isinstance(q, FakeTensor):
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
                     window: Optional[int] = None, return_lse: bool = False):
    """q: (B, Hq, D); k, v: (B, Hkv, S, D); kv_len: (B,) live lengths.
    Returns (B, Hq, D) in q's dtype; with ``return_lse`` the pair (out,
    lse), lse (B, Hq) f32 in the units of the scaled logits (-inf for a
    row with no live key)."""
    if q.device.type == "cpu" and not isinstance(q, FakeTensor):
        return decode_ref(q, k, v, kv_len, sm_scale=sm_scale, window=window,
                          return_lse=return_lse)
    _check(q, k, v, kv_len)
    scale = sm_scale if sm_scale is not None else 1.0 / (q.shape[2] ** 0.5)
    args = (q, k, v, kv_len, None if window is None else int(window),
            float(scale))
    if isinstance(q, FakeTensor) or _get_current_dispatch_mode() is not None:
        out, lse = _decode_op(*args, return_lse)
        return (out, lse) if return_lse else out
    if return_lse:
        return _decode_both(*args, True)
    return _decode_launch(*args)


def _decode_both(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: torch.Tensor, window: Optional[int],
                 sm_scale: float, return_lse: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The custom operator's function: (out, lse), lse empty unless
    asked for."""
    b, hq = q.shape[:2]
    lse = torch.empty((b, hq) if return_lse else (0,), dtype=torch.float32,
                      device=q.device)
    return _decode_launch(q, k, v, kv_len, window, sm_scale,
                          lse if return_lse else None), lse


def kv_strides(k: torch.Tensor, v: torch.Tensor
               ) -> Optional[Tuple[int, int]]:
    """(batch stride, head stride) in elements at which the kernel reads
    k and v (B, Hkv, S, D) in place, or None where they must be copied
    first: each slot's D elements contiguous and slot after slot, both
    at the same strides, and every row 16 bytes aligned (its vector
    loads).  A view of a contiguous cache narrowed along batch rows,
    heads or slots (a rank's share of a replica) qualifies.  A dim of
    size 1 is never stepped over, so its stride does not count."""
    sb, sh = (0 if k.shape[i] == 1 else k.stride(i) for i in (0, 1))
    size = k.element_size()
    if (k.shape[3] > 1 and k.stride(3) != 1) \
            or (k.shape[2] > 1 and k.stride(2) != k.shape[3]) \
            or any(k.shape[i] > 1 and k.stride(i) != v.stride(i)
                   for i in range(4)) \
            or k.data_ptr() % 16 or v.data_ptr() % 16 \
            or (sb * size) % 16 or (sh * size) % 16:
        return None
    return sb, sh


def _decode_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_len: torch.Tensor, window: Optional[int],
                   sm_scale: float, lse: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """The kernel's launch on checked CUDA tensors; writes ``lse`` (B,
    Hq) f32 when given."""
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    # 16-byte vector loads: q contiguous and aligned; k and v read in
    # place where kv_strides allows
    if not (q.is_contiguous() and q.data_ptr() % 16 == 0):
        q = q.clone(memory_format=torch.contiguous_format)
    strides = kv_strides(k, v)
    if strides is None:
        k, v = (x.clone(memory_format=torch.contiguous_format)
                for x in (k, v))
        strides = (hkv * s * d, s * d)
    if kv_len.dtype != torch.int32:
        kv_len = kv_len.to(torch.int32)
    kv_len = kv_len.contiguous()
    n_split = split_plan(hkv, s, d, _sm_count(q.device))
    out = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(), b,
            hq, hkv, s, *strides, d, _DTYPE_CODE[q.dtype],
            -1 if window is None else window, sm_scale, n_split,
            out.data_ptr(), None if lse is None else lse.data_ptr())
    rc = _build.launch_on(q.device, _lib().decode_attention_launch, args)
    if rc != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error {rc}")
    LAUNCHES["decode_attention"] += 1
    return out


_decode_op = torch.library.custom_op("repro_torch::decode_attention",
                                     _decode_both, mutates_args=(),
                                     device_types="cuda")


@_decode_op.register_fake
def _decode_fake(q, k, v, kv_len, window, sm_scale, return_lse):
    b, hq = q.shape[:2]
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty((b, hq) if return_lse else (0,),
                        dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.decode_attention)
def decode_flops(q_shape, k_shape, v_shape, kv_len_shape, window, sm_scale,
                 return_lse=False, *, out_shape=None, **kwargs) -> int:
    b, hq, d = q_shape
    keys = k_shape[2] if window is None else min(k_shape[2], window)
    return 4 * b * hq * d * keys
