"""Blocked causal / sliding-window GQA flash attention forward for
Hopper (CUDA C++, ``csrc/flash_attention.cu``).

:func:`flash_attention` launches the kernel for CUDA tensors and runs
the plain torch version in ``ref.py`` only for CPU tensors.  bf16
inputs take the TMA + ``wgmma`` kernel, which reads strided q / k / v
views through tensor maps (no copy where the strides are whole 16-byte
units) and writes the output in q's layout; f32 inputs take the CUDA-core
kernel on contiguous tensors.  Each launch adds one to
:data:`LAUNCHES`.  Forward only: ``ops.attention`` carries the
gradient, through a recompute of the plain version.

The launch is also the CUDA implementation of the custom operator
``torch.ops.repro_torch.flash_attention``.  A CUDA tensor takes the
operator while a dispatch mode is active (``FlopCounterMode``, the dry
run's counter), so that the mode sees the kernel as one operator, and
calls the launch directly otherwise: the operator's dispatch costs tens
of microseconds a call on the host.  A fake tensor (a
``FakeTensorMode`` trace, as the multi-device dry run makes) takes the
operator on any device, and its fake implementation returns an empty
output of the kernel's shape, dtype, device and layout and computes
nothing: the trace counts the kernel, not the plain version.  Its flop formula
(:func:`flash_flops`) counts 4 D flops per (query, key) pair that the
mask keeps, per batch row and query head: Q K^T and P V, 2 D each.  A
causal mask over T = S keeps T (T + 1) / 2 pairs, about half; a window
keeps at most ``window`` keys a query.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import _get_current_dispatch_mode
from torch.utils.flop_counter import register_flop_formula

from .. import _build
from .ref import mha_ref

HEAD_DIMS = (32, 64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

# the library's own error codes, beside CUDA's
_ERRORS = {9001: "cuTensorMapEncodeTiled could not be looked up",
           9002: "cuTensorMapEncodeTiled refused a tensor map"}

LAUNCHES = {"flash_attention": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load(_SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = [
            p, p, p, p, i, i, i, i, i, i, i, i, i, ctypes.c_float, p, p]
        lib.flash_attention_launch.restype = i
        _LIB = lib
    return _LIB


def _check(q, k, v) -> None:
    if q.device.type != "cuda" and not isinstance(q, FakeTensor):
        raise ValueError(f"the kernel runs on CUDA tensors, not "
                         f"{q.device.type}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError("q must be (B, Hq, T, D) and k, v (B, Hkv, S, D)")
    b, hq, t, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[1]:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if t > k.shape[2]:
        raise ValueError(f"T={t} query rows exceed S={k.shape[2]} keys")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype of "
                         f"{list(_DTYPE_CODE)}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must lie on one device")


def _tma_strides(x: torch.Tensor) -> bool:
    """Unit last stride, the other strides in whole 16-byte units."""
    return x.stride(-1) == 1 and all(st % 8 == 0 for st in x.stride()[:-1])


def _tma_ready(x: torch.Tensor) -> bool:
    """Whether a tensor map can describe ``x`` as it is: its strides
    (:func:`_tma_strides`) and its address in whole 16-byte units."""
    return _tma_strides(x) and x.data_ptr() % 16 == 0


def _strides(*xs) -> ctypes.Array:
    """The (batch, head, row) element strides of each tensor.  A size-1
    dim's stride never enters an address, and torch calls a tensor
    contiguous whatever stride it carries there (a single KV head split
    off a projection keeps the row stride), so such a dim reports the
    stride a dense layout gives it, which the f32 kernel's check
    expects."""
    vals = [x.stride(i) if x.shape[i] != 1 else math.prod(x.shape[i + 1:])
            for x in xs for i in range(3)]
    return (ctypes.c_longlong * len(vals))(*vals)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, T, D); k, v: (B, Hkv, S, D); returns (B, Hq, T, D) in
    q's dtype."""
    if q.device.type == "cpu" and not isinstance(q, FakeTensor):
        return mha_ref(q, k, v, causal=causal, window=window,
                       sm_scale=sm_scale)
    _check(q, k, v)
    scale = sm_scale if sm_scale is not None else 1.0 / (q.shape[3] ** 0.5)
    args = (q, k, v, bool(causal), None if window is None else int(window),
            float(scale))
    if isinstance(q, FakeTensor) or _get_current_dispatch_mode() is not None:
        return _flash_op(*args)
    return _flash_launch(*args)


def _flash_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, window: Optional[int], sm_scale: float
                  ) -> torch.Tensor:
    """The kernel's launch on checked CUDA tensors."""
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    if q.dtype == torch.bfloat16:
        q, k, v = (x if _tma_ready(x) else
                   x.clone(memory_format=torch.contiguous_format)
                   for x in (q, k, v))
    else:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), _strides(q, k, v, out),
            b, hq, hkv, t, s, d, _DTYPE_CODE[q.dtype], int(bool(causal)),
            -1 if window is None else window, sm_scale,
            out.data_ptr())
    rc = _build.launch_on(q.device, _lib().flash_attention_launch, args)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: "
                           f"{_ERRORS.get(rc, f'CUDA error {rc}')}")
    LAUNCHES["flash_attention"] += 1
    return out


_flash_op = torch.library.custom_op("repro_torch::flash_attention",
                                    _flash_launch, mutates_args=(),
                                    device_types="cuda")


@_flash_op.register_fake
def _flash_fake(q, k, v, causal, window, sm_scale):
    # the output takes q's layout where the kernel reads q as it is (a
    # fake tensor's address is unknown: taken as aligned)
    if q.dtype == torch.bfloat16 and _tma_strides(q):
        return torch.empty_like(q)
    return q.new_empty(q.shape)


def attended_pairs(t: int, s: int, causal: bool,
                   window: Optional[int]) -> int:
    """The (query, key) pairs the mask keeps: query row i sits at key
    position p = i + S - T and reads keys ``(p - window, p]`` when
    causal, ``(p - window, S)`` otherwise (no lower end without a
    window)."""
    o = s - t
    if causal:
        # query i reads min(p + 1, window) keys, p + 1 = i + o + 1
        return _sum_clamped(o + 1, t, 0, s if window is None else window)
    if window is None:
        return t * s
    # query i reads S - clamp(p - window + 1, 0, S) keys
    return t * s - _sum_clamped(o - window + 1, t, 0, s)


def _sum_clamped(a: int, n: int, lo: int, hi: int) -> int:
    """sum over x in [a, a + n) of min(max(x, lo), hi), for lo <= hi."""
    below = min(max(lo - a, 0), n)
    above = min(max(a + n - 1 - hi, 0), n)
    x0, x1 = max(a, lo), min(a + n - 1, hi)
    middle = (x0 + x1) * (x1 - x0 + 1) // 2 if x0 <= x1 else 0
    return below * lo + above * hi + middle


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def flash_flops(q_shape, k_shape, v_shape, causal, window, sm_scale, *,
                out_shape=None, **kwargs) -> int:
    b, hq, t, d = q_shape
    return 4 * b * hq * d * attended_pairs(t, k_shape[2], causal, window)
