"""Public wrapper for flash-decode (inference only: no gradient)."""
from __future__ import annotations

from typing import Optional

import torch

from .kernel import decode_attention
from .ref import decode_ref


def decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           kv_len: torch.Tensor, *, sm_scale: Optional[float] = None,
           window: Optional[int] = None,
           impl: str = "pallas") -> torch.Tensor:
    """``impl="pallas"`` takes the kernel wrapper; any other impl the
    plain version, except on CUDA tensors, which always launch the
    kernel."""
    if impl == "pallas" or q.device.type == "cuda":
        return decode_attention(q, k, v, kv_len, sm_scale=sm_scale,
                                window=window)
    return decode_ref(q, k, v, kv_len, sm_scale=sm_scale, window=window)
