"""Public wrapper for flash attention (forward; the recompute backward
through ``mha_ref`` arrives with the training path)."""
from __future__ import annotations

from typing import Optional

import torch

from .kernel import flash_attention
from .ref import mha_ref


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: Optional[int] = None,
              sm_scale: Optional[float] = None,
              impl: str = "pallas") -> torch.Tensor:
    """``impl="pallas"`` takes the kernel wrapper; any other impl the
    plain version, except on CUDA tensors, which always launch the
    kernel."""
    if impl == "pallas" or q.device.type == "cuda":
        return flash_attention(q, k, v, causal=causal, window=window,
                               sm_scale=sm_scale)
    return mha_ref(q, k, v, causal=causal, window=window, sm_scale=sm_scale)
