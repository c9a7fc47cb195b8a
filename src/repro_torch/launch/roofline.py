"""Roofline terms on an NVIDIA H100, with the card's peaks chosen by name.

Three terms per cell, in seconds:

    compute    = FLOPs_per_device / bf16 dense peak
    memory     = bytes_per_device / HBM bandwidth
    collective = collective_bytes_per_device / NVLink bandwidth

The peaks differ between the H100's parts (SXM, PCIe, NVL), so they are
read from :func:`hardware` by the name ``torch.cuda.get_device_name()``
gives, never assumed.  A cell's collective bytes come from the
multi-device dry run (``launch/dryrun.py``), which records every
functional collective its step dispatches on the local shards;
:func:`collective_bytes_from_ops` sums them as the JAX package's
``collective_bytes_from_hlo`` sums the collectives of its partitioned
HLO, under the same op names.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Tuple


@dataclass(frozen=True)
class Hardware:
    """One card's published peaks (dense rates, no sparsity)."""
    part: str
    bf16_flops_per_s: float      # bf16 / fp16 tensor cores, dense
    f32_flops_per_s: float       # float32 outside the tensor cores
    hbm_bytes_per_s: float
    nvlink_bytes_per_s: float    # total NVLink bandwidth a card
    memory_bytes: int


# NVIDIA H100 Tensor Core GPU data sheet: its tensor-core rates are
# given with sparsity, and the dense rate is half of that figure
# (SXM bf16 1,979 TFLOP/s sparse -> 989 dense).  The PCIe part's NVLink
# figure is its bridge's.
_SXM = Hardware("H100 SXM", 989e12, 67e12, 3.35e12, 900e9, 80 * 10 ** 9)
# by a marker in the reported name ("NVIDIA H100 80GB HBM3" is the SXM
# part), the NVL and PCIe parts first
_PARTS = (
    ("NVL", Hardware("H100 NVL", 835e12, 60e12, 3.9e12, 600e9,
                     94 * 10 ** 9)),
    ("PCIe", Hardware("H100 PCIe", 756e12, 51e12, 2.0e12, 600e9,
                      80 * 10 ** 9)),
    ("HBM3", _SXM),
    ("SXM", _SXM),
)


def hardware(name: str) -> Hardware:
    """The peaks of the card named ``name`` (as
    ``torch.cuda.get_device_name()`` reports it, e.g. ``"NVIDIA H100
    80GB HBM3"``).  Raises ValueError for a card not in the table."""
    if "H100" in name:
        for marker, hw in _PARTS:
            if marker in name:
                return hw
    raise ValueError(f"no published peaks for device {name!r}; known "
                     f"parts: {sorted({hw.part for _, hw in _PARTS})}")


# torch's functional collectives (``torch.ops._c10d_functional``) by the
# names the JAX package's HLO gives the same collectives
COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def collective_bytes_from_ops(calls: Iterable[Tuple[str, int]]) -> Dict:
    """``calls``: (op name, bytes of its result on this rank) for each
    functional collective a step dispatched, the op named as in
    ``torch.ops._c10d_functional`` (``all_gather_into_tensor``).
    Returns ``{"total", "by_op", "op_counts"}`` with the JAX package's op
    names (``all-gather``, ``all-reduce``, ``reduce-scatter``,
    ``all-to-all``); a collective outside :data:`COLLECTIVE_OPS` keeps
    its own name, so that nothing is dropped."""
    by_op: Dict[str, int] = {}
    count: Dict[str, int] = {}
    for name, nbytes in calls:
        op = COLLECTIVE_OPS.get(name, name)
        by_op[op] = by_op.get(op, 0) + int(nbytes)
        count[op] = count.get(op, 0) + 1
    return {"total": sum(by_op.values()), "by_op": by_op,
            "op_counts": count}


def summarize_memory(device=None) -> Dict:
    """The CUDA allocator's peak on ``device`` since its last
    ``torch.cuda.reset_peak_memory_stats``; empty for a CPU device,
    which keeps no such count."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return {}
    return {"peak_bytes_per_device_est":
            int(torch.cuda.max_memory_allocated(dev))}


def roofline_terms(cell: Dict, device_name: Optional[str] = None) -> Dict:
    """cell: per-device quantities of one step (FLOPs, bytes,
    collective bytes, chips, active parameters, tokens, step kind).
    The peaks are those of ``device_name``, else of ``cell["device"]``."""
    name = device_name or cell.get("device")
    if not name:
        raise ValueError("roofline_terms needs a device name (argument "
                         "or cell['device'])")
    hw = hardware(name)
    flops = float(cell.get("flops_per_device") or 0.0)
    bytes_ = float(cell.get("bytes_accessed_per_device") or 0.0)
    coll = float(cell.get("collective_bytes_per_device") or 0.0)
    chips = int(cell.get("chips") or 1)

    t_compute = flops / hw.bf16_flops_per_s
    t_memory = bytes_ / hw.hbm_bytes_per_s
    t_coll = coll / hw.nvlink_bytes_per_s
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())

    # MODEL_FLOPS = 6·N_active·D (training) / 2·N_active·D (inference)
    n_active = float(cell.get("params_active") or 0.0)
    tokens = float(cell.get("tokens_per_step") or 0.0)
    mult = 6.0 if cell.get("step_kind") == "train" else 2.0
    model_flops = mult * n_active * tokens
    model_flops_per_dev = model_flops / max(chips, 1)
    useful = model_flops_per_dev / flops if flops else 0.0

    # roofline fraction: useful model FLOPs per device per second at
    # the bound, over peak
    step_time = max(bound, 1e-12)
    mfu = model_flops_per_dev / step_time / hw.bf16_flops_per_s

    return {
        **{k: round(v, 6) for k, v in terms.items()},
        "dominant": dominant.replace("_s", ""),
        "bound_s": round(bound, 6),
        "model_flops_total": model_flops,
        "useful_flops_ratio": round(useful, 4),
        "roofline_fraction_mfu": round(mfu, 4),
        "device": hw.part,
    }
