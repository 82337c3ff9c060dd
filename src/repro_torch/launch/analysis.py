"""Memory headroom, roofline terms and collective bytes on the H100 (the JAX
package's ``repro.launch.analysis``).

JAX reads its numbers from a compiled HLO module of the TPU pod; the port
has no compiled module, so each helper reads its eager counterpart:

``hbm_headroom``        a peak against the card's memory, read at run time
                        (``torch.cuda.get_device_properties``); on the CPU,
                        ``DEFAULT_DEVICE_BYTES`` (an H100's 80 GB).
``roofline_terms``      the same three terms, with the H100's rates by
                        default (each a keyword, so a caller can pass
                        another card's).
``collective_bytes``    the bytes of every collective's output by kind,
                        from ``parallel.comm.BYTES`` (the HLO parse's
                        counterpart: every collective of the port goes
                        through ``parallel.comm``).
``bf16_upcast_bytes``   the outputs of recorded bf16 -> f32 ``_to_copy``s of
                        at least 128 MiB (an ``analysis.OpRecorder``'s
                        records, in place of the HLO's convert fusions).

Hardware (NVIDIA's data sheet, H100 SXM, dense rates; the card these
figures are used against reads ``NVIDIA H100 80GB HBM3, 700.00 W`` from
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``):
    HBM bandwidth          3.35 TB/s
    float32 (CUDA cores)   67 TFLOP/s
    TF32 (tensor cores)    495 TFLOP/s
    NVLink                 900 GB/s per card, 450 GB/s each way

Roofline terms (seconds, per step, per card):
    compute    = flops / peak_flops
    memory     = bytes / hbm_bw
    collective = collective_bytes / link_bw
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils import _pytree as pytree

__all__ = ["HBM_BW", "F32_PEAK_FLOPS", "TF32_PEAK_FLOPS", "LINK_BW",
           "DEFAULT_DEVICE_BYTES", "device_memory_bytes", "hbm_headroom",
           "roofline_terms", "model_flops_per_step", "count_params",
           "collective_bytes", "bf16_upcast_bytes"]

HBM_BW = 3.35e12             # NVIDIA H100 80GB HBM3, 700.00 W: HBM3
F32_PEAK_FLOPS = 67e12       # NVIDIA H100 80GB HBM3, 700.00 W: float32
TF32_PEAK_FLOPS = 495e12     # NVIDIA H100 80GB HBM3, 700.00 W: TF32, dense
LINK_BW = 450e9              # NVIDIA H100 80GB HBM3, 700.00 W: NVLink, 1 way
DEFAULT_DEVICE_BYTES = 80 * 10**9   # NVIDIA H100 80GB HBM3: 80 GB


def device_memory_bytes(device=None) -> int:
    """The card's memory (``total_memory``), or ``DEFAULT_DEVICE_BYTES``
    for a CPU device or where no card is present."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and torch.cuda.is_available():
        return torch.cuda.get_device_properties(device).total_memory
    return DEFAULT_DEVICE_BYTES


def hbm_headroom(peak_bytes: float, capacity: float = None) -> Dict[str,
                                                                   float]:
    """Fit of a peak on one card: ``capacity`` defaults to
    ``device_memory_bytes()``."""
    if capacity is None:
        capacity = device_memory_bytes()
    frac = peak_bytes / capacity
    return {"hbm_fraction": round(frac, 6), "fits": frac <= 1.0}


def roofline_terms(flops: float, bytes_accessed: float, coll_bytes: float,
                   *, peak_flops: float = F32_PEAK_FLOPS,
                   hbm_bw: float = HBM_BW,
                   link_bw: float = LINK_BW) -> Dict[str, float]:
    terms = {
        "compute_s": flops / peak_flops,
        "memory_s": bytes_accessed / hbm_bw,
        "collective_s": coll_bytes / link_bw,
    }
    dom = max(terms, key=terms.get)
    terms["bottleneck"] = dom.replace("_s", "")
    total = max(terms["compute_s"], terms["memory_s"],
                terms["collective_s"])
    terms["roofline_fraction"] = (terms["compute_s"] / total) \
        if total > 0 else 0.0
    return terms


def model_flops_per_step(n_active_params: float, tokens: float,
                         kind: str) -> float:
    """6ND for training, 2ND for inference forward."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active_params * tokens


def count_params(tree) -> int:
    return sum(l.numel() for l in pytree.tree_leaves(tree)
               if isinstance(l, torch.Tensor))


def collective_bytes() -> Dict[str, int]:
    """Bytes of the collectives' outputs by kind since the last
    ``parallel.comm.reset_counts``."""
    from repro_torch.parallel import comm
    kinds = ("all_reduce", "all_gather", "reduce_scatter", "reduce",
             "broadcast")
    return {k: int(comm.BYTES.get(k, 0)) for k in kinds}


def bf16_upcast_bytes(rec, min_bytes: int = 1 << 27) -> int:
    """Bytes of the whole-tensor bf16 -> f32 casts (>= ``min_bytes`` each)
    an ``analysis.OpRecorder`` recorded."""
    total = 0
    for r in rec.records:
        if r.cast == (torch.bfloat16, torch.float32):
            n = 4 * sum(int(torch.Size(s).numel()) for s in r.out_shapes)
            if n >= min_bytes:
                total += n
    return total
