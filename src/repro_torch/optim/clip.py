"""Global-norm gradient clipping (the JAX package's ``repro.optim.clip``)."""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(leaf^2), each leaf in
    promote(dtype, float32), summed in leaf order."""
    total = None
    for l in pytree.tree_leaves(tree):
        lf = l.to(torch.promote_types(l.dtype, torch.float32))
        sq = torch.sum(lf * lf)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / max(norm, 1e-9)), norm); each
    leaf is scaled in float32 (or float64) and cast back to its dtype."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)

    def one(g):
        acc = torch.promote_types(g.dtype, torch.float32)
        return (g.to(acc) * scale.to(acc)).to(g.dtype)

    return pytree.tree_map(one, grads), norm
