"""AdamW with float32 master copies for low-precision params (the JAX
package's ``repro.optim.adamw``).

Optimizer state: {"m", "v" (float32 trees like the params), "step" (int32
0-dim tensor), ["master" (float32 copies, only when some param is not
float32)]}.  The update is out of place: new tensors, as in JAX.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils import _pytree as pytree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    master_f32: bool = True


def _f32_like(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def adamw_init(params, cfg: AdamWConfig):
    leaves = pytree.tree_leaves(params)
    device = leaves[0].device if leaves else "cpu"
    state = {"m": pytree.tree_map(_f32_like, params),
             "v": pytree.tree_map(_f32_like, params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    # master copies only for reduced-precision params: a float32 param is
    # its own master
    if cfg.master_f32 and any(l.dtype != torch.float32 for l in leaves):
        state["master"] = pytree.tree_map(
            lambda p: p.detach().to(torch.float32).clone(), params)
    return state


def adamw_update(params, grads, state, lr, cfg: AdamWConfig):
    """One AdamW step: returns (new params, new state).  ``lr`` is a float
    or a 0-dim float32 tensor; moments and the update are float32, the new
    params are cast back to each param's dtype."""
    step = state["step"] + 1
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=stepf.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=stepf.device), stepf)

    def upd(p, g, m, v, master):
        g32 = g.to(torch.float32)
        m = cfg.b1 * m + (1 - cfg.b1) * g32
        v = cfg.b2 * v + (1 - cfg.b2) * g32 * g32
        mh = m / b1c
        vh = v / b2c
        base = master if master is not None else p.to(torch.float32)
        new = base - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                           + cfg.weight_decay * base)
        return new.to(p.dtype), m, v, new

    leaves_p, spec = pytree.tree_flatten(params)
    leaves_g = pytree.tree_leaves(grads)
    leaves_m = pytree.tree_leaves(state["m"])
    leaves_v = pytree.tree_leaves(state["v"])
    leaves_w = pytree.tree_leaves(state["master"]) if "master" in state \
        else [None] * len(leaves_p)
    out = [upd(*a) for a in zip(leaves_p, leaves_g, leaves_m, leaves_v,
                                leaves_w)]
    unf = lambda i: pytree.tree_unflatten([o[i] for o in out], spec)  # noqa: E731
    new_state = {"m": unf(1), "v": unf(2), "step": step}
    if "master" in state:
        new_state["master"] = unf(3)
    return unf(0), new_state
