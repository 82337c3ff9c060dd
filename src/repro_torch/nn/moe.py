"""Mixture-of-Experts with sort-based dispatch (the JAX package's
``repro.nn.moe``, MegaBlocks/MaxText style).

Routing is per sequence row: each row's (token, slot) assignments are
sorted by expert (a stable sort, so the rank within an expert follows
(token, slot) order), the first C = max(1, int(S k 1.25 / E)) of each
expert keep a place and the rest are dropped.  Index memory is O(S k) per
row: no (S k, E) one-hot.  Tokens are gathered into (E, B C, d) buffers
and hit ONE batched GEMM per projection (``torch.bmm`` over the experts),
so the compute is that of the capacity buffers, not of every expert on
every token.  The auxiliary load-balance loss is Switch/GShard's.

The return to the tokens is deterministic: each token gathers the outputs
of its own kept slots and sums them over its k slots in slot order (the
JAX package scatter-adds with ``.at[ids].add``, which on the card would be
``index_add_`` with atomics, in an order that changes from run to run).
Two calls give bitwise equal results on any device.

Under tensor parallelism (``tp``, training on a "model" axis) the FFN runs
on the entered, whole sequence, so routing, capacity and the aux loss are
the one-device ones, alike on every rank.  The rank holds the f/TP columns
of every expert (``wg``, ``wu``; the rows of ``wd``: TP-in-expert) or,
from a state laid out by ``parallel.state_specs(..., ep=True)``, E/TP
experts whole (expert parallelism), whose buffers alone it runs (a token's
slot with another rank's expert reads the zero row); the shared expert is
column / row split.  Its output is then a partial sum that the layer's
``leave`` sums over "model".

On a data-parallel step each rank holds some rows of the batch; the aux
loss is the one of the whole batch, as JAX's program computes it: with
``aux_group`` (the data ranks) its token means are sums over every rank's
rows (an all_reduce forward, ``comm.reduce_from``, and backward,
``comm.copy_to``: every rank takes the sums into its own loss).

Initialisation follows the JAX package exactly: the stacked expert weights
``(E, d, f)`` take ``dense_init``'s fan-in from their leading axis (E), and
the router is float32 whatever the params' dtype.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.parallel import comm
from .common import dense_init


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                  # per-expert hidden
    n_experts: int
    top_k: int
    n_shared: int = 0          # deepseek-style always-on shared experts
    shared_d_ff: int = 0       # hidden size of the fused shared expert
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


def capacity(cfg: MoEConfig, seq_len: int) -> int:
    """Slots per expert and sequence row."""
    return max(1, int(seq_len * cfg.top_k * cfg.capacity_factor
                      / cfg.n_experts))


def init_moe(generator: torch.Generator, cfg: MoEConfig,
             dtype: torch.dtype = torch.float32, device="cuda"):
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": dense_init((d, E), torch.float32, generator, device),
        "wg": dense_init((E, d, f), dtype, generator, device),
        "wu": dense_init((E, d, f), dtype, generator, device),
        "wd": dense_init((E, f, d), dtype, generator, device),
    }
    if cfg.n_shared > 0:
        sf = cfg.shared_d_ff or cfg.d_ff * cfg.n_shared
        p["shared"] = {
            "wg": dense_init((d, sf), dtype, generator, device),
            "wu": dense_init((d, sf), dtype, generator, device),
            "wd": dense_init((sf, d), dtype, generator, device),
        }
    return p


def route(p, x: torch.Tensor, cfg: MoEConfig):
    """The router: float32 logits, softmax, top-k, renormalised gates.
    Returns (probs (B, S, E), gate_w (B, S, k), gate_idx (B, S, k))."""
    logits = x.to(torch.float32) @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_idx = torch.topk(probs, cfg.top_k, dim=-1)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_w, gate_idx


def dispatch(gate_idx: torch.Tensor, gate_w: torch.Tensor, E: int, C: int):
    """Per sequence row b, the capacity slots of its (token, slot)
    assignments.  gate_idx, gate_w: (B, S, k).  Returns

      slot (B, S k) int64: e C + rank of each assignment, or E C (dropped);
      slot_token (B, E, C) int64: the token in each slot, or S (empty);
      slot_gate (B, E, C) float32: its combine weight, or 0.

    The rank of an assignment within its expert is its position in a
    stable sort of the row by expert: (token, slot) order."""
    B, S, k = gate_idx.shape
    n = S * k
    dev = gate_idx.device
    flat_e = gate_idx.reshape(B, n).to(torch.int64)
    flat_t = torch.arange(S, device=dev).repeat_interleave(k).expand(B, n)
    flat_w = gate_w.reshape(B, n).to(torch.float32)
    sorted_e, sort_idx = torch.sort(flat_e, dim=-1, stable=True)
    pos = torch.arange(n, device=dev).expand(B, n)
    is_start = torch.ones_like(sorted_e, dtype=torch.bool)
    is_start[:, 1:] = sorted_e[:, 1:] != sorted_e[:, :-1]
    seg_start = torch.cummax(torch.where(is_start, pos, 0), dim=-1).values
    rank = torch.empty_like(flat_e).scatter_(1, sort_idx, pos - seg_start)
    keep = rank < C
    slot = torch.where(keep, flat_e * C + rank, E * C)
    # unique slots but the overflow sentinel E*C, which every dropped
    # assignment writes with the same value, and which is cut off
    slot_token = torch.full((B, E * C + 1), S, dtype=torch.int64,
                            device=dev).scatter_(
        1, slot, torch.where(keep, flat_t, S))[:, :E * C]
    slot_gate = torch.zeros((B, E * C + 1), dtype=torch.float32,
                            device=dev).scatter_(
        1, slot, torch.where(keep, flat_w, 0.0))[:, :E * C]
    return slot, slot_token.reshape(B, E, C), slot_gate.reshape(B, E, C)


def _experts(p, cfg: MoEConfig, tp):
    """(first expert, number of experts) whose buffers this rank runs: all
    of them on one device and under TP-in-expert, the rank's E/TP under
    expert parallelism (the banks' leading dim)."""
    E, held = cfg.n_experts, p["wg"].shape[0]
    if held == E:
        if tp is not None and p["wg"].shape[-1] == cfg.d_ff:
            raise ValueError(
                f"an MoE FFN on a 'model' axis of {tp.size} holds its "
                f"{E} experts whole: neither f {cfg.d_ff} nor E is split")
        return 0, E
    return tp.rank * held, held


def _token_means(probs, gate_idx, E: int, group):
    """The router's mean probabilities and the experts' mean top-k counts
    (each (E,)) over the tokens of every rank of ``group`` (a
    ``parallel.layout.Group``): one all_reduce of their sums and the token
    count, and one of the sums' gradient."""
    counts = F.one_hot(gate_idx, E).to(probs.dtype).sum(dim=(0, 1, 2))
    n = probs.new_full((1,), probs.shape[0] * probs.shape[1])
    sums = comm.copy_to(comm.reduce_from(
        torch.cat([probs.sum(dim=(0, 1)), counts, n]), group), group)
    return sums[:E] / sums[-1], sums[E:2 * E] / sums[-1]


def moe_ffn(p, x: torch.Tensor, cfg: MoEConfig, tp=None, aux_group=None):
    """x: (B, S, d) -> (y (B, S, d), aux_loss float32 scalar).  With ``tp``
    (a ``parallel.tensor.TensorParallel``) x is the whole sequence on every
    rank, p the rank's blocks and y the rank's partial sum (see the module
    note); the aux loss's gradient is 1/TP on each rank (``tp.once``).
    With ``aux_group`` (the data ranks of a data-parallel step) the aux
    loss is the whole batch's."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = capacity(cfg, S)
    probs, gate_w, gate_idx = route(p, x, cfg)

    # aux load-balance loss (GShard/Switch)
    if aux_group is None:
        me = probs.mean(dim=(0, 1))                                # (E,)
        ce = F.one_hot(gate_idx, E).to(torch.float32).sum(2).mean(
            dim=(0, 1))
    else:
        me, ce = _token_means(probs, gate_idx, E, aux_group)
    aux = (cfg.router_aux_weight * E * torch.sum(me * ce)).to(torch.float32)
    if tp is not None:
        aux = tp.once(aux)

    slot, slot_token, slot_gate = dispatch(gate_idx, gate_w, E, C)
    lo, El = _experts(p, cfg, tp)
    # gather the tokens into expert-major buffers (El, B C, d); an empty
    # slot reads row S - 1 and is weighted 0 below
    rows = torch.clamp(slot_token[:, lo:lo + El], max=S - 1) \
        + S * torch.arange(B, device=x.device)[:, None, None]
    xe = x.reshape(B * S, d)[rows.transpose(0, 1).reshape(El, B * C)]
    h = F.silu(torch.bmm(xe, p["wg"])) * torch.bmm(xe, p["wu"])
    ye = torch.bmm(h, p["wd"]).reshape(El, B, C, d).transpose(0, 1)
    ye = ye * slot_gate[:, lo:lo + El, :, None].to(ye.dtype)     # (B,El,C,d)

    # back to the tokens: each gathers its kept slots (a dropped one, or
    # one of another rank's experts, reads the zero row El C) and sums them
    # over its k slots, in slot order
    if El < E:
        mine = (slot >= lo * C) & (slot < (lo + El) * C)
        slot = torch.where(mine, slot - lo * C, El * C)
    flat = torch.cat([ye.reshape(B, El * C, d),
                      ye.new_zeros((B, 1, d))], dim=1)
    y = torch.gather(flat, 1, slot[..., None].expand(B, S * k, d))
    y = y.reshape(B, S, k, d).sum(dim=2)

    if cfg.n_shared > 0:
        sp = p["shared"]
        y = y + (F.silu(x @ sp["wg"]) * (x @ sp["wu"])) @ sp["wd"]
    return y, aux
