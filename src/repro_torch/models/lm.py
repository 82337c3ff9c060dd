"""Decoder-only LM over a layer pattern (dense / MoE / SSM / hybrid): GQA,
MLA, Mamba, mLSTM or sLSTM mixers, dense or MoE FFNs, and the VLM's patch
frontend.  (The enc-dec model is ``models/encdec.py``.)

Depth structure: optional prefix layers followed by ``n_repeats`` copies of
the repeating ``pattern`` unit, run by a plain Python loop (the JAX package
scans over stacked unit params).

Parameters: ``{"embed", "final_norm", ["lm_head"], ["frontend"],
["prefix_<i>"], "unit"}`` where ``unit`` is a list of ``n_repeats``
tuples, one layer dict per pattern entry (the JAX package stacks each leaf
over a leading R axis instead; ``params_from_jax`` unstacks it).  Caches likewise:
``{"prefix": [...], "unit": [tuple of per-layer caches] * R}``.

Training modes (``mode="train"``):
  * discrete (default): the residual stack; with ``cfg.remat`` each unit
    runs under one ``torch.utils.checkpoint`` (its activations are
    recomputed in the backward), as the JAX package's ``jax.checkpoint``
    around each scanned unit; a multi-layer unit (jamba's 8-layer block,
    xlstm's 8 blocks) also checkpoints each layer, in node mode too, so a
    unit's backward never holds all its layers' intermediates at once.
  * node mode (``cfg.node.mode == "node"``): the paper: depth becomes ODE
    time, f(x, t) = R * (unit_n(x) - x) with n = floor(t R) clipped to
    [0, R - 1], integrated over [0, 1] by ``cfg.node.method`` on
    ``cfg.node.n_steps`` (default R) steps through ``repro_torch.core.solve``
    with the configured gradient strategy (the symplectic adjoint by
    default).  With method="euler" and n_steps = R this is the discrete
    stack (up to rounding of x + h R (y - x)): step n runs unit n.  The unit
    index is taken as floor(t R + 2^-10), where the JAX package takes
    floor(t R): t_n = n h is computed in the time dtype and can land just
    below n, which there runs unit n - 1 twice and skips unit n at some
    depths (qwen3-0.6b's R = 28 under float64 among them).  The offset is
    far below any stage offset c_i of a tableau and far above the rounding
    of t_n R (R <= 64), so a stage at t_n + c_i h runs unit floor(n + c_i),
    in both time dtypes; for n_steps != R the choice is JAX's up to times
    within 2^-10 / R below a unit boundary.  As in the JAX package the
    prefix layers are not run in node mode.

Tensor parallelism (``lm_forward``'s ``tp``, training only): the
params are the rank's blocks, the lookup and the head are vocab-parallel
(``_embed_tp``; ``train.losses.lm_loss_chunked``), the prefix layers and
the units run on the rank's blocks alike, the patch frontend's output is
joined before the tokens (``_embed_patches_tp``), and under ``seq_carry``
the residual stream, the node-mode solve's state, its checkpoints and its
combines hold the rank's sequence block (1/TP of each).

Serving: ``mode="prefill"`` fills the attention cache buffers in place
(and returns the recurrent layers' new states in the caches) and returns
the logits; ``mode="decode"`` advances one token at position ``pos``.  A
node-mode config serves with the discrete stack (the JAX package takes the
depth solve for training only), so a node-trained checkpoint serves as
it is.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core import SaveAt, as_gradient, solve
from repro_torch.nn.common import dense_init, embed_init
from repro_torch.nn.norm import init_rmsnorm, rmsnorm
from repro_torch.parallel import comm
from .blocks import init_layer, init_layer_cache, layer_forward

_MODES = ("train", "prefill", "decode")


def _check_decoder_only(cfg: ArchConfig):
    if cfg.encdec or cfg.frontend == "audio":
        raise ValueError(
            f"{cfg.name} is an encoder-decoder model (audio frontend): use "
            f"repro_torch.models.encdec")


def init_lm(cfg: ArchConfig, *, seed: int = 0, device="cuda",
            dtype: torch.dtype = torch.float32):
    """Random weights from ``seed``, drawn by a generator on ``device`` (so
    full-width weights are made on the card; a CPU device gives the same
    weights on every machine).  ``device="meta"`` gives the shapes alone,
    allocating nothing."""
    _check_decoder_only(cfg)
    gen = None if torch.device(device).type == "meta" else \
        torch.Generator(device=device).manual_seed(seed)
    params: dict = {
        "embed": embed_init((cfg.vocab, cfg.d_model), dtype, gen, device),
        "final_norm": init_rmsnorm(cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init((cfg.d_model, cfg.vocab), dtype, gen,
                                       device)
    if cfg.frontend == "patch":
        params["frontend"] = dense_init((cfg.d_frontend, cfg.d_model), dtype,
                                        gen, device)
    for i, spec in enumerate(cfg.prefix):
        params[f"prefix_{i}"] = init_layer(gen, spec, cfg, dtype, device)
    params["unit"] = [tuple(init_layer(gen, spec, cfg, dtype, device)
                            for spec in cfg.pattern)
                      for _ in range(cfg.n_repeats)]
    return params


def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                dtype: torch.dtype = torch.bfloat16, device="cuda"):
    """The serving caches: the prefix layers' from ``init_layer_cache``, the
    repeat units' all zeros of the same shapes and dtypes, as the JAX
    package stacks them (so a unit's sLSTM state n starts at 0, not at
    ``init_slstm_state``'s 1e-6)."""
    def zeros(spec):
        return pytree.tree_map(torch.zeros_like, init_layer_cache(
            spec, cfg, batch, max_len, dtype, device))

    return {
        "prefix": [init_layer_cache(s, cfg, batch, max_len, dtype, device)
                   for s in cfg.prefix],
        "unit": [tuple(zeros(s) for s in cfg.pattern)
                 for _ in range(cfg.n_repeats)],
    }


def tensor_from_numpy(a, *, device="cuda",
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A numpy array (or scalar) as a tensor on ``device``, in its own
    dtype unless one is given.  A ``bfloat16`` array (the ``ml_dtypes``
    type that ``np.asarray`` of a JAX bfloat16 leaf gives; numpy and torch
    have no common name for it, so it is recognised by name) keeps its bits:
    it is read as uint16 and viewed as ``torch.bfloat16``, with no round
    trip through float32."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
        return t.to(device=device, dtype=dtype or torch.bfloat16)
    return torch.as_tensor(a, dtype=dtype, device=device)


def params_from_jax(np_tree, cfg: ArchConfig, *, device="cuda",
                    dtype: Optional[torch.dtype] = None):
    """The JAX package's ``init_lm`` params (as numpy arrays, e.g. after
    ``tree_map(np.asarray, params)``) in this package's layout: the stacked
    ``unit`` leaves are split along their leading R axis into a list of R
    per-unit tuples (the MoE experts' (R, E, d, f) leaves become (E, d, f)
    per unit).  ``prefix_<i>``, ``frontend`` and every other leaf keep
    their shapes.  Tensors land on ``device``, in their own dtype unless
    one is given (the float32 router of a float64 model stays float32).
    """
    def to_t(a):
        return tensor_from_numpy(a, device=device, dtype=dtype)

    out = {k: pytree.tree_map(to_t, v) for k, v in np_tree.items()
           if k != "unit"}
    out["unit"] = [tuple(pytree.tree_map(lambda a, r=r: to_t(a[r]), layer)
                         for layer in np_tree["unit"])
                   for r in range(cfg.n_repeats)]
    return out


def _embed(params, cfg: ArchConfig, tokens: torch.Tensor, extra_embeds,
           tp=None):
    """Token embeddings; with the patch frontend and ``extra_embeds`` (B, P,
    d_frontend), the projected patches go before the tokens.  With ``tp``
    the rank's sequence block (``seq_carry``) or the whole."""
    patches = cfg.frontend == "patch" and extra_embeds is not None
    if tp is not None:
        if patches:
            return _embed_patches_tp(params, tokens, extra_embeds, tp)
        return _embed_tp(params["embed"], tokens, tp)
    x = params["embed"][tokens]
    if patches:
        pe = extra_embeds.to(x.dtype) @ params["frontend"]
        x = torch.cat([pe, x], dim=1)
    return x


def _lookup_block(embed: torch.Tensor, tokens: torch.Tensor, tp):
    """The rank's vocab block's part of the lookup: its rows of ``embed``
    for the ids it holds, 0 for the others."""
    lo, hi = tp.vocab_block(embed.shape[0])
    local = tokens - lo
    inside = (local >= 0) & (local < hi - lo)
    x = embed[torch.where(inside, local, torch.zeros_like(local))]
    return x.masked_fill(~inside[..., None], 0)


def _embed_tp(embed: torch.Tensor, tokens: torch.Tensor, tp):
    """The vocab-parallel lookup: ``embed`` is the rank's vocab block; an
    id outside it gives 0, and the blocks' rows are summed over "model"
    (onto the rank's sequence block under ``seq_carry``), which is the
    one-device lookup exactly (one non-zero term per row).  A vocab that
    "model" does not divide leaves ``embed`` whole: the rank's rows of the
    plain lookup, no collective."""
    if not tp.vocab_split:       # the kernels take contiguous rows
        return tp.rows(embed[tokens]).contiguous()
    return tp.leave(_lookup_block(embed, tokens, tp))


def _embed_patches_tp(params, tokens: torch.Tensor, patches: torch.Tensor,
                      tp):
    """The embedding of the patches and the tokens under ``tp``: the
    sequence is P + S long and ``seq_carry`` is decided on it, so both
    parts are made whole on every rank, joined, and the rank takes its
    rows.  The tokens: the vocab blocks' lookups summed (``reduce_from``)
    or the whole vocab's lookup; the patches: through the frontend's
    column blocks joined (``join_columns``).  Under ``seq_carry`` the
    joined sequence's gradient holds the rank's rows alone (partial), so
    the summed lookup's backward sums it too (``copy_to``); without it the
    gradient is whole and alike on every rank."""
    embed = params["embed"]
    if tp.vocab_split:
        x = comm.reduce_from(_lookup_block(embed, tokens, tp), tp.group)
        if tp.seq_carry:
            x = comm.copy_to(x, tp.group)
    else:
        x = embed[tokens]
    pe = patches.to(x.dtype) @ tp.join_columns(params["frontend"])
    return tp.rows(torch.cat([pe, x], dim=1)).contiguous()


def _head_parts(params, cfg: ArchConfig, x: torch.Tensor):
    x = rmsnorm(params["final_norm"], x, eps=cfg.norm_eps,
                use_kernels=cfg.use_kernels)
    head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    return x, head


def _unit_forward(unit, x: torch.Tensor, cfg: ArchConfig, *, caches=None,
                  pos: Optional[int] = None, positions=None, tp=None,
                  aux_group=None):
    """One repeat unit: its pattern's layers in order.  Returns (x, caches,
    aux), aux the sum of its MoE layers' aux losses.  Under ``cfg.remat``
    a multi-layer unit without caches checkpoints each layer when a
    gradient is being taken (the JAX package's per-layer
    ``jax.checkpoint``)."""
    new_caches = []
    aux = 0.0
    per_layer_remat = cfg.remat and len(cfg.pattern) > 1 and \
        caches is None and torch.is_grad_enabled()
    for i, spec in enumerate(cfg.pattern):
        c = None if caches is None else caches[i]
        if per_layer_remat:
            x, nc, a = checkpoint(
                lambda lp, xx, spec=spec: layer_forward(
                    lp, xx, spec, cfg, positions=positions, tp=tp,
                    aux_group=aux_group),
                unit[i], x, use_reentrant=False)
        else:
            x, nc, a = layer_forward(unit[i], x, spec, cfg, cache=c,
                                     pos=pos, positions=positions, tp=tp,
                                     aux_group=aux_group)
        new_caches.append(nc)
        aux = aux + a
    return x, tuple(new_caches), aux


def lm_forward(params, cfg: ArchConfig, tokens: torch.Tensor, *,
               caches=None, pos: Optional[int] = None, extra_embeds=None,
               mode: str = "train", return_hidden: bool = False, tp=None,
               aux_group=None):
    """Returns {"logits", "caches", "aux"} — or, with return_hidden=True,
    {"hidden", "head", "caches", "aux"} so the caller can apply the head to
    the positions it needs (or a chunked loss) without the full (B, S, V)
    logits.

    tokens: (B, S) integer tensor; mode: "train" (no caches; node configs
    run the depth solve), "prefill" (fill ``caches`` from position 0),
    "decode" (tokens (B, 1), write and attend at ``pos``).  With the patch
    frontend, ``extra_embeds`` (B, P, d_frontend) are projected and put
    before the tokens (the sequence is then P + S long); "aux" sums the
    MoE layers' aux losses, the prefix layers' included (0.0 in node mode,
    whose field drops them, as in the JAX package).

    ``tp`` (a ``parallel.tensor.TensorParallel``, training only): the
    params are the rank's blocks; see the module note.  ``aux_group``
    (data-parallel training): the data ranks, over whose rows the MoE aux
    loss runs (``nn.moe.moe_ffn``)."""
    _check_decoder_only(cfg)
    if mode not in _MODES:
        raise ValueError(f"mode {mode!r} not in {_MODES}")
    if (mode == "train") != (caches is None) or \
            (mode == "decode") != (pos is not None):
        raise ValueError(f"mode {mode!r}: caches are required for prefill "
                         f"and decode only, pos for decode only")

    def finish(xf, new_caches, aux):
        h, head = _head_parts(params, cfg, xf)
        if tp is not None and not return_hidden:
            raise ValueError("under tensor parallelism the head is the "
                             "rank's vocab block: ask for return_hidden "
                             "(the loss is vocab-parallel)")
        if return_hidden:
            return {"hidden": h, "head": head, "caches": new_caches,
                    "aux": aux}
        return {"logits": (h @ head).to(torch.float32), "caches": new_caches,
                "aux": aux}

    x = _embed(params, cfg, tokens, extra_embeds, tp)
    if cfg.node.mode == "node" and mode == "train":
        return finish(_node_depth_solve(params, cfg, x, tp), None, 0.0)

    # the whole sequence's positions (x holds the rank's block under
    # seq_carry; the attention runs on the whole sequence)
    seq = x.shape[1] * (tp.size if tp is not None and tp.seq_carry else 1)
    positions = torch.arange(seq, device=x.device) if pos is None else None
    aux = 0.0
    new_prefix = []
    for i, spec in enumerate(cfg.prefix):
        c = None if caches is None else caches["prefix"][i]
        x, nc, a = layer_forward(params[f"prefix_{i}"], x, spec, cfg,
                                 cache=c, pos=pos, positions=positions,
                                 tp=tp, aux_group=aux_group)
        new_prefix.append(nc)
        aux = aux + a
    remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
    new_unit = []
    for r, unit in enumerate(params["unit"]):
        if remat:
            x, ncs, a = checkpoint(
                lambda u, xx: _unit_forward(u, xx, cfg, positions=positions,
                                            tp=tp, aux_group=aux_group),
                unit, x, use_reentrant=False)
        else:
            x, ncs, a = _unit_forward(
                unit, x, cfg, pos=pos, positions=positions,
                caches=None if caches is None else caches["unit"][r], tp=tp,
                aux_group=aux_group)
        new_unit.append(ncs)
        aux = aux + a

    new_caches = None if caches is None else \
        {"prefix": new_prefix, "unit": new_unit}
    return finish(x, new_caches, aux)


# ---------------------------------------------------------------------------
# node mode: depth-time ODE over the repeat units (the paper's technique)
# ---------------------------------------------------------------------------

UNIT_OFFSET = 2.0 ** -10


def depth_unit(t, R: int) -> int:
    """The unit that depth time t runs: floor(t R + 2^-10) clipped to
    [0, R - 1] (see the module note).  Reads t to the host: one read per
    field evaluation when t lies on the card."""
    n = math.floor(float(t) * R + UNIT_OFFSET)
    return min(max(n, 0), R - 1)


def _depth_field(cfg: ArchConfig, tp=None):
    """f(x, t) = R * (unit_n(x) - x), n = ``depth_unit(t, R)``: the
    depth-time vector field shared by the training solve and the
    depth-observation probe (``tp``: on the rank's blocks)."""
    R = cfg.n_repeats

    def field(xs, t, units):
        y, _, _ = _unit_forward(units[depth_unit(t, R)], xs, cfg, tp=tp)
        return (y - xs) * float(R)

    return field


def _node_solve(cfg: ArchConfig, field, x, units, saveat, n_steps: int):
    return solve(field, x, units, saveat=saveat, method=cfg.node.method,
                 gradient=as_gradient(cfg.node.grad_mode), stepping=n_steps,
                 backend=cfg.node.combine_backend).ys


def _node_depth_solve(params, cfg: ArchConfig, x: torch.Tensor, tp=None):
    n_steps = cfg.node.n_steps or cfg.n_repeats
    return _node_solve(cfg, _depth_field(cfg, tp), x, params["unit"],
                       SaveAt(t1=1.0), n_steps)


def node_depth_states(params, cfg: ArchConfig, x: torch.Tensor, depths):
    """Observe the depth-time ODE at interior depths (probing, logit lens).

    ``depths``: increasing observation times in (0, 1] of the depth ODE
    (depth d in [0, n_repeats] is t = d / n_repeats).  Returns the hidden
    states stacked (len(depths), B, S, E) from ONE SaveAt(ts) solve of
    ceil(n_steps / len(depths)) steps per segment, differentiable under
    every gradient strategy (the symplectic adjoint checkpoints each
    segment)."""
    n_steps = cfg.node.n_steps or cfg.n_repeats
    n_obs = len(depths)
    seg_steps = max(1, -(-n_steps // n_obs))
    return _node_solve(cfg, _depth_field(cfg), x, params["unit"],
                       SaveAt(ts=depths), seg_steps)


def node_depth_units(cfg: ArchConfig, dtype: torch.dtype = torch.float32,
                     device="cpu") -> list:
    """The unit index of every field evaluation of the node forward solve,
    in order, from the solver's own time arithmetic (a stand-in field on a
    one-element state of ``dtype``, so no unit runs)."""
    R = cfg.n_repeats
    seen: list = []

    def field(xs, t, _params):
        seen.append(depth_unit(t, R))
        return torch.zeros_like(xs)

    with torch.no_grad():
        solve(field, torch.zeros(1, dtype=dtype, device=device), {},
              saveat=SaveAt(t1=1.0), method=cfg.node.method,
              gradient="backprop", stepping=cfg.node.n_steps or R,
              backend="torch")
    return seen
