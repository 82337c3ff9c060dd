"""Training step factory (the JAX package's ``repro.train.train_step``):
loss -> gradient (any mode) -> compression -> clipping -> AdamW, with
optional microbatch gradient accumulation.

The gradient scheme of a node-mode arch is its ``NodeConfig.grad_mode``
(a registered strategy name or a ``repro_torch.core.GradientStrategy``),
which the LM forward resolves through ``repro_torch.core.solve``.  One
factory serves every arch: decoder LMs (dense / MoE / SSM / hybrid), the
VLM (the patch positions carry no label) and the enc-dec model (the batch
holds the source "frames"; the encoder's memory feeds the decoder's
cross-attention).  An MoE arch adds its routers' aux loss to the
cross-entropy.

On a mesh (``shard=parallel.make_sharder(mesh)``, or a ``grad_constraint``)
the step is data-parallel and SPMD: ``train.data_parallel`` holds its
collectives (one per gradient leaf, plus the loss and the clip norm),
``grad_constraint=data_parallel.Zero1(mesh, state)`` makes it ZeRO-1, and
a "model" axis larger than 1 makes it tensor-parallel as well
(``parallel.tensor``).  Microbatches and compression run on a mesh in
JAX's order (microbatches accumulated, then reduced once, then compress
-> clip -> AdamW).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs.base import ArchConfig
from repro_torch.models.encdec import decode_forward, encode, init_encdec
from repro_torch.models.lm import init_lm, lm_forward
from repro_torch.optim import (AdamWConfig, CompressionConfig, adamw_init,
                               adamw_update, clip_by_global_norm,
                               compress_grads, decompress_grads,
                               init_error_state)
from .data_parallel import DataParallel, Zero1, local_tensor, relay
from .losses import IGNORE, lm_loss, lm_loss_chunked
from .state import (TrainState, generator_from_state, init_solver_stats,
                    node_solver_counts)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    max_grad_norm: float = 1.0
    microbatches: int = 1
    adamw: AdamWConfig = AdamWConfig()
    compression: CompressionConfig = CompressionConfig()
    param_dtype: str = "float32"
    # chunked cross-entropy: never make the (B, S, V) logits; 0 takes the
    # full-logits path
    loss_chunk: int = 512


def init_train_state(arch: ArchConfig, tcfg: TrainConfig, *, seed: int = 0,
                     device="cuda") -> TrainState:
    """A fresh ``TrainState`` on ``device``: weights from ``seed`` (see
    ``models.lm.init_lm``, ``models.encdec.init_encdec``), the training
    generator seeded with seed + 1."""
    init = init_encdec if arch.encdec else init_lm
    params = init(arch, seed=seed, device=device,
                  dtype=getattr(torch, tcfg.param_dtype))
    return TrainState(
        params=params, opt=adamw_init(params, tcfg.adamw),
        rng=torch.Generator().manual_seed(seed + 1).get_state(),
        data_step=torch.zeros((), dtype=torch.int32, device=device),
        solver_stats=init_solver_stats(device),
        compress_err=init_error_state(params, tcfg.compression))


def _forward_loss(params, batch, arch: ArchConfig, loss_chunk: int,
                  tp=None, aux_group=None):
    """(cross-entropy + aux loss, cross-entropy); with the patch frontend
    the batch also holds "patch_embeds" (B, P, d_frontend), whose P
    positions take the label IGNORE; the enc-dec model's holds "frames"
    (B, S_enc, d_frontend).  ``tp``: the rank's tensor-parallel context
    (``parallel.tensor.TensorParallel``), None on one device;
    ``aux_group``: the data ranks whose rows make the batch of the MoE aux
    loss (``models.lm.lm_forward``), None on one device."""
    rh = loss_chunk > 0
    labels = batch["labels"]
    patches = batch.get("patch_embeds") if arch.frontend == "patch" else None
    if arch.encdec:
        # under tensor parallelism the encoder's context is decided on its
        # own length, and the memory entered whole once for every decoder
        # layer's cross-attention
        enc_tp = None if tp is None else \
            tp.for_seq(batch["frames"].shape[1])
        memory = encode(params, batch["frames"], arch, enc_tp)
        if enc_tp is not None:
            memory = enc_tp.enter(memory)
        out = decode_forward(params, arch, batch["tokens"], memory=memory,
                             mode="train", return_hidden=rh, tp=tp)
    else:
        out = lm_forward(params, arch, batch["tokens"], extra_embeds=patches,
                         mode="train", return_hidden=rh, tp=tp,
                         aux_group=aux_group)
    if patches is not None:
        pad = torch.full(labels.shape[:1] + patches.shape[1:2], IGNORE,
                         dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    if rh:
        loss = lm_loss_chunked(out["hidden"], out["head"], labels,
                               loss_chunk, tp=tp)
    else:
        loss = lm_loss(out["logits"], labels)
    return loss + out["aux"], loss


def loss_and_grads(params, batch, arch: ArchConfig, loss_chunk: int = 512,
                   tp=None, aux_group=None, weight=None):
    """(total loss, gradient tree like ``params``) of one batch; the params
    are not modified (the gradient is taken on detached copies).  ``tp``,
    ``aux_group``: as ``_forward_loss``.  ``weight`` (a data rank's share
    of the batch) scales the loss before its gradient is taken, so that a
    term summed over the data ranks (the MoE aux loss's sums) gets the
    ranks' weights in its backward."""
    leaves, spec = pytree.tree_flatten(params)
    with torch.enable_grad():
        live = [l.detach().requires_grad_() for l in leaves]
        total, _ = _forward_loss(pytree.tree_unflatten(live, spec), batch,
                                 arch, loss_chunk, tp, aux_group)
        if weight is not None:
            total = total * weight.to(total.dtype)
        grads = torch.autograd.grad(total, live, allow_unused=True)
    grads = [torch.zeros_like(l) if g is None else g
             for g, l in zip(grads, leaves)]
    return total.detach(), pytree.tree_unflatten(grads, spec)


def _accumulate(mb: int, batch, grads_of):
    """The microbatch loop of both steps: microbatch i is rows [i B / mb,
    (i + 1) B / mb) of ``batch`` (JAX's ``scan`` over ``reshape(mb, B /
    mb)``) and ``grads_of(part)`` its (loss, gradient leaves).  Returns the
    summed loss and gradient leaves: with mb > 1 the gradients accumulate
    in float32, as JAX's do; one microbatch's are returned as they are."""
    if mb == 1:
        return grads_of(batch)
    loss_sum, g_acc = None, None
    for i in range(mb):
        total, g = grads_of({k: torch.chunk(v, mb, dim=0)[i]
                             for k, v in batch.items()})
        loss_sum = total if loss_sum is None else loss_sum + total
        if g_acc is None:
            g_acc = [torch.zeros(x.shape, dtype=torch.float32,
                                 device=x.device) for x in g]
        g_acc = [a + x.to(a.dtype) for a, x in zip(g_acc, g)]
    return loss_sum, g_acc


#: the params keys whose lists hold the units that the JAX package stacks
#: into one leaf per layer leaf (``models.lm.params_from_jax``,
#: ``models.encdec.params_from_jax``)
_STACKED = ("unit", "enc_unit", "dec_unit")


def stack_groups(params) -> list:
    """Per leaf of ``params`` (``tree_leaves`` order), the key of the JAX
    package's leaf it belongs to: its path without the unit index that
    follows a stacked key (``_STACKED``).  The leaves of one key are the
    units of one stacked JAX leaf: int8 compression gives them one scale
    (``optim.compress_grads``)."""
    keys = []
    for path, _ in pytree.tree_flatten_with_path(params)[0]:
        key, skip = [], False
        for e in path:
            if skip:
                skip = False
                continue
            name = getattr(e, "key", getattr(e, "idx", None))
            key.append(name)
            skip = getattr(e, "key", None) in _STACKED
        keys.append(tuple(key))
    return keys


def make_train_step(arch: ArchConfig, tcfg: TrainConfig,
                    lr_fn: Optional[Callable] = None, shard=None,
                    grad_constraint: Optional[Zero1] = None):
    """train_step(state, batch) -> (new state, {"loss", "grad_norm", "lr"})
    with batch {"tokens", "labels"} (B, S) integer tensors on the params'
    device.  The new state's tensors are new (the old state stays valid).

    ``shard`` (``parallel.make_sharder(mesh)``) with a mesh, or a
    ``grad_constraint`` (``data_parallel.Zero1``), makes the step
    data-parallel over the mesh's "data" axis: every rank passes the same
    global batch and takes its rows; the state is laid out by
    ``runtime.reshard_state(state, mesh, parallel.state_specs(state,
    mesh))`` for ZeRO-1, or held whole on every rank without it.  With a
    "model" axis larger than 1 the state must be laid out
    (``state_specs(..., zero1=False)`` without ZeRO-1): each rank computes
    on its model blocks."""
    mesh = getattr(shard, "mesh", None) or getattr(grad_constraint, "mesh",
                                                   None)
    if grad_constraint is not None and not isinstance(grad_constraint,
                                                      Zero1):
        raise TypeError("grad_constraint must be a data_parallel.Zero1 "
                        f"(ZeRO-1 over a mesh); got {type(grad_constraint)}")
    dp = DataParallel(mesh, grad_constraint, arch) if mesh is not None \
        else None
    if lr_fn is None:
        lr_fn = lambda step: torch.full(  # noqa: E731
            (), tcfg.lr, dtype=torch.float32, device=step.device)
    # static forward-solve cost of one train step (node archs)
    solve_steps, solve_fevals = node_solver_counts(arch)
    n_solves = max(tcfg.microbatches, 1)

    def advance(state, params, opt, new_err, metrics):
        if isinstance(state, TrainState):
            # advance every contract field: one draw from the training
            # generator (the step's key, reserved for stochastic layers),
            # the data cursor, the static solve counters
            gen = generator_from_state(local_tensor(state.rng))
            torch.randint(0, 2 ** 62, (1,), generator=gen)
            ss = state.solver_stats

            def bump(leaf, inc):
                return relay(local_tensor(leaf) + inc, leaf)
            stats = {"n_steps": bump(ss["n_steps"], solve_steps * n_solves),
                     "n_fevals": bump(ss["n_fevals"],
                                      solve_fevals * n_solves)}
            return TrainState(params=params, opt=opt,
                              rng=relay(gen.get_state(), state.rng),
                              data_step=bump(state.data_step, 1),
                              solver_stats=stats,
                              compress_err=new_err), metrics
        new_state = {"params": params, "opt": opt}
        if new_err is not None:
            new_state["compress_err"] = new_err
        return new_state, metrics

    def dp_step(state, batch):
        """The data-parallel (and tensor-parallel) step; see
        ``train.data_parallel``."""
        p_leaves, p_tree = pytree.tree_flatten(state["params"])
        local = [local_tensor(l) for l in p_leaves]
        params = pytree.tree_unflatten(local, p_tree)
        batch = {k: local_tensor(v) for k, v in batch.items()}
        tp = dp.tensor_parallel(batch)
        split, partial = dp.roles(state["params"], tp,
                                  dp.source_carry(batch))
        dp.check_layout(p_leaves)
        mb = tcfg.microbatches

        def grads_of(part):         # this rank's rows, weighted n_r,i / N_i
            rows, weight = dp.local_batch(part)
            total, g = loss_and_grads(params, rows, arch, tcfg.loss_chunk,
                                      tp, dp.aux_group, weight)
            return total, pytree.tree_leaves(g)

        loss_sum, g_acc = _accumulate(mb, batch, grads_of)
        loss = dp.loss(loss_sum)

        def mean(leaves):           # the microbatches' mean
            return leaves if mb == 1 else \
                [None if x is None else x / mb for x in leaves]

        with torch.no_grad():
            grads = dp.sum_model(g_acc, partial)
            del g_acc               # held by ``grads`` (or reduced in place)
            err = state.get("compress_err")
            new_err = err
            if tcfg.compression.mode == "none":
                pieces = mean(pytree.tree_leaves(
                    dp.reduce(pytree.tree_unflatten(grads, p_tree)),
                    is_leaf=lambda x: x is None))
            else:
                # compress the reduced (global batch) gradient, JAX's order
                e_leaves, e_tree = pytree.tree_flatten(err)
                comp, e_new = compress_grads(
                    mean(dp.reduce_whole(grads)), tcfg.compression,
                    None if err is None else [local_tensor(e)
                                              for e in e_leaves],
                    leaf_max=None if tp is None else dp.leaf_max,
                    groups=stack_groups(params))
                pieces = dp.pieces(decompress_grads(comp, tcfg.compression))
                if err is not None:
                    new_err = pytree.tree_unflatten(
                        [relay(e, like) for e, like in zip(e_new, e_leaves)],
                        e_tree)
            del grads               # the pieces are what the update takes
            gnorm = dp.norm(pieces, split)
            scale = torch.clamp(tcfg.max_grad_norm
                                / torch.clamp(gnorm, min=1e-9), max=1.0)
            lr = lr_fn(local_tensor(state["opt"]["step"]))
            params, opt = dp.update(p_leaves, local, state["opt"], pieces,
                                    scale, lr, tcfg.adamw)
        metrics = {"loss": (loss if mb == 1 else loss / mb).detach(),
                   "grad_norm": gnorm, "lr": lr}
        return advance(state, pytree.tree_unflatten(params, p_tree), opt,
                       new_err, metrics)

    def train_step(state, batch):
        if dp is not None:
            return dp_step(state, batch)
        params = state["params"]
        mb = tcfg.microbatches

        def grads_of(part):
            total, g = loss_and_grads(params, part, arch, tcfg.loss_chunk)
            return total, pytree.tree_leaves(g)

        loss, leaves = _accumulate(mb, batch, grads_of)
        if mb > 1:
            loss, leaves = loss / mb, [g / mb for g in leaves]
        grads = pytree.tree_unflatten(leaves, pytree.tree_structure(params))
        del leaves                  # the clip's copies replace them

        with torch.no_grad():
            # gradient compression (on a mesh: of the reduced gradient,
            # dp_step)
            err = state.get("compress_err")
            comp, new_err = compress_grads(grads, tcfg.compression, err,
                                           groups=stack_groups(params))
            grads = decompress_grads(comp, tcfg.compression)
            del comp
            grads, gnorm = clip_by_global_norm(grads, tcfg.max_grad_norm)
            lr = lr_fn(state["opt"]["step"])
            params, opt = adamw_update(params, grads, state["opt"], lr,
                                       tcfg.adamw)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return advance(state, params, opt, new_err, metrics)

    return train_step
