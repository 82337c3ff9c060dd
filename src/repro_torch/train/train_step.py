"""Training step factory (the JAX package's ``repro.train.train_step``):
loss -> gradient (any mode) -> compression -> clipping -> AdamW, with
optional microbatch gradient accumulation.

The gradient scheme of a node-mode arch is its ``NodeConfig.grad_mode``
(a registered strategy name or a ``repro_torch.core.GradientStrategy``),
which the LM forward resolves through ``repro_torch.core.solve``.  The
decoder LM is the arch this package trains (with the patch frontend: the
patch positions carry no label); the enc-dec model and the audio frontend
come with ROADMAP queue 1, item 13.  An MoE arch adds its routers' aux
loss to the cross-entropy.

On a mesh (``shard=parallel.make_sharder(mesh)``, or a ``grad_constraint``)
the step is data-parallel and SPMD: ``train.data_parallel`` holds its
collectives (one per gradient leaf, plus the loss and the clip norm), and
``grad_constraint=data_parallel.Zero1(mesh, state)`` makes it ZeRO-1.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs.base import ArchConfig
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


def _check_arch(arch: ArchConfig):
    if arch.encdec or arch.frontend == "audio":
        raise NotImplementedError(
            f"{arch.name}: training the enc-dec model or the audio frontend "
            f"is not ported yet (ROADMAP queue 1, item 13)")


def init_train_state(arch: ArchConfig, tcfg: TrainConfig, *, seed: int = 0,
                     device="cuda") -> TrainState:
    """A fresh ``TrainState`` on ``device``: weights from ``seed`` (see
    ``models.lm.init_lm``), the training generator seeded with seed + 1."""
    _check_arch(arch)
    params = init_lm(arch, seed=seed, device=device,
                     dtype=getattr(torch, tcfg.param_dtype))
    return TrainState(
        params=params, opt=adamw_init(params, tcfg.adamw),
        rng=torch.Generator().manual_seed(seed + 1).get_state(),
        data_step=torch.zeros((), dtype=torch.int32, device=device),
        solver_stats=init_solver_stats(device),
        compress_err=init_error_state(params, tcfg.compression))


def _forward_loss(params, batch, arch: ArchConfig, loss_chunk: int):
    """(cross-entropy + aux loss, cross-entropy); with the patch frontend
    the batch also holds "patch_embeds" (B, P, d_frontend), whose P
    positions take the label IGNORE."""
    rh = loss_chunk > 0
    labels = batch["labels"]
    patches = batch.get("patch_embeds") if arch.frontend == "patch" else None
    out = lm_forward(params, arch, batch["tokens"], extra_embeds=patches,
                     mode="train", return_hidden=rh)
    if patches is not None:
        pad = torch.full(labels.shape[:1] + patches.shape[1:2], IGNORE,
                         dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    if rh:
        loss = lm_loss_chunked(out["hidden"], out["head"], labels,
                               loss_chunk)
    else:
        loss = lm_loss(out["logits"], labels)
    return loss + out["aux"], loss


def loss_and_grads(params, batch, arch: ArchConfig, loss_chunk: int = 512):
    """(total loss, gradient tree like ``params``) of one batch; the params
    are not modified (the gradient is taken on detached copies)."""
    leaves, spec = pytree.tree_flatten(params)
    with torch.enable_grad():
        live = [l.detach().requires_grad_() for l in leaves]
        total, _ = _forward_loss(pytree.tree_unflatten(live, spec), batch,
                                 arch, loss_chunk)
        grads = torch.autograd.grad(total, live, allow_unused=True)
    grads = [torch.zeros_like(l) if g is None else g
             for g, l in zip(grads, leaves)]
    return total.detach(), pytree.tree_unflatten(grads, spec)


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
    mesh))`` for ZeRO-1, or held whole on every rank without it."""
    _check_arch(arch)
    mesh = getattr(shard, "mesh", None) or getattr(grad_constraint, "mesh",
                                                   None)
    if grad_constraint is not None and not isinstance(grad_constraint,
                                                      Zero1):
        raise TypeError("grad_constraint must be a data_parallel.Zero1 "
                        f"(ZeRO-1 over a mesh); got {type(grad_constraint)}")
    if mesh is not None and (tcfg.microbatches > 1
                             or tcfg.compression.mode != "none"):
        raise NotImplementedError(
            "data-parallel training with microbatches or gradient "
            "compression is not ported (one microbatch, no compression)")
    dp = DataParallel(mesh, grad_constraint) if mesh is not None else None
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
        """The data-parallel step (see ``train.data_parallel``)."""
        p_leaves, p_tree = pytree.tree_flatten(state["params"])
        full = [local_tensor(l) for l in p_leaves]
        local, weight = dp.local_batch(batch)
        total, grads = loss_and_grads(pytree.tree_unflatten(full, p_tree),
                                      local, arch, tcfg.loss_chunk)
        loss = dp.loss(total * weight.to(total.dtype))
        grads = pytree.tree_map(lambda g: g * weight.to(g.dtype), grads)
        with torch.no_grad():
            pieces = pytree.tree_leaves(dp.reduce(grads),
                                        is_leaf=lambda x: x is None)
            gnorm = dp.norm(pieces)
            scale = torch.clamp(tcfg.max_grad_norm
                                / torch.clamp(gnorm, min=1e-9), max=1.0)
            lr = lr_fn(local_tensor(state["opt"]["step"]))
            params, opt = dp.update(p_leaves, full, state["opt"], pieces,
                                    scale, lr, tcfg.adamw)
        metrics = {"loss": loss.detach(), "grad_norm": gnorm, "lr": lr}
        return advance(state, pytree.tree_unflatten(params, p_tree), opt,
                       state.get("compress_err"), metrics)

    def train_step(state, batch):
        if dp is not None:
            return dp_step(state, batch)
        params = state["params"]
        if tcfg.microbatches > 1:
            mb = tcfg.microbatches
            g_acc = pytree.tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss_sum = None
            for i in range(mb):
                part = {k: torch.chunk(v, mb, dim=0)[i]
                        for k, v in batch.items()}
                total, g = loss_and_grads(params, part, arch, tcfg.loss_chunk)
                g_acc = pytree.tree_map(lambda a, b: a + b.to(a.dtype),
                                        g_acc, g)
                loss_sum = total if loss_sum is None else loss_sum + total
            grads = pytree.tree_map(lambda g: g / mb, g_acc)
            loss = loss_sum / mb
        else:
            loss, grads = loss_and_grads(params, batch, arch,
                                         tcfg.loss_chunk)

        with torch.no_grad():
            # gradient compression (the JAX package compresses before its
            # data-parallel all-reduce; the port's data-parallel step
            # takes none)
            err = state.get("compress_err")
            comp, new_err = compress_grads(grads, tcfg.compression, err)
            grads = decompress_grads(comp, tcfg.compression)
            grads, gnorm = clip_by_global_norm(grads, tcfg.max_grad_norm)
            lr = lr_fn(state["opt"]["step"])
            params, opt = adamw_update(params, grads, state["opt"], lr,
                                       tcfg.adamw)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return advance(state, params, opt, new_err, metrics)

    return train_step
