"""PyTorch port: bfloat16 training (``TrainConfig(param_dtype="bfloat16")``)
and the backward at head dim 160 (stablelm-12b), against the JAX package
on the CPU, at the SMOKE widths.

Bounds, with their reasons:
  * the carry-across of a bfloat16 JAX ``TrainState``: bitwise, in JAX's
    dtypes (bfloat16 params, float32 m, v and masters);
  * one bfloat16 train step (qwen3-0.6b and stablelm-12b, discrete and node
    mode with the symplectic adjoint, euler): loss and grad_norm within
    4e-3 relative, one bfloat16 ulp (2^-8 = 3.9e-3).  Both packages round
    the same activations to bfloat16, at places where their float32 sums
    differ in order, so a gap of an ulp is rounding, not a fault;
  * ``attention_bwd_ref`` at D 160 against ``jax.vjp`` of JAX's
    ``attention_ref``: 1e-12 of the largest entry in float64 (JAX's float32
    casts lifted for the call); in bfloat16 one bfloat16 ulp of the largest
    entry (both round float32 gradients to bfloat16 once; the port's row
    dots read the bfloat16 output, JAX's autodiff the float32 one);
  * the bfloat16 ``rms_norm_bwd_ref`` against ``jax.vjp`` of
    ``rms_norm_ref``: one bfloat16 ulp of the largest entry, for the same
    reason;
  * the dry run's train-cell bytes: equal to the sum over ``jax.eval_shape``
    of JAX's ``init_train_state`` with the same ``TrainConfig``.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

import repro.kernels.ref as jref
from repro.configs import get_arch as j_arch
from repro.configs import get_smoke_arch as j_smoke
from repro.configs.base import NodeConfig as JNodeConfig
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_train_state as j_init_train_state
from repro.train import make_train_step as j_make_train_step
from repro_torch.configs import get_smoke_arch as t_smoke
from repro_torch.configs.base import NodeConfig
from repro_torch.data.tokens import synthetic_lm_batch
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rmsnorm as trms
from repro_torch.launch import dryrun
from repro_torch.train import (TrainConfig, make_train_step,
                               train_state_from_jax)
from torch.utils import _pytree as pytree

STEP_RTOL = 4e-3
F64 = 1e-12


def _lift(module, monkeypatch):
    """Run ``module``'s jnp code with its float32 casts taken to float64."""
    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                     if not k.startswith("__")})
    proxy.float32 = jnp.float64
    monkeypatch.setattr(module, "jnp", proxy)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float64).numpy()
    return np.asarray(np.asarray(t).astype(np.float64))


def _rel(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                1e-300)
    assert err <= tol, f"max |diff| / max |want| = {err:.3e} > {tol}"


def _within_ulp(got, want):
    """max |got - want| within one bfloat16 ulp of the largest |want|
    (2^(e - 7) for a largest entry in [2^e, 2^(e + 1)))."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    top = float(np.abs(want).max())
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    err = float(np.abs(got - want).max())
    assert err <= ulp, f"max |diff| {err:.3e} > ulp {ulp:.3e} of {top:.3e}"


def _bf16_state(arch_id):
    jarch = j_smoke(arch_id)
    jstate = j_init_train_state(jax.random.PRNGKey(0), jarch,
                                JTrainConfig(param_dtype="bfloat16"))
    return jarch, jstate, jax.tree_util.tree_map(np.asarray, jstate)


def _as_int16(a):
    """A bfloat16 numpy array's bits as int16 (other arrays as they are)."""
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("arch_id", ["qwen3-0.6b", "seamless-m4t-medium"])
def test_bf16_state_carry_across_is_bitwise(arch_id):
    """``train_state_from_jax`` of a bfloat16 JAX state: the params keep
    JAX's bfloat16 bits, leaf by leaf (held against the same tree carried
    across as int16 bit patterns, so both go through the same per-unit
    split; the enc-dec model through ``models.encdec.params_from_jax``),
    and AdamW's m, v and masters are float32, JAX's values."""
    _, _, np_state = _bf16_state(arch_id)
    cfg = t_smoke(arch_id)
    tstate = train_state_from_jax(np_state, cfg, device="cpu")
    from repro_torch.models import encdec, lm
    carry = encdec.params_from_jax if cfg.encdec else lm.params_from_jax
    bits = carry(jax.tree_util.tree_map(_as_int16, np_state.params), cfg,
                 device="cpu")
    got, want = (pytree.tree_leaves(t) for t in (tstate.params, bits))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and w.dtype == torch.int16
        assert torch.equal(g.view(torch.int16), w)
    for k in ("m", "v", "master"):
        leaves = pytree.tree_leaves(tstate.opt[k])
        assert {x.dtype for x in leaves} == {torch.float32}, k
        assert sum(x.numel() for x in leaves) == sum(
            x.size for x in jax.tree_util.tree_leaves(np_state.opt[k]))
    master = carry(np_state.opt["master"], cfg, device="cpu")
    for g, w in zip(pytree.tree_leaves(tstate.opt["master"]),
                    pytree.tree_leaves(master)):
        assert torch.equal(g, w)
    # a master is its bfloat16 param, widened
    for p_, m_ in zip(got, pytree.tree_leaves(tstate.opt["master"])):
        assert torch.equal(p_.float(), m_)


@pytest.mark.parametrize("mode", ["discrete", "node_symplectic"])
@pytest.mark.parametrize("arch_id", ["qwen3-0.6b", "stablelm-12b"])
def test_bf16_train_step_matches_jax(arch_id, mode):
    """One train step from JAX's bfloat16 state on a 2 x 32 batch: the
    port's loss and grad_norm against JAX's."""
    jarch, jstate, np_state = _bf16_state(arch_id)
    tarch = t_smoke(arch_id)
    if mode == "node_symplectic":
        jarch = jarch.with_(node=JNodeConfig(mode="node", method="euler",
                                             grad_mode="symplectic"))
        tarch = tarch.with_(node=NodeConfig(mode="node", method="euler",
                                            grad_mode="symplectic"))
    tstate = train_state_from_jax(np_state, tarch, device="cpu")
    nb = synthetic_lm_batch(0, 2, 33, tarch.vocab)
    tb = {k: torch.as_tensor(v, dtype=torch.long) for k, v in nb.items()}
    _, jm = jax.jit(j_make_train_step(
        jarch, JTrainConfig(param_dtype="bfloat16")))(
        jstate, {k: jnp.asarray(v) for k, v in nb.items()})
    ts, tm = make_train_step(tarch, TrainConfig(param_dtype="bfloat16"))(
        tstate, tb)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=STEP_RTOL, err_msg=key)
    assert {str(x.dtype) for x in pytree.tree_leaves(ts.params)} == \
        {"torch.bfloat16"}
    assert {str(x.dtype) for x in pytree.tree_leaves(ts.opt["master"])} == \
        {"torch.float32"}


# (B, H, Hkv, Sq, Sk, D, causal, window, q_offset) at stablelm-12b's head
# dim: causal, and causal with a window
ATTN_D160_CASES = [(1, 4, 2, 64, 64, 160, True, None, 0),
                   (1, 4, 2, 64, 64, 160, True, 16, 0)]


@pytest.mark.parametrize("dtype", ["float64", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_D160_CASES)
def test_attention_bwd_ref_d160_matches_jax(case, dtype, monkeypatch):
    """The flash recurrence at D 160 from (o, lse) against ``jax.vjp`` of
    JAX's ``attention_ref``; in bfloat16 both from the same bfloat16
    inputs, gradients in bfloat16."""
    B, H, Hkv, Sq, Sk, D, causal, window, q_offset = case
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    rng = np.random.default_rng(160)
    q, do = (rng.normal(size=(B, H, Sq, D)) for _ in range(2))
    k, v = (rng.normal(size=(B, Hkv, Sk, D)) for _ in range(2))
    if dtype == "float64":
        _lift(jref, monkeypatch)
        jdt, tdt = jnp.float64, torch.float64
    else:
        jdt, tdt = jnp.bfloat16, torch.bfloat16
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    o, vjp = jax.vjp(lambda a, b, c: jref.attention_ref(a, b, c, **kw),
                     jq, jk, jv)
    want = vjp(jdo)
    tq, tk, tv, tdo, to = (torch.from_numpy(np.asarray(a).astype(np.float64))
                           .to(tdt) for a in (jq, jk, jv, jdo, o))
    lse = tref.attention_lse_ref(tq, tk, **kw)
    got = tref.attention_bwd_ref(tq, tk, tv, to, lse, tdo, **kw)
    for g, w in zip(got, want):
        assert g.dtype == tdt
        if dtype == "float64":
            _rel(g, w, F64)
        else:
            _within_ulp(g, w)


@pytest.mark.parametrize("case", range(3))
def test_rms_norm_bwd_ref_bf16_matches_jax(case):
    """The plain RMSNorm backward on bfloat16 inputs (float32 inside, dx
    and dw rounded to bfloat16) against ``jax.vjp`` of ``rms_norm_ref``, at
    stablelm-12b's d 5120 among others."""
    shape = {0: (6, 16), 1: (4, 5120), 2: (2, 3, 1024)}[case]
    with_res = case != 0
    rng = np.random.default_rng(case)
    x, r, dy = (jnp.asarray(rng.normal(size=shape), jnp.bfloat16)
                for _ in range(3))
    w = jnp.asarray(rng.normal(size=shape[-1:]), jnp.bfloat16)
    args = (x, w) + ((r,) if with_res else ())
    _, vjp = jax.vjp(lambda *a: jref.rms_norm_ref(*a), *args)
    want = vjp(dy)

    def t(a):
        return torch.from_numpy(np.asarray(a).astype(np.float32)).to(
            torch.bfloat16)
    dx, dw, dres = tref.rms_norm_bwd_ref(t(x), t(w),
                                         t(r) if with_res else None, t(dy))
    assert dx.dtype == dw.dtype == torch.bfloat16
    _within_ulp(dx, want[0])
    _within_ulp(dw, want[1])
    if with_res:
        _within_ulp(dres, want[2])


def test_backward_kernels_take_bf16_and_d160():
    """The backward kernels' gates: head dim 160 and bfloat16 pass them (a
    CPU tensor then fails only the device check); float16 does not."""
    tflash.check_bwd_head_dim(160)
    assert 160 in tflash.BWD_HEAD_DIMS
    q = torch.zeros(1, 4, 8, 160, dtype=torch.bfloat16)
    k = torch.zeros(1, 2, 8, 160, dtype=torch.bfloat16)
    lse = torch.zeros(1, 4, 8)
    for dt in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match="CUDA"):
            tflash.flash_attention_bwd(q.to(dt), k.to(dt), k.to(dt), q.to(dt),
                                       lse, q.to(dt))
    with pytest.raises(TypeError, match="not supported"):
        tflash.flash_attention_bwd(*(t.half() for t in (q, k, k, q)), lse,
                                   q.half())
    x = torch.zeros(4, 5120, dtype=torch.bfloat16)
    w = torch.ones(5120, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        trms.rms_norm_bwd(x, w, None, x)
    with pytest.raises(TypeError, match="not supported"):
        trms.rms_norm_bwd(x.half(), w.half(), None, x.half())


@pytest.mark.parametrize("arch_id", ["qwen3-0.6b", "stablelm-12b"])
def test_dryrun_train_cell_bytes_match_jax(arch_id):
    """A train cell's params and optimizer bytes in the port's dry run
    (bfloat16 by default, as JAX's ``run_cell``) against the sum over
    ``jax.eval_shape`` of JAX's ``init_train_state`` with the same
    ``TrainConfig`` (bfloat16 params, float32 m, v and masters)."""
    shapes = jax.eval_shape(
        lambda key: j_init_train_state(key, j_arch(arch_id),
                                       JTrainConfig(param_dtype="bfloat16")),
        jax.random.PRNGKey(0))

    def nbytes(tree):
        return sum(int(np.prod(l.shape)) * np.dtype(l.dtype).itemsize
                   for l in jax.tree_util.tree_leaves(tree))
    parts = dryrun.run_cell(arch_id, "train_4k", device="cpu",
                            verbose=False)["bytes_per_device"]
    assert parts["params"] == parts["grads"] == nbytes(shapes.params)
    assert parts["opt_state"] == nbytes(shapes.opt)
    assert {np.dtype(l.dtype).name
            for l in jax.tree_util.tree_leaves(shapes.opt["master"])} == \
        {"float32"}
