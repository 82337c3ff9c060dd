"""Plain PyTorch versions of the CUDA kernels in this package.

They compute what the kernels compute.  The stage combines accumulate in
``promote(x.dtype, float32)`` (float32 for float32/bfloat16/float16
states, float64 for float64 states) in stage order i = 0..s-1; RMSNorm and
attention compute in float32 whatever the input dtype, casting at the same
points as the JAX package's ``repro.kernels.ref``, and return the input's
dtype.  On CPU tensors they ARE the operations (``kernels/ops.py``); on the
card they are the yardstick the kernels are checked against, or what a
caller picks on purpose with ``use_kernels=False``.

``decode_attention_ref`` has no kernel, in the JAX package either: decode
runs it on every device.  ``attention_blocked_ref`` is the plain attention
of long sequences (``kernels/ops.py`` routes to it as the JAX package's
``ops.attention`` does): the same arithmetic as ``attention_ref`` a block
of queries at a time, so that the (Sq, Sk) scores are never whole.

The backward versions (``rms_norm_bwd_ref``, ``attention_bwd_ref``, and
``attention_lse_ref`` for the forward's row log-sum-exp) compute in
``promote(dtype, float32)``: float32 for float32 inputs, float64 for
float64 ones (the exact gradient of the formula; the forwards compute a
float64 input in float32, as the JAX package's references do).  They are
the oracles that the backward kernels are held against; on CPU tensors
autograd differentiates the forward versions instead.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The accumulation dtype of a stage combine over ``dtype`` states."""
    return torch.promote_types(dtype, torch.float32)


def lane_bcast(v: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """A per-lane vector (B,) shaped to broadcast against a lane-batched
    leaf (B, ...); a 0-dim ``v`` becomes all-singleton dims, so one code
    path serves one coefficient row and one row per lane."""
    return v.reshape(v.shape + (1,) * (leaf.dim() - 1))


def butcher_combine_ref(x: torch.Tensor, ks: torch.Tensor, coefs,
                        h) -> torch.Tensor:
    """x + h * sum_i coefs[i] * ks[i], or per lane b (the leading axis of
    x) x[b] + h * sum_i coefs[b, i] * ks[i, b].

    x: (...,), ks: (s, ...), coefs: (s,) or (B, s) with B = x.shape[0].
    Accumulates in promote(x.dtype, float32), strictly in stage order.
    """
    acc_dt = acc_dtype(x.dtype)
    hc = torch.as_tensor(h * coefs).to(acc_dt)
    acc = x.to(acc_dt)
    for i in range(ks.shape[0]):
        acc = acc + lane_bcast(hc[..., i], x) * ks[i].to(acc_dt)
    return acc.to(x.dtype)


def butcher_combine_rows_ref(x: torch.Tensor, ks: torch.Tensor, coefs,
                             base_scale, h) -> torch.Tensor:
    """Multi-row combine: out[r] = base_scale[r]*x + h*sum_i coefs[r,i]*ks[i],
    or per lane b out[r, b] = base_scale[r]*x[b] + h*sum_i
    coefs[b,r,i]*ks[i, b].

    x: (...,), ks: (s, ...), coefs: (m, s) or (B, m, s) with B =
    x.shape[0], base_scale: (m,).  Returns (m,) + x.shape, with the same
    accumulation dtype and order as ``butcher_combine_ref``.
    """
    acc_dt = acc_dtype(x.dtype)
    hc = torch.as_tensor(h * coefs).to(acc_dt)
    sc = torch.as_tensor(base_scale).to(acc_dt)
    xf = x.to(acc_dt)
    outs = []
    for r in range(hc.shape[-2]):
        acc = sc[r] * xf
        for i in range(ks.shape[0]):
            acc = acc + lane_bcast(hc[..., r, i], x) * ks[i].to(acc_dt)
        outs.append(acc.to(x.dtype))
    return torch.stack(outs)


def rms_norm_ref(x: torch.Tensor, weight: torch.Tensor,
                 residual: Optional[torch.Tensor] = None,
                 eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim of x (+ residual, the fused pre-norm
    pattern), in float32, returned in x.dtype."""
    xf = x.to(torch.float32)
    if residual is not None:
        xf = xf + residual.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (out * weight.to(torch.float32)).to(x.dtype)


def rms_norm_bwd_ref(x: torch.Tensor, weight: torch.Tensor,
                     residual: Optional[torch.Tensor], dy: torch.Tensor,
                     eps: float = 1e-6):
    """The gradients of ``rms_norm_ref`` for the cotangent ``dy``: (dx, dw,
    dres), dres None without a residual (it equals dx).  With v = x (+ res)
    and r = 1 / sqrt(mean(v^2) + eps), g = dy * w:
    dx = r g - v r^3 mean(g v), dw = sum over rows of dy v r."""
    acc = acc_dtype(x.dtype)
    v = x.to(acc)
    if residual is not None:
        v = v + residual.to(acc)
    d = v.shape[-1]
    r = torch.reciprocal(torch.sqrt(torch.mean(v * v, dim=-1, keepdim=True)
                                    + eps))
    g = dy.to(acc) * weight.to(acc)
    dv = r * g - v * (r * r * r) * (torch.sum(g * v, dim=-1, keepdim=True)
                                    / d)
    dw = torch.sum((dy.to(acc) * v * r).reshape(-1, d), dim=0)
    dx = dv.to(x.dtype)
    return dx, dw.to(weight.dtype), (None if residual is None else dx)


def _mask(Sq: int, Sk: int, causal: bool, window: Optional[int],
          q_offset: int, device) -> torch.Tensor:
    """(Sq, Sk) boolean: query i (absolute i + q_offset) may see key j."""
    qpos = torch.arange(Sq, device=device)[:, None] + q_offset
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def _scores(q, k, scale, acc):
    group = q.shape[1] // k.shape[1]
    kk = torch.repeat_interleave(k, group, dim=1).to(acc)
    return torch.matmul(q.to(acc), kk.transpose(-1, -2)) * scale


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      q_offset: int = 0,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Each query row's log-sum-exp of its scaled, allowed scores, (B, H,
    Sq) in promote(q.dtype, float32); log(1e-30) for a row that sees no key
    (the forward kernel's convention)."""
    acc = acc_dtype(q.dtype)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = _scores(q, k, scale, acc)
    mask = _mask(q.shape[2], k.shape[2], causal, window, q_offset, q.device)
    lse = torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.where(torch.isfinite(lse), lse,
                       torch.full_like(lse, math.log(1e-30)))


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      q_offset: int = 0, scale: Optional[float] = None):
    """The gradients (dq, dk, dv) of ``attention_ref`` by the flash
    recurrence, from the output ``o`` and the rows' log-sum-exp ``lse``:
    D = rowsum(do * o), P = exp(S - lse) on the allowed pairs, dV = P^T do,
    dS = P * (do V^T - D), dQ = dS K scale, dK = dS^T Q scale; GQA sums dK
    and dV over each kv head's query heads.  In promote(q.dtype, float32);
    returned in the inputs' dtype."""
    acc = acc_dtype(q.dtype)
    B, H, Sq, Dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = H // Hkv
    scale = scale if scale is not None else Dh ** -0.5
    s = _scores(q, k, scale, acc)
    mask = _mask(Sq, Sk, causal, window, q_offset, q.device)
    p = torch.where(mask, torch.exp(s - lse.to(acc)[..., None]),
                    torch.zeros((), dtype=acc, device=q.device))
    dof = do.to(acc)
    dvec = torch.sum(dof * o.to(acc), dim=-1, keepdim=True)
    vv = torch.repeat_interleave(v, group, dim=1).to(acc)
    kk = torch.repeat_interleave(k, group, dim=1).to(acc)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    ds = p * (torch.matmul(dof, vv.transpose(-1, -2)) - dvec)
    dq = torch.matmul(ds, kk) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.to(acc)) * scale
    dk = dk.reshape(B, Hkv, group, Sk, Dh).sum(dim=2)
    dv = dv.reshape(B, Hkv, group, Sk, Dh).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _masked_softmax(s: torch.Tensor) -> torch.Tensor:
    m = torch.amax(s, dim=-1, keepdim=True)
    # rows that are fully masked (all -inf) produce zeros, not NaNs
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.where(torch.isfinite(s), torch.exp(s - m), torch.zeros_like(s))
    return e / torch.clamp(torch.sum(e, dim=-1, keepdim=True), min=1e-30)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention with GQA, causal masking and a sliding window.

    q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D); H % Hkv == 0.  ``q_offset`` is
    the absolute position of q[..., 0, :]; with window w, query j attends
    keys i with j - w < i <= j.  Scores and softmax in float32 over the
    whole (Sq, Sk) matrix; returns q.dtype.
    """
    D = q.shape[-1]
    group = q.shape[1] // k.shape[1]
    scale = scale if scale is not None else D ** -0.5
    kk = torch.repeat_interleave(k, group, dim=1).to(torch.float32)
    vv = torch.repeat_interleave(v, group, dim=1).to(torch.float32)
    s = torch.matmul(q.to(torch.float32), kk.transpose(-1, -2)) * scale
    qpos = torch.arange(q.shape[2], device=q.device)[:, None] + q_offset
    kpos = torch.arange(k.shape[2], device=q.device)[None, :]
    mask = torch.ones((q.shape[2], k.shape[2]), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    p = _masked_softmax(s.masked_fill(~mask, float("-inf")))
    return torch.matmul(p, vv).to(q.dtype)


def attention_blocked_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None, q_offset: int = 0,
                          scale: Optional[float] = None,
                          block_q: int = 512) -> torch.Tensor:
    """Query-blocked attention: ``attention_ref``'s arithmetic on blocks of
    ``block_q`` queries, so the peak is one (block_q, Sk) score block per
    (batch, head), never (Sq, Sk).  Under autograd each block runs in
    ``torch.utils.checkpoint`` (its scores are recomputed in the backward,
    as the JAX package's ``jax.checkpoint``).  Sq not a multiple of the
    block takes ``attention_ref``, as in the JAX package."""
    B, H, Sq, D = q.shape
    group = H // k.shape[1]
    scale = scale if scale is not None else D ** -0.5
    bq = min(block_q, Sq)
    if Sq % bq != 0:
        return attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, scale=scale)
    kk = torch.repeat_interleave(k, group, dim=1).to(torch.float32)
    vv = torch.repeat_interleave(v, group, dim=1).to(torch.float32)
    Sk = k.shape[2]
    kt = kk.transpose(-1, -2)

    def one_block(qi, i: int):
        s = torch.matmul(qi.to(torch.float32), kt) * scale
        mask = _mask(bq, Sk, causal, window, q_offset + i * bq, q.device)
        p = _masked_softmax(s.masked_fill(~mask, float("-inf")))
        return torch.matmul(p, vv)

    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    blocks = []
    for i in range(Sq // bq):
        qi = q[:, :, i * bq:(i + 1) * bq]
        blocks.append(checkpoint(one_block, qi, i, use_reentrant=False)
                      if remat else one_block(qi, i))
    return torch.cat(blocks, dim=2).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, pos: int, *,
                         window: Optional[int] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """One-token GQA decode attention against a cache in its own dtype.

    q: (B, H, 1, D); k_cache, v_cache: (B, Smax, Hkv, D) (bfloat16 as a
    rule); pos: the absolute position of the new token (keys past it are
    masked).  As in the JAX package: scores are products of q and the cache
    accumulated in float32 (both operands taken to float32); the
    probabilities are rounded to the cache's dtype before the second
    product, which again accumulates in float32.  Returns q.dtype.
    """
    B, H, _, D = q.shape
    Hkv = k_cache.shape[2]
    G = H // Hkv
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, Hkv, G, D).to(torch.float32)
    kf = k_cache.to(torch.float32).permute(0, 2, 3, 1)      # (B, Hkv, D, S)
    s = torch.matmul(qg, kf) * scale                         # (B, Hkv, G, S)
    kpos = torch.arange(k_cache.shape[1], device=q.device)
    mask = kpos <= pos
    if window is not None:
        mask &= kpos > pos - window
    s = s.masked_fill(~mask, float("-inf"))
    p = _masked_softmax(s).to(v_cache.dtype).to(torch.float32)
    vf = v_cache.to(torch.float32).transpose(1, 2)           # (B, Hkv, S, D)
    o = torch.matmul(p, vf)
    return o.reshape(B, H, 1, D).to(q.dtype)
