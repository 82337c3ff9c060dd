"""Mamba-1 selective SSM block (jamba's recurrent layer), the JAX package's
``repro.nn.mamba`` in PyTorch.

Training and prefill run the chunked selective scan: the sequence is split
into chunks of ``cfg.chunk`` steps; within a chunk the recurrence
h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t is evaluated over (B, chunk,
d_inner, d_state) tensors, and the chunk's last state is carried into the
next.  Under autograd each chunk runs under ``torch.utils.checkpoint``
(the JAX package's ``jax.checkpoint(chunk_body)``), so a backward holds one
chunk's (B, chunk, d_inner, d_state) tensors at a time, never the whole
sequence's.

Within a chunk the JAX package takes ``jax.lax.associative_scan``, which
has no public counterpart in torch; here the recurrence runs step by step
over the chunk, one fused multiply-add launch per step (in place into the
chunk's input term when no gradient is needed).  The association order
differs from JAX's tree, so the two agree to rounding, not bit for bit
(``tests/test_torch_mamba.py`` holds 1e-12 in float64).  A sequence longer
than one chunk must be a whole number of chunks, as in the JAX package.

Decode (S == 1 with a state) is the O(1) recurrent update with a rolling
conv buffer.  State: {"conv": (B, k-1, d_inner), "ssm": (B, d_inner,
d_state)}, float32 whatever the cache dtype (the JAX package's rule).

Tensor parallelism (``tp``, training): channel-parallel, as the JAX
package constrains ``xb`` to ("batch", "seq", "ffn") with "ffn" on "model":
each rank scans its d_inner / TP channels of the entered (whole) input.
Three leaves are not laid out by channel there and are made whole first
(``TensorParallel.whole``: an all_gather, whose backward sums the ranks'
partial gradients onto each block): ``in_proj``'s columns split the
concatenation [x | z] (the rank needs its channels of both halves),
``x_proj``'s split [dt | B | C] (the rank needs its channels' rows; its
product is a partial sum over "model", ``TensorParallel.summed``) and
``dt_proj``'s rows (the rank needs its channels' columns).  The
replicated conv, dt bias, A and D give the rank its channels, and
``out_proj``'s row block is the rank's channels already: its output is
the partial sum the caller's ``leave`` takes.  A layer laid out whole
(``channel_split`` False) runs whole, as on one device.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from .common import dense_init, promoted, remat


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_model: int
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0        # 0 => ceil(d_model/16)
    chunk: int = 256

    @property
    def d_inner(self):
        return self.expand * self.d_model

    @property
    def rank(self):
        return self.dt_rank or -(-self.d_model // 16)


def init_mamba(generator: torch.Generator, cfg: MambaConfig,
               dtype: torch.dtype = torch.float32, device="cuda"):
    d, di, N, R = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.rank
    f32 = torch.float32
    A = torch.arange(1, N + 1, dtype=f32, device=device)[None, :] \
        .repeat(di, 1)
    p = {
        "in_proj": dense_init((d, 2 * di), dtype, generator, device),
        "conv_w": dense_init((cfg.d_conv, di), dtype, generator, device),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "x_proj": dense_init((di, R + 2 * N), dtype, generator, device),
        "dt_proj": dense_init((R, di), dtype, generator, device),
    }
    lo, hi = math.log(1e-3), math.log(1e-1)
    draw = device if generator is None else generator.device
    u = torch.rand((di,), generator=generator, dtype=f32, device=draw)
    p["dt_bias"] = torch.log(torch.expm1(torch.exp(lo + (hi - lo) * u))) \
        .to(device)
    p["A_log"] = torch.log(A)
    p["D"] = torch.ones((di,), dtype=f32, device=device)
    p["out_proj"] = dense_init((di, d), dtype, generator, device)
    return p


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state=None):
    """x: (B, S, di); w: (k, di) depthwise; state: (B, k-1, di) prior
    inputs.  Returns (out, the last k-1 inputs as a new tensor)."""
    k = w.shape[0]
    S = x.shape[1]
    if state is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                  # (B, S+k-1, di)
    out = xp[:, 0:S] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + S] * w[i]
    out = out + b
    # a copy: a view would keep the whole (B, S+k-1, di) buffer alive
    new_state = xp[:, S:].clone() if k > 1 else None
    return out, new_state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) for every x, the JAX package's ``logaddexp(x, 0)``
    (``F.softplus`` turns linear above its threshold)."""
    return torch.logaddexp(x, x.new_zeros(()))


def _chunk_scan(h, dtc, bcc, ccc, xbc, A):
    """One chunk: (h at its last step, y (B, cs, di)).  dtc, xbc: (B, cs,
    di); bcc, ccc: (B, cs, N); A: (di, N); h: (B, di, N)."""
    da = torch.exp(dtc[..., None] * A[None, None])            # (B,cs,di,N)
    db = dtc[..., None] * bcc[:, :, None, :] * xbc[..., None]
    cs = dtc.shape[1]
    if torch.is_grad_enabled():
        steps = []
        for t in range(cs):
            h = torch.addcmul(db[:, t], da[:, t], h)
            steps.append(h)
        hs = torch.stack(steps, dim=1)
    else:
        # the states overwrite the input terms: db[t] <- db[t] + da[t] h
        hs = db
        hs[:, 0].addcmul_(da[:, 0], h)
        for t in range(1, cs):
            hs[:, t].addcmul_(da[:, t], hs[:, t - 1])
    y = torch.einsum("bsdn,bsn->bsd", hs, ccc)
    return hs[:, -1].clone(), y


def _ssm_scan_chunked(dt, Bc, Cc, xb, A, h0, chunk: int):
    """The selective scan, h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t,
    y_t = C_t . h_t, chunk by chunk (see the module note).

    dt, xb: (B, S, di); Bc, Cc: (B, S, N); A: (di, N); h0: (B, di, N).
    Returns (y: (B, S, di), h_final)."""
    S = dt.shape[1]
    cs = min(chunk, S)
    if S % cs:
        raise ValueError(f"sequence length {S} is not a whole number of "
                         f"{cs}-step chunks")
    h, ys = h0, []
    for c in range(S // cs):
        sl = slice(c * cs, (c + 1) * cs)
        h, y = remat(_chunk_scan, h, dt[:, sl], Bc[:, sl], Cc[:, sl],
                     xb[:, sl], A)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def channel_split(p, cfg: MambaConfig) -> bool:
    """Whether the layer's leaves are laid out by channel over "model"
    (``in_proj``'s column block, not the whole)."""
    return p["in_proj"].shape[-1] != 2 * cfg.d_inner


def _rank_leaves(p, cfg: MambaConfig, tp):
    """The leaves the rank computes its channels with (see the module
    note): in_proj's x and z columns, conv_w, conv_b, x_proj's rows,
    dt_proj's columns, dt_bias, A_log and D of its channels."""
    di, N, R = cfg.d_inner, cfg.d_state, cfg.rank
    n = di // tp.size
    lo = tp.rank * n
    w_in = tp.whole(p["in_proj"], 1, 2 * di)
    return {"in_x": w_in[:, lo:lo + n], "in_z": w_in[:, di + lo:di + lo + n],
            "conv_w": p["conv_w"][:, lo:lo + n],
            "conv_b": p["conv_b"][lo:lo + n],
            "x_proj": tp.whole(p["x_proj"], 1, R + 2 * N)[lo:lo + n],
            "dt_proj": tp.whole(p["dt_proj"], 0, R)[:, lo:lo + n],
            "dt_bias": p["dt_bias"][lo:lo + n],
            "A_log": p["A_log"][lo:lo + n], "D": p["D"][lo:lo + n]}


def mamba_forward(p, x: torch.Tensor, cfg: MambaConfig, *, state=None,
                  tp=None):
    """x: (B, S, d).  No state: training.  A state with S > 1: prefill (the
    returned state is the one after the last position; the given state's
    conv buffer is read, its ssm state is not: prefill starts from zero,
    as in the JAX package).  A state with S == 1: one decode step.

    ``tp`` (training on a "model" axis, leaves laid out by channel): ``x``
    whole, the output the rank's channels' partial sum (see the module
    note).

    Returns (out (B, S, d), new state or None)."""
    B, S, d = x.shape
    di, N, R = cfg.d_inner, cfg.d_state, cfg.rank
    if tp is None:
        xz = x @ p["in_proj"]
        xb, z = xz.split(di, dim=-1)                 # (B, S, di) each
    else:
        if state is not None:
            raise ValueError("a channel-parallel Mamba trains only")
        p = dict(p, **_rank_leaves(p, cfg, tp))
        di = di // tp.size
        xb, z = x @ p["in_x"], x @ p["in_z"]         # (B, S, di / TP)

    decode = state is not None and S == 1
    conv_state = state["conv"] if state is not None else None
    xb, new_conv = _causal_conv(xb, p["conv_w"], p["conv_b"], conv_state)
    xb = F.silu(xb)

    proj = xb @ p["x_proj"]
    if tp is not None:
        proj = tp.summed(proj)
    dt, Bc, Cc = proj.split([R, N, N], dim=-1)
    dt = _softplus(dt @ p["dt_proj"] + p["dt_bias"])        # (B, S, di)
    A = -torch.exp(p["A_log"])                               # (di, N)

    if decode:
        da0 = torch.exp(dt[:, 0, :, None] * A[None])        # (B, di, N)
        db0 = dt[:, 0, :, None] * Bc[:, 0, None, :] * xb[:, 0, :, None]
        h = da0 * state["ssm"] + db0
        y = torch.einsum("bdn,bn->bd", *promoted(h, Cc[:, 0]))[:, None]
        new_state = {"conv": new_conv, "ssm": h}
    else:
        f32 = torch.float32
        h0 = torch.zeros((B, di, N), dtype=f32, device=x.device)
        y, hF = _ssm_scan_chunked(dt.to(f32), Bc.to(f32), Cc.to(f32),
                                  xb.to(f32), A, h0, cfg.chunk)
        new_state = {"conv": new_conv, "ssm": hF} \
            if state is not None else None
    y = y + xb * p["D"]
    y = (y * F.silu(z)).to(x.dtype)
    return y @ p["out_proj"], new_state


def init_mamba_state(cfg: MambaConfig, batch: int,
                     dtype: torch.dtype = torch.float32, device="cuda"):
    return {"conv": torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((batch, cfg.d_inner, cfg.d_state),
                               dtype=dtype, device=device)}
