"""xLSTM blocks, mLSTM (matrix memory) and sLSTM (scalar memory): the JAX
package's ``repro.nn.xlstm`` in PyTorch.

mLSTM training and prefill use the parallel form of the xLSTM paper (App.
A): decay logits l_ts = F_t - F_s + i_s with F = cumsum(log-sigmoid(f)),
row-stabilised, a masked quadratic form with a gate-derived bias, taken in
query blocks of 256 rows (each block recomputed in the backward), or, from
``cfg.m_chunkwise_min_s`` positions on (``m_form="auto"``), the chunkwise
recurrent form (``_mlstm_chunkwise``).  Decode is the O(1) recurrence on
the matrix state (C, n, m).

sLSTM is sequential (a recurrent matrix R per head): training and prefill
run the cell over time in chunks of 256 steps (each chunk recomputed in
the backward: the JAX package's two-level time scan), decode is one cell
step.  The cell is a Python loop over time, about 20 launches a step.

State layouts (float32 whatever the cache dtype):
  mLSTM: {"conv": (B, k-1, di), "C": (B, H, dk, dv), "n": (B, H, dk),
          "m": (B, H)}
  sLSTM: {"c", "n", "h", "m": (B, H, dh)}

As in the JAX package, ``init_mlstm_state`` starts m at 0 while the
parallel and chunkwise forms start their stabiliser at -inf; serving
always prefills (S > 1) before it decodes, which takes the state from the
forms.

Tensor parallelism (``tp``, training; the input entered whole, the output
a partial sum for the caller's ``leave``), heads-parallel:

* mLSTM: ``up``'s columns split the concatenation [x | z], so it is made
  whole (``TensorParallel.whole``); every rank then computes x and the
  conv output ``cx`` over all d_inner channels (q and k read them all)
  and z on its own heads' channels.  The column blocks of wq, wk and wv
  are the rank's heads (their columns are ordered by head), the gates
  take the rank's columns of wi and wf, and the skip LayerNorm over the
  whole d_inner takes its row statistics summed over "model"
  (``layernorm_split``); ``down``'s row block is the rank's channels.
* sLSTM: ``wx``'s columns are head-major (i, f, z, o per head), so its
  column block gives the rank whole heads for all four gates; the rank
  takes its heads of ``r`` and ``b`` and runs the recurrence on H / TP
  heads.  The out LayerNorm over d_model needs every head: the heads'
  outputs are gathered (all_gather; backward reduce_scatter), and every
  rank runs the norm whole before its columns of up1 / up2 and its rows
  of ``down``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from repro_torch.parallel import comm
from .common import dense_init, promoted, remat
from .mamba import _causal_conv
from .norm import init_layernorm, layernorm, layernorm_split


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    d_model: int
    n_heads: int = 4
    m_proj_factor: float = 2.0     # mLSTM up-projection
    s_proj_factor: float = 4.0 / 3.0
    d_conv: int = 4
    # training-time mLSTM evaluation: "chunkwise" (state-passing) vs
    # "parallel" (masked quadratic form); "auto" switches on sequence
    # length
    m_form: str = "auto"
    m_chunk: int = 1024
    m_chunkwise_min_s: int = 8192


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w in the promoted dtype (a float32 gate weight of a 16-bit or
    float64 model, as JAX's matmul promotes)."""
    a, w = promoted(a, w)
    return a @ w


def _einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, *promoted(*ops))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(generator: torch.Generator, cfg: XLSTMConfig,
               dtype: torch.dtype = torch.float32, device="cuda"):
    d = cfg.d_model
    di = int(cfg.m_proj_factor * d)
    H = cfg.n_heads
    f32 = torch.float32
    return {
        "up": dense_init((d, 2 * di), dtype, generator, device),
        "conv_w": dense_init((cfg.d_conv, di), dtype, generator, device),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "wq": dense_init((di, di), dtype, generator, device),
        "wk": dense_init((di, di), dtype, generator, device),
        "wv": dense_init((di, di), dtype, generator, device),
        "wi": dense_init((di, H), f32, generator, device),
        "wf": dense_init((di, H), f32, generator, device),
        "skip_norm": init_layernorm(di, dtype, device),
        "down": dense_init((di, d), dtype, generator, device),
    }


def _mlstm_block(qi, Fi, F_, i_gate, kf, vf, q0: int):
    """One query block of the parallel form: rows [q0, q0 + bq).  Each
    row's normalisation is its own, so query-blocking is exact; the block
    holds (B, H, bq, S)."""
    S = F_.shape[-1]
    bq = qi.shape[2]
    dev = qi.device
    lts = Fi[..., :, None] - F_[..., None, :] + i_gate[..., None, :]
    spos = torch.arange(S, device=dev)[None, :]
    tpos = (q0 + torch.arange(bq, device=dev))[:, None]
    lts = torch.where(spos <= tpos, lts, float("-inf"))
    m_row = lts.amax(-1, keepdim=True)
    m_row = torch.where(torch.isfinite(m_row), m_row, 0.0)
    Dmat = torch.exp(lts - m_row)
    Smat = _einsum("bhtd,bhsd->bhts", qi, kf) * Dmat
    denom = torch.maximum(torch.abs(Smat.sum(-1, keepdim=True)),
                          torch.exp(-m_row))
    return _einsum("bhts,bhsv->bhtv", Smat / denom, vf)


def mlstm_forward(p, x: torch.Tensor, cfg: XLSTMConfig, *, state=None,
                  tp=None):
    """x: (B, S, d).  No state: training; a state with S > 1: prefill (its
    conv buffer is read; the returned state is the one after the last
    position); a state with S == 1: one decode step.  ``tp``: training on
    the rank's heads (see the module note).

    Returns (out (B, S, d), new state or None)."""
    B, S, d = x.shape
    H = cfg.n_heads
    di = int(cfg.m_proj_factor * d)
    dh = di // H
    f32 = torch.float32

    wi, wf = p["wi"], p["wf"]
    if tp is None:
        xz = x @ p["up"]
        xb, z = xz.split(di, dim=-1)
    else:
        if state is not None:
            raise ValueError("a heads-parallel mLSTM trains only")
        H //= tp.size
        lo = tp.rank * H * dh
        up = tp.whole(p["up"], 1, 2 * di)
        xb = x @ up[:, :di]                                  # every channel
        z = x @ up[:, di + lo:di + lo + H * dh]              # the rank's
        heads_r = slice(tp.rank * H, (tp.rank + 1) * H)
        wi, wf = wi[:, heads_r], wf[:, heads_r]
    conv_state = state["conv"] if state is not None else None
    cx, new_conv = _causal_conv(xb, p["conv_w"], p["conv_b"], conv_state)
    cx = F.silu(cx)

    def heads(t):
        return t.reshape(B, S, H, dh).transpose(1, 2)       # (B, H, S, dh)

    q = heads(cx @ p["wq"]) * dh ** -0.5
    k = heads(cx @ p["wk"])
    v = heads(xb @ p["wv"])
    i_gate = _mm(cx, wi).transpose(1, 2)                     # (B, H, S)
    f_gate = _mm(cx, wf).transpose(1, 2)

    decode = state is not None and S == 1
    if decode:
        C, n, m = state["C"], state["n"], state["m"]
        logf = F.logsigmoid(f_gate[..., 0])                  # (B, H)
        logi = i_gate[..., 0]
        m_new = torch.maximum(logf + m, logi)
        fe = torch.exp(logf + m - m_new)[..., None, None]
        ie = torch.exp(logi - m_new)[..., None, None]
        kk, vv, qq = k[:, :, 0], v[:, :, 0], q[:, :, 0]      # (B, H, dh)
        C = fe * C + ie * (kk[..., :, None] * vv[..., None, :])
        n = fe[..., 0] * n + ie[..., 0] * kk
        denom = torch.maximum(
            torch.abs(_einsum("bhd,bhd->bh", n, qq)),
            torch.exp(-m_new))[..., None]
        y = _einsum("bhd,bhdv->bhv", qq, C) / denom     # (B, H, dv)
        y = y[:, :, None]                                    # (B, H, 1, dh)
        new_state = {"conv": new_conv, "C": C, "n": n, "m": m_new}
    elif (cfg.m_form == "chunkwise"
          or (cfg.m_form == "auto" and S >= cfg.m_chunkwise_min_s)) and \
            S % cfg.m_chunk == 0 and S > cfg.m_chunk:
        y, last = _mlstm_chunkwise(q, k, v, i_gate, f_gate, cfg.m_chunk)
        new_state = None
        if state is not None:
            C, n, m = last
            new_state = {"conv": new_conv, "C": C, "n": n, "m": m}
    else:
        logf = F.logsigmoid(f_gate)                          # (B, H, S)
        F_ = torch.cumsum(logf, dim=-1)
        kf = k.to(f32)
        vf = v.to(f32)
        qf = q.to(f32)
        bq = 256 if S % 256 == 0 and S > 256 else S
        blocks = [remat(_mlstm_block, qf[:, :, i:i + bq], F_[..., i:i + bq],
                         F_, i_gate, kf, vf, i)
                  for i in range(0, S, bq)]
        y = torch.cat(blocks, dim=2).to(x.dtype)
        new_state = None
        if state is not None:   # prefill: also the recurrent state
            dec = i_gate + (F_[..., -1:] - F_)                # (B, H, S)
            m_fin = dec.amax(-1)
            ie_all = torch.exp(dec - m_fin[..., None])
            kw = kf * ie_all[..., None]
            C = _mm(kw.transpose(-1, -2), vf)                 # (B, H, dk, dv)
            n = kw.sum(-2)
            new_state = {"conv": new_conv, "C": C, "n": n, "m": m_fin}

    y = y.transpose(1, 2).reshape(B, S, H * dh).to(x.dtype)
    if tp is None:
        y = layernorm(p["skip_norm"], y) + cx    # gated skip (xLSTM style)
    else:
        y = layernorm_split(p["skip_norm"], y, tp) + \
            cx[..., lo:lo + H * dh]
    y = y * F.silu(z)
    return y @ p["down"], new_state


def init_mlstm_state(cfg: XLSTMConfig, batch: int,
                     dtype: torch.dtype = torch.float32, device="cuda"):
    di = int(cfg.m_proj_factor * cfg.d_model)
    H = cfg.n_heads
    dh = di // H
    f32 = torch.float32
    return {"conv": torch.zeros((batch, cfg.d_conv - 1, di), dtype=dtype,
                                device=device),
            "C": torch.zeros((batch, H, dh, dh), dtype=f32, device=device),
            "n": torch.zeros((batch, H, dh), dtype=f32, device=device),
            "m": torch.zeros((batch, H), dtype=f32, device=device)}


def _mlstm_chunk(C, n, m, qc, kc, vc, ic, fc):
    """One chunk of the chunkwise form: (C, n, m) after it, and its y."""
    Q = qc.shape[2]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=qc.device))
    b = torch.cumsum(fc, dim=-1)                              # (B, H, Q)
    Btot = b[..., -1:]
    # intra-chunk logits l_ts = b_t - b_s + i_s (s <= t)
    lts = b[..., :, None] - b[..., None, :] + ic[..., None, :]
    lts = torch.where(mask, lts, float("-inf"))
    m_intra = lts.amax(-1)                                    # (B, H, Q)
    m_inter = b + m[..., None]
    m_t = torch.maximum(m_inter, m_intra)
    m_t = torch.where(torch.isfinite(m_t), m_t, 0.0)
    D = torch.exp(lts - m_t[..., None])
    Smat = _einsum("bhtd,bhsd->bhts", qc, kc) * D
    w_inter = torch.exp(m_inter - m_t)                        # (B, H, Q)
    h = _einsum("bhts,bhsv->bhtv", Smat, vc) + \
        w_inter[..., None] * _einsum("bhtd,bhdv->bhtv", qc, C)
    den = Smat.sum(-1) + w_inter * _einsum("bhtd,bhd->bht", qc, n)
    den = torch.maximum(torch.abs(den), torch.exp(-m_t))
    y = h / den[..., None]
    # carry update relative to the chunk's end
    dec = Btot - b + ic                                       # (B, H, Q)
    m_new = torch.maximum(Btot[..., 0] + m, dec.amax(-1))
    wk = torch.exp(dec - m_new[..., None])                    # (B, H, Q)
    wC = torch.exp(Btot[..., 0] + m - m_new)[..., None, None]
    C = wC * C + _einsum("bhs,bhsd,bhsv->bhdv", wk, kc, vc)
    n = wC[..., 0] * n + _einsum("bhs,bhsd->bhd", wk, kc)
    return C, n, m_new, y


def _mlstm_chunkwise(q, k, v, i_gate, f_gate, Q: int):
    """Chunkwise-recurrent mLSTM (xLSTM App. A), equal to the parallel form
    up to rounding.  q, k, v: (B, H, S, dh) (q pre-scaled); i_gate, f_gate:
    (B, H, S).  Chunks of Q positions run the masked quadratic form on
    (Q, Q) logits; a stabilised matrix state (C, n, m), from m = -inf,
    carries the history between them.  Returns (y (B, H, S, dh), (C, n, m)
    after the last chunk)."""
    B, H, S, dh = q.shape
    f32 = torch.float32
    qf, kf, vf = q.to(f32), k.to(f32), v.to(f32)
    ig = i_gate.to(f32)
    logf = F.logsigmoid(f_gate.to(f32))
    C = torch.zeros((B, H, dh, dh), dtype=f32, device=q.device)
    n = torch.zeros((B, H, dh), dtype=f32, device=q.device)
    m = torch.full((B, H), float("-inf"), dtype=f32, device=q.device)
    ys = []
    for c in range(0, S, Q):
        sl = slice(c, c + Q)
        C, n, m, y = remat(_mlstm_chunk, C, n, m, qf[:, :, sl],
                            kf[:, :, sl], vf[:, :, sl], ig[..., sl],
                            logf[..., sl])
        ys.append(y)
    return torch.cat(ys, dim=2).to(q.dtype), (C, n, m)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def _slstm_up(d: int, factor: float) -> int:
    """The up-projection width: factor * d rounded up to a multiple of 128
    (at least 128), as in the JAX package."""
    return max(128, -(-int(factor * d) // 128) * 128)


def init_slstm(generator: torch.Generator, cfg: XLSTMConfig,
               dtype: torch.dtype = torch.float32, device="cuda"):
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    df = _slstm_up(d, cfg.s_proj_factor)
    f32 = torch.float32
    return {
        "wx": dense_init((d, 4 * d), dtype, generator, device),  # i,f,z,o
        # recurrent, per head; fan-in from the leading axis (H), as JAX's
        "r": dense_init((H, dh, 4 * dh), f32, generator, device),
        "b": torch.zeros((4 * d,), dtype=f32, device=device),
        "up1": dense_init((d, df), dtype, generator, device),
        "up2": dense_init((d, df), dtype, generator, device),
        "down": dense_init((df, d), dtype, generator, device),
        "out_norm": init_layernorm(d, dtype, device),
    }


def _slstm_cell(p, xt: torch.Tensor, st, H: int, dh: int):
    """One sLSTM time step.  xt: (B, 4d) pre-activations from the input."""
    c, n, h, m = st["c"], st["n"], st["h"], st["m"]            # (B, H, dh)
    B = xt.shape[0]
    # xt + h R per head, as one batched GEMM over the heads: (H, B, 4dh)
    pre = torch.baddbmm(*promoted(xt.reshape(B, H, 4 * dh).transpose(0, 1),
                                  h.transpose(0, 1), p["r"])).transpose(0, 1)
    pre = pre + p["b"].reshape(H, 4 * dh)
    i_, f_, z_, o_ = pre.split(dh, dim=-1)                     # (B, H, dh)
    logf = F.logsigmoid(f_)
    m_new = torch.maximum(logf + m, i_)
    ie = torch.exp(i_ - m_new)
    fe = torch.exp(logf + m - m_new)
    c = fe * c + ie * torch.tanh(z_)
    n = torch.clamp(fe * n + ie, min=1e-6)
    h = torch.sigmoid(o_) * c / n
    return {"c": c, "n": n, "h": h, "m": m_new}


def _slstm_chunk(p, xc, c, n, h, m, H, dh):
    """The cell over a chunk of steps, xc: (B, cs, 4d); returns the state
    after it and the chunk's h (B, cs, H, dh)."""
    st = {"c": c, "n": n, "h": h, "m": m}
    hs = []
    for t in range(xc.shape[1]):
        st = _slstm_cell(p, xc[:, t], st, H, dh)
        hs.append(st["h"])
    return st["c"], st["n"], st["h"], st["m"], torch.stack(hs, dim=1)


def slstm_forward(p, x: torch.Tensor, cfg: XLSTMConfig, *, state=None,
                  tp=None):
    """x: (B, S, d).  No state: training (from ``init_slstm_state``); a
    state: prefill (S > 1) or one decode step (S == 1) from it.  ``tp``:
    training on the rank's heads (see the module note).

    Returns (out (B, S, d), new state or None)."""
    B, S, d = x.shape
    H = cfg.n_heads
    dh = d // H
    xw = (x @ p["wx"]).to(torch.float32)                 # (B, S, 4 H dh)
    cell_p = p
    if tp is not None:
        if state is not None:
            raise ValueError("a heads-parallel sLSTM trains only")
        H //= tp.size
        h0 = tp.rank * H
        cell_p = {"r": p["r"][h0:h0 + H],
                  "b": p["b"][4 * dh * h0:4 * dh * (h0 + H)]}

    st0 = _zero_state(B, H, dh, x.device) if state is None else dict(state)

    if S == 1 and state is not None:
        st = _slstm_cell(p, xw[:, 0], st0, H, dh)
        hs = st["h"][:, None]                                  # (B,1,H,dh)
        new_state = st
    else:
        # two-level time loop: chunks of cs steps, each recomputed in the
        # backward (so it saves the cell state at chunk boundaries only)
        cs = 256 if S % 256 == 0 and S > 256 else S
        carry = (st0["c"], st0["n"], st0["h"], st0["m"])
        outs = []
        for c0 in range(0, S, cs):
            *carry, hc = remat(
                lambda xc, *st: _slstm_chunk(cell_p, xc, *st, H, dh),
                xw[:, c0:c0 + cs], *carry)
            outs.append(hc)
        hs = torch.cat(outs, dim=1)                            # (B,S,H,dh)
        new_state = dict(zip(("c", "n", "h", "m"), carry)) \
            if state is not None else None

    y = hs.reshape(B, -1, H * dh).to(x.dtype)
    if tp is not None:          # every head, for the norm over d_model
        y = comm.gather_from_sequence(y, tp.group, 2)
    y = layernorm(p["out_norm"], y)
    y = (F.gelu(y @ p["up1"], approximate="tanh") * (y @ p["up2"])) \
        @ p["down"]
    return y, new_state


def init_slstm_state(cfg: XLSTMConfig, batch: int, device="cuda"):
    H = cfg.n_heads
    return _zero_state(batch, H, cfg.d_model // H, device)


def _zero_state(batch: int, H: int, dh: int, device):
    z = torch.zeros((batch, H, dh), dtype=torch.float32, device=device)
    return {"c": z, "n": z + 1e-6, "h": z.clone(), "m": z.clone()}
