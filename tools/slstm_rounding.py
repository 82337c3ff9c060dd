"""How a full-width sLSTM layer of xlstm-1.3b (d 2048, 4 heads of 512, the
JAX package's init: recurrent weights of fan-in H) carries a gradient back
through time, on the CPU: the numbers behind ``chip_smoke.py`` phase 54's
xlstm run (its labels past ``REC_TP_KEEP`` positions IGNORE, its forward
replayed) and its bound.

    PYTHONPATH=src python tools/slstm_rounding.py [--batch 2] \\
        [--growth 32 64 128 256] [--positions 64] [--keep 32 64]

1. Growth: float32, the loss the squared output at the last of S
   positions; prints the input gradient's norm at positions 0, S/4, S/2
   and S - 1 (an inf or nan: float32 overflowed).
2. Rounding of a replayed step: a float64 run (the float32 casts lifted,
   ``repro_torch.float64.lifted``) records the state each cell step starts
   from; a float32 run on the same inputs takes those states at every step
   (as x + (recorded - x).detach(), phase 54's ``_TrainReplay``), so the
   two differ by one step's rounding at a time.  The loss the mean squared
   output over the first ``keep`` of ``--positions``; prints, for the
   gradients of the input, r, wx and b, the relative norm of the
   difference and the relative difference of the norms (grad_norm's
   reading), float32 against float64.

The last line is the largest relative difference of a gradient norm per
``keep``, as JSON.
"""
import argparse
import json

import torch


def _layer(dtype):
    from repro_torch.nn.xlstm import XLSTMConfig, init_slstm
    cfg = XLSTMConfig(d_model=2048, n_heads=4)
    p = init_slstm(torch.Generator().manual_seed(0), cfg, torch.float32,
                   "cpu")
    return cfg, {k: v.to(dtype) if isinstance(v, torch.Tensor)
                 else {kk: vv.to(dtype) for kk, vv in v.items()}
                 for k, v in p.items()}


def _input(batch, S, dtype):
    return torch.randn(batch, S, 2048, dtype=torch.float64,
                       generator=torch.Generator().manual_seed(1)).to(dtype)


def growth(batch, lengths):
    from repro_torch.nn.xlstm import slstm_forward
    cfg, p = _layer(torch.float32)
    for S in lengths:
        x = _input(batch, S, torch.float32).requires_grad_()
        y, _ = slstm_forward(p, x, cfg)
        (gx,) = torch.autograd.grad(y[:, -1].pow(2).sum(), x)
        norms = [float(gx[:, t].norm()) for t in (0, S // 4, S // 2, S - 1)]
        print(f"growth S {S}: input gradient norm at positions 0, S/4, S/2, "
              f"S-1: {norms}", flush=True)


def _run(p, x, cfg, keep, forced=None):
    """(loss, gradients of x, r, wx, b, the recorded states) of one layer,
    each cell step's start state recorded (by position), or taken from
    ``forced``."""
    import repro_torch.nn.xlstm as xl
    plain = xl._slstm_cell
    seen = {}

    def cell(pp, xt, st, H, dh):
        t = xt.storage_offset() // xt.shape[-1]
        if forced is None:
            seen.setdefault(t, {k: v.detach().clone() for k, v in
                                st.items()})
        else:
            st = {k: v + (forced[t][k].to(v.dtype) - v).detach()
                  for k, v in st.items()}
        return plain(pp, xt, st, H, dh)
    leaves = {k: (v.clone().requires_grad_() if isinstance(v, torch.Tensor)
                  else v) for k, v in p.items()}
    x = x.clone().requires_grad_()
    xl._slstm_cell = cell
    try:
        y, _ = xl.slstm_forward(leaves, x, cfg)
        loss = y[:, :keep].pow(2).mean()
        grads = torch.autograd.grad(loss, [x, leaves["r"], leaves["wx"],
                                           leaves["b"]])
    finally:
        xl._slstm_cell = plain
    return loss.detach(), grads, seen


def replayed(batch, S, keep):
    from repro_torch.float64 import lifted
    cfg, p64 = _layer(torch.float64)
    x64 = _input(batch, S, torch.float64)
    with lifted():
        l64, g64, states = _run(p64, x64, cfg, keep)
    _, p32 = _layer(torch.float32)
    l32, g32, _ = _run(p32, x64.float(), cfg, keep, forced=states)
    worst = 0.0
    print(f"replayed S {S} keep {keep}: loss rel "
          f"{float((l32 - l64).abs() / l64.abs()):.3e}", flush=True)
    for name, a, b in zip(("x", "r", "wx", "b"), g32, g64):
        a = a.double()
        diff = float((a - b).norm() / b.norm())
        norm = float((a.norm() - b.norm()).abs() / b.norm())
        worst = max(worst, norm)
        print(f"  {name}: norm {float(b.norm()):.6e}, |g32 - g64| / |g64| "
              f"{diff:.3e}, ||g32| - |g64|| / |g64| {norm:.3e}", flush=True)
    return worst


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--growth", type=int, nargs="*",
                    default=[32, 64, 128, 256])
    ap.add_argument("--positions", type=int, default=64)
    ap.add_argument("--keep", type=int, nargs="*", default=[32, 64])
    args = ap.parse_args()
    torch.set_num_threads(4)
    growth(args.batch, args.growth)
    worst = {k: replayed(args.batch, args.positions, k) for k in args.keep}
    print(json.dumps({f"keep {k}": v for k, v in worst.items()}))


if __name__ == "__main__":
    main()
