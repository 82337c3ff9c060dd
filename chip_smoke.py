"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each fatal on failure (any failure exits non-zero and prints no
result line):

  1. build   — compile the CUDA kernels of ``src/repro_torch/csrc`` with nvcc
               and load them (build seconds and ptxas usage are printed).
  2. kernels — each kernel against its plain PyTorch version on the card:
               float32/float64/bfloat16, n in {256*43, 256, 1, 127,
               1000003}, s in {1, 6, 7, 12, 13}, m = 2 rows.  Tolerance:
               |kernel - plain| <= rtol * (sum of |terms|) with rtol 1e-13
               for float64 and 1e-6 for float32 (the kernel fuses a*b+c
               into one rounding), plus one output ulp for bfloat16.
  3. train   — the main path: 3 SGD steps of the MiniBooNE CNF trainer
               (``repro_torch.launch.train_cnf``; dim 43, hidden (64, 64),
               batch 256, dopri5, Hutchinson trace, symplectic adjoint) in
               float32, once on a fixed grid of 8 steps and once adaptive
               (rtol 1e-4, atol 1e-6, max_steps 48).  Loss and gradient
               norm must be finite, and both kernels' launch counters,
               zeroed just before, must be > 0.
  4. exact   — float64 at the same shapes on the fixed grid: the symplectic
               gradient equals autograd through the solver (DirectBackprop)
               to rtol 1e-9 (per leaf, max |diff| <= 1e-9 max |ref|); and on
               a small input (batch 16) the loss and gradient on the card
               equal the port's CPU result to the same tolerance.
  5. memory  — peak allocated bytes of one float32 loss+gradient, symplectic
               vs DirectBackprop, at 8 and 32 fixed steps: symplectic must be
               below backprop.
  6. report  — float32 kernel, plain-version and one-library-call times
               at the main path's shapes (and at n = 1e6 and 8e6), the
               bound (bytes over 3.35 TB/s, or flops over 67 TFLOP/s if
               larger), and a ``kernels`` JSON line whose ``ms`` is the
               time per call including the wrapper and ``device_ms`` the
               kernel alone.
  7. profile — one fixed-grid loss+gradient under torch.profiler: wall
               time, kernel time, the device's busy share, top kernels.

The card's name and power limit are printed early; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
F32_FLOP_PER_S = 67e12           # H100 SXM float32, outside the tensor cores
MAIN_N = 256 * 43                # the CNF state leaf: batch 256 x dim 43
MAIN_S = 7                       # dopri5


def fail(msg: str):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def phase(name: str):
    print(f"== {name}", flush=True)


# ---------------------------------------------------------------------------

def build():
    from repro_torch.kernels import butcher_combine as kern
    phase("1 build")
    t = time.perf_counter()
    log = kern.build()
    print(f"build_seconds {time.perf_counter() - t:.2f}")
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")


def _close(got, want, mag, dtype):
    acc = torch.promote_types(dtype, torch.float32)
    tol = (1e-13 if dtype == torch.float64 else 1e-6) * mag
    if dtype == torch.bfloat16:
        tol = tol + want.to(acc).abs() * torch.finfo(dtype).eps
    err = (got.to(acc) - want.to(acc)).abs()
    return bool(torch.all(err <= tol)), float(err.max())


def kernels_vs_plain():
    from repro_torch.kernels import butcher_combine as kern
    from repro_torch.kernels import ref
    phase("2 kernels vs plain")
    dev = torch.device("cuda")
    max_err = {"butcher_combine": 0.0, "butcher_combine_rows": 0.0}
    n_cases = 0
    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        acc = torch.promote_types(dtype, torch.float32)
        for n in (MAIN_N, 256, 1, 127, 1_000_003):
            for s in (1, 6, 7, 12, 13):
                g = torch.Generator(device=dev).manual_seed(7 * n + s)
                x = torch.randn(n, generator=g, device=dev).to(dtype)
                ks = torch.randn((s, n), generator=g, device=dev).to(dtype)
                hc = (0.3 * torch.randn((2, s), generator=g, device=dev,
                                        dtype=torch.float64)).to(acc)
                sc = torch.tensor([1.0, 0.0], dtype=acc, device=dev)
                kmag = hc.abs() @ ks.to(acc).abs()
                xmag = x.to(acc).abs()
                got = kern.butcher_combine(x, ks, hc[0])
                ok, e1 = _close(got, ref.butcher_combine_ref(x, ks, hc[0],
                                                             1.0),
                                xmag + kmag[0], dtype)
                check(ok, f"butcher_combine {dtype} n={n} s={s}: max err "
                          f"{e1}")
                rows = kern.butcher_combine_rows(x, ks, hc, sc)
                want = ref.butcher_combine_rows_ref(x, ks, hc, sc, 1.0)
                ok0, e2 = _close(rows[0], want[0], xmag + kmag[0], dtype)
                ok1, e3 = _close(rows[1], want[1], kmag[1], dtype)
                check(ok0 and ok1, f"butcher_combine_rows {dtype} n={n} "
                                   f"s={s}: max err {max(e2, e3)}")
                if dtype == torch.float32:
                    max_err["butcher_combine"] = max(
                        max_err["butcher_combine"], e1)
                    max_err["butcher_combine_rows"] = max(
                        max_err["butcher_combine_rows"], e2, e3)
                n_cases += 2
    torch.cuda.synchronize()
    print(f"kernel cases {n_cases} all within tolerance; float32 max abs "
          f"err {max_err}")
    return max_err


def train_main_path():
    from repro_torch.kernels import butcher_combine as kern
    from repro_torch.launch import train_cnf
    phase("3 train (main path)")
    launches = {"butcher_combine": 0, "butcher_combine_rows": 0}
    steps = 3
    for mode in ([], ["--adaptive"]):
        label = "adaptive" if mode else "fixed"
        kern.butcher_combine.launches = 0
        kern.butcher_combine_rows.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        hist = train_cnf.main(["--dataset", "miniboone", "--steps",
                               str(steps), "--batch", "256", "--n-steps",
                               "8", "--device", "cuda"] + mode)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        one = kern.butcher_combine.launches
        rows = kern.butcher_combine_rows.launches
        for rec in hist:
            check(math.isfinite(rec["nll"]) and
                  math.isfinite(rec["grad_norm"]) and rec["grad_norm"] > 0,
                  f"train {label}: non-finite loss or gradient {rec}")
        print(f"train {label}: {steps} steps in {secs:.3f}s "
              f"nll {[round(r['nll'], 5) for r in hist]} "
              f"launches butcher_combine {one} "
              f"({one / steps:.1f}/step) butcher_combine_rows {rows} "
              f"({rows / steps:.1f}/step)")
        check(one > 0, f"train {label}: butcher_combine never launched")
        if mode:
            check(rows > 0,
                  "train adaptive: butcher_combine_rows never launched")
        launches["butcher_combine"] += one
        launches["butcher_combine_rows"] += rows
    return launches


def _loss_and_grads(cfg, params, u, eps):
    from torch.utils import _pytree as pytree
    from repro_torch.models.cnf import cnf_nll
    leaves = pytree.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    val = cnf_nll(params, u, eps, cfg)
    return val.detach(), torch.autograd.grad(val, leaves)


def _rel_close(a, b, rtol):
    return float((a - b).abs().max()) <= rtol * float(b.abs().max())


def exactness():
    import dataclasses
    from repro_torch.launch.train_cnf import make_config
    from repro_torch.models.cnf import init_cnf
    phase("4 exactness (float64)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    base = make_config("miniboone", n_steps=8)
    u = torch.randn((256, base.dim), generator=g, device=dev,
                    dtype=torch.float64)
    eps = torch.randn(u.shape, generator=g, device=dev, dtype=torch.float64)
    params = init_cnf(base, seed=3, device=dev, dtype=torch.float64)
    v_sym, g_sym = _loss_and_grads(base, params, u, eps)
    v_bp, g_bp = _loss_and_grads(
        dataclasses.replace(base, grad_mode="backprop"), params, u, eps)
    worst = max(float((a - b).abs().max() / b.abs().max())
                for a, b in zip(g_sym, g_bp))
    check(_rel_close(v_sym, v_bp, 1e-9) and
          all(_rel_close(a, b, 1e-9) for a, b in zip(g_sym, g_bp)),
          f"symplectic != backprop: worst leaf rel err {worst}")
    print(f"symplectic == backprop (fixed 8 steps, batch 256): worst leaf "
          f"rel err {worst:.3e}")
    for adaptive in (False, True):
        cfg = dataclasses.replace(base, adaptive=adaptive)
        us, es = u[:16], eps[:16]
        v_gpu, g_gpu = _loss_and_grads(cfg, params, us, es)
        cpu = {k: [{n: t.detach().cpu() for n, t in layer.items()}
                   for layer in v] for k, v in params.items()}
        v_cpu, g_cpu = _loss_and_grads(cfg, cpu, us.cpu(), es.cpu())
        worst = max(float((a.cpu() - b).abs().max() / b.abs().max())
                    for a, b in zip(g_gpu, g_cpu))
        check(_rel_close(v_gpu.cpu(), v_cpu, 1e-9) and
              all(_rel_close(a.cpu(), b, 1e-9)
                  for a, b in zip(g_gpu, g_cpu)),
              f"card != CPU reference (adaptive={adaptive}): {worst}")
        print(f"card == CPU reference (batch 16, adaptive={adaptive}): "
              f"loss {float(v_gpu):.12f} worst leaf rel err {worst:.3e}")


def memory():
    import dataclasses
    from repro_torch.launch.train_cnf import make_config
    from repro_torch.models.cnf import init_cnf
    phase("5 memory (float32, one loss+gradient)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for n_steps in (8, 32):
        for mode in ("symplectic", "backprop"):
            cfg = make_config("miniboone", n_steps=n_steps, grad_mode=mode)
            params = init_cnf(cfg, seed=0, device=dev)
            u = torch.randn((256, cfg.dim), generator=g, device=dev)
            eps = torch.randn(u.shape, generator=g, device=dev)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            _loss_and_grads(cfg, params, u, eps)
            torch.cuda.synchronize()
            out[(n_steps, mode)] = torch.cuda.max_memory_allocated() - before
        sym, bp = out[(n_steps, "symplectic")], out[(n_steps, "backprop")]
        print(f"peak_bytes n_steps={n_steps}: symplectic {sym} backprop {bp}"
              f" (ratio {bp / sym:.2f})")
        check(sym < bp, f"n_steps={n_steps}: symplectic peak {sym} not "
                        f"below backprop {bp}")
    return out


def _time_ms(fn, iters=200, warmup=20):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _device_ms(fn, name, iters=50):
    """Kernel time on the device timeline from torch.profiler, or None."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
    except RuntimeError as exc:     # CUPTI unavailable: report, don't guess
        print(f"  profiler unavailable: {exc}")
        return None
    total = 0.0
    for ev in prof.key_averages():
        if name in ev.key:
            total += getattr(ev, "device_time_total",
                             getattr(ev, "cuda_time_total", 0.0))
    return total / iters / 1e3 if total > 0 else None


def report(max_err, launches):
    from repro_torch.kernels import butcher_combine as kern
    from repro_torch.kernels import ref
    phase("6 report")
    dev = torch.device("cuda")
    dtype = torch.float32
    esize = 4
    lines = []
    # 1000003 x 9 float32 rows fit in the 50 MB L2 (L2-warm reading);
    # 8000000 x 9 do not (an HBM-bound reading)
    for n in (MAIN_N, 256, 1_000_003, 8_000_000):
        for s in (1, 6, 7):
            g = torch.Generator(device=dev).manual_seed(n + s)
            x = torch.randn(n, generator=g, device=dev, dtype=dtype)
            ks = torch.randn((s, n), generator=g, device=dev, dtype=dtype)
            hc = torch.randn((2, s), generator=g, device=dev, dtype=dtype)
            sc = torch.tensor([1.0, 0.0], dtype=dtype, device=dev)
            k2 = ks.reshape(s, -1).t()
            h0 = hc[0].contiguous()
            t_k1 = _time_ms(lambda: kern.butcher_combine(x, ks, h0))
            t_p1 = _time_ms(lambda: ref.butcher_combine_ref(x, ks, h0, 1.0))
            t_l1 = _time_ms(lambda: torch.addmv(x.flatten(), k2, h0))
            t_k2 = _time_ms(lambda: kern.butcher_combine_rows(x, ks, hc, sc))
            t_p2 = _time_ms(
                lambda: ref.butcher_combine_rows_ref(x, ks, hc, sc, 1.0))
            b1 = max((s + 2) * n * esize / HBM_BYTES_PER_S,
                     2 * s * n / F32_FLOP_PER_S) * 1e3
            b2 = max((s + 1 + 2) * n * esize / HBM_BYTES_PER_S,
                     2 * (2 * s + 1) * n / F32_FLOP_PER_S) * 1e3
            d1 = _device_ms(lambda: kern.butcher_combine(x, ks, h0),
                            "butcher_combine_kernel")
            d2 = _device_ms(lambda: kern.butcher_combine_rows(x, ks, hc, sc),
                            "butcher_combine_rows_kernel")
            lines.append(
                f"n={n:8d} s={s:2d} | combine kernel {t_k1:.6f} ms "
                f"(device {d1 if d1 is None else f'{d1:.6f}'}) plain "
                f"{t_p1:.6f} addmv {t_l1:.6f} bound {b1:.6f} | rows(m=2) "
                f"kernel {t_k2:.6f} ms (device "
                f"{d2 if d2 is None else f'{d2:.6f}'}) plain {t_p2:.6f} "
                f"bound {b2:.6f}")
            if n == MAIN_N and s == MAIN_S:
                main = dict(t_k1=t_k1, t_p1=t_p1, t_l1=t_l1, b1=b1, t_k2=t_k2,
                            t_p2=t_p2, b2=b2, d1=d1, d2=d2)
    print("float32 ms per call (CUDA events over 200 back-to-back calls, "
          "wrapper included; device = kernel time from torch.profiler):")
    for line in lines:
        print("  " + line)
    src = "src/repro_torch/csrc/butcher_combine.cu"
    rows_out = [
        {"name": "butcher_combine", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/butcher_combine.py:69",
         "launches": launches["butcher_combine"],
         "max_abs_err": max_err["butcher_combine"],
         "ms": main["t_k1"], "device_ms": main["d1"],
         "plain_ms": main["t_p1"],
         "bound_ms": main["b1"], "bound_by": "bytes",
         "library_ms": main["t_l1"],
         "shape": f"float32 n={MAIN_N} s={MAIN_S}"},
        {"name": "butcher_combine_rows", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/butcher_combine.py:110",
         "launches": launches["butcher_combine_rows"],
         "max_abs_err": max_err["butcher_combine_rows"],
         "ms": main["t_k2"], "device_ms": main["d2"],
         "plain_ms": main["t_p2"],
         "bound_ms": main["b2"], "bound_by": "bytes",
         "library_ms": None,
         "shape": f"float32 n={MAIN_N} s={MAIN_S} m=2"},
    ]
    return rows_out


def _self_device_us(ev) -> float:
    return getattr(ev, "self_device_time_total",
                   getattr(ev, "self_cuda_time_total", 0.0))


def profile_step():
    """Where a training step's time goes: one float32 loss+gradient of the
    fixed-grid MiniBooNE CNF under torch.profiler (after a warm-up step):
    wall time, summed kernel time, the device's busy share, and the kernels
    that take the most device time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.train_cnf import make_config
    from repro_torch.models.cnf import init_cnf
    phase("7 profile (one fixed-grid loss+gradient, float32)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)
    cfg = make_config("miniboone", n_steps=8)
    params = init_cnf(cfg, seed=0, device=dev)
    u = torch.randn((256, cfg.dim), generator=g, device=dev)
    eps = torch.randn(u.shape, generator=g, device=dev)
    _loss_and_grads(cfg, params, u, eps)
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            _loss_and_grads(cfg, params, u, eps)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t) * 1e6
    except RuntimeError as exc:     # CUPTI unavailable: report, don't guess
        print(f"  profiler unavailable: {exc}")
        return
    # device-side events only: a CPU op's self device time would count its
    # kernels a second time
    kernels = [ev for ev in prof.key_averages()
               if str(ev.device_type).endswith("CUDA")
               and _self_device_us(ev) > 0]
    busy_us = sum(_self_device_us(ev) for ev in kernels)
    launches = sum(ev.count for ev in kernels)
    print(f"step wall {wall_us / 1e3:.3f} ms, kernel time "
          f"{busy_us / 1e3:.3f} ms, device busy share "
          f"{busy_us / wall_us:.4f}, kernel launches {launches}")
    for ev in sorted(kernels, key=_self_device_us, reverse=True)[:8]:
        print(f"  {_self_device_us(ev) / 1e3:9.3f} ms  x{ev.count:6d}  "
              f"{ev.key[:90]}")


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output",
          flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
          f"{torch.version.cuda} device {torch.cuda.get_device_name(0)}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build()
    max_err = kernels_vs_plain()
    launches = train_main_path()
    exactness()
    memory()
    rows = report(max_err, launches)
    profile_step()
    print(f"total_seconds {time.perf_counter() - t0:.1f}")
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    os.chdir(ROOT)
    main()
