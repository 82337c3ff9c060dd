"""Serving entry points: batched LM decoding and the continuous-batching
ODE solve server.

    # batched LM serving: prefill a batch of prompts into a bfloat16 KV
    # cache, then decode token by token; --ckpt-dir serves the params of a
    # training checkpoint (launch/train.py; the same --grad-mode); a VLM
    # (internvl2-1b) prefills 4 random patch embeddings first; the enc-dec
    # model (seamless-m4t-medium) encodes random source frames (batch,
    # prompt-len, d_frontend) first
    PYTHONPATH=src python -m repro_torch.launch.serve lm --arch qwen3-0.6b \\
        [--smoke] [--batch 8 --prompt-len 1024 --gen-len 32] [--device cpu] \\
        [--ckpt-dir runs/ckpt [--grad-mode symplectic]] [--layers 8]

    # ODE solve serving: a heterogeneous request stream through
    # repro_torch.serve.SolveEngine (drain, or Poisson arrivals with --rate)
    PYTHONPATH=src python -m repro_torch.launch.serve ode [--smoke] \\
        [--naive] [--rate 40] [--device cpu]

Both run on ``cuda`` unless ``--device`` says otherwise (and raise when
there is no CUDA device).  Weights are random, from ``--seed``; LM prompts
are the synthetic token stream of ``data/tokens.py``, ODE requests the
synthetic stream of ``serve/stream.py``.  ``main`` returns the numbers it
prints.  The bare legacy form (no subcommand) routes to ``lm``.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_arch, get_smoke_arch
from repro_torch.configs.base import NodeConfig
from repro_torch.core import AdaptiveConfig, get_tableau
from repro_torch.data.tokens import synthetic_lm_batch
from repro_torch.models.encdec import init_encdec
from repro_torch.models.lm import init_lm
from repro_torch.serve import (EngineConfig, SolveEngine, latency_summary,
                               naive_sequential_solve, params_from_checkpoint,
                               poisson_arrivals, serve_timed,
                               synthetic_stream)
from repro_torch.train import (TrainConfig, init_train_state,
                               make_decode_step, make_prefill_step)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to serve on the CPU)")
    return device


def _lm_main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve lm")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the weights, the prompts and the sampler")
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the params of a TRAINING checkpoint (the "
                    "full TrainState saved by repro_torch.launch.train; "
                    "pass the --grad-mode/--node-method the training run "
                    "used, so the state trees match)")
    ap.add_argument("--grad-mode", default=None)
    ap.add_argument("--node-method", default="euler")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (a whole "
                    "number of the arch's repeat units), at full width: "
                    "jamba-v0.1-52b's 206 GB of float32 weights fit one "
                    "80 GB card as one 8-layer block")
    args = ap.parse_args(argv)

    device = _device(args.device)
    arch = get_smoke_arch(args.arch) if args.smoke else get_arch(args.arch)
    if args.layers is not None:
        arch = arch.with_(n_layers=args.layers)
        if arch.n_repeats < 1:     # n_repeats raises for a part of a unit
            raise ValueError(f"--layers {args.layers}: no whole unit")
    if args.grad_mode:
        # a node-mode arch serves with the discrete stack (models/lm.py)
        arch = arch.with_(node=NodeConfig(mode="node",
                                          method=args.node_method,
                                          grad_mode=args.grad_mode))
    if args.ckpt_dir:
        # train -> serve handoff: a fresh state is only the restore
        # template (same arch => same tree), every leaf is overwritten
        like = init_train_state(arch, TrainConfig(), seed=args.seed,
                                device=device)
        params, ck_step = params_from_checkpoint(args.ckpt_dir, like)
        print(f"[serve] restored params from {args.ckpt_dir} "
              f"step {ck_step}")
    else:
        init = init_encdec if arch.encdec else init_lm
        params = init(arch, seed=args.seed, device=device)
    # the JAX launcher's 4 random patch embeddings take the VLM's first
    # cache positions; decode starts after them (the cache holds them,
    # unlike the JAX launcher's, whose last decode writes clamp to its end)
    offset = 4 if arch.frontend == "patch" else 0
    max_len = offset + args.prompt_len + args.gen_len
    prefill = make_prefill_step(arch, args.batch, max_len)
    decode = make_decode_step(arch)

    b = synthetic_lm_batch(0, args.batch, args.prompt_len + 1, arch.vocab,
                           seed=args.seed)
    tokens = torch.as_tensor(b["tokens"], dtype=torch.long, device=device)
    batch = {"tokens": tokens}
    if offset:
        batch["patch_embeds"] = torch.randn(
            (args.batch, offset, arch.d_frontend), generator=torch.Generator(
                device=device).manual_seed(args.seed + 2), device=device)
    if arch.encdec:
        # the source: random fbank-stacked frames as long as the prompt,
        # as the JAX launcher draws them
        batch["frames"] = torch.randn(
            (args.batch, args.prompt_len, arch.d_frontend),
            generator=torch.Generator(device=device).manual_seed(
                args.seed + 1), device=device)
    sampler = torch.Generator(device=device).manual_seed(args.seed)

    _sync(device)
    t0 = time.perf_counter()
    logits, caches = prefill(params, batch)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    first_logits = logits
    finite = torch.isfinite(logits).all()
    tok = torch.argmax(logits[:, -1], -1)[:, None]
    out_tokens = [tok]
    t0 = time.perf_counter()
    for i in range(args.gen_len - 1):
        logits, caches = decode(params, caches, tok,
                                offset + args.prompt_len + i)
        finite &= torch.isfinite(logits).all()
        if args.temperature > 0:
            probs = torch.softmax(logits[:, -1] / args.temperature, -1)
            tok = torch.multinomial(probs, 1, generator=sampler)
        else:
            tok = torch.argmax(logits[:, -1], -1)[:, None]
        out_tokens.append(tok)
    _sync(device)
    t_decode = time.perf_counter() - t0

    gen = torch.cat(out_tokens, dim=1).cpu()
    steps = max(args.gen_len - 1, 1)
    print(f"[serve] arch={arch.name} device={device} batch={args.batch} "
          f"prefill {args.prompt_len} tok in {t_prefill * 1e3:.3f} ms; "
          f"decode {args.gen_len} tok in {t_decode * 1e3:.3f} ms "
          f"({t_decode / steps * 1e3:.3f} ms/tok)")
    print("[serve] sample generation (token ids):", gen[0][:16].tolist())
    return {"tokens": gen, "prefill_logits": first_logits,
            "prefill_ms": t_prefill * 1e3,
            "decode_ms": t_decode * 1e3,
            "decode_ms_per_token": t_decode / steps * 1e3,
            "logits_finite": bool(finite)}


def ode_params(dim: int, hidden: int, seed: int = 0,
               dtype: torch.dtype = torch.float32, device="cuda") -> dict:
    """The ODE server's tanh-MLP weights from ``seed``, drawn by a CPU
    ``torch.Generator`` (the same values on every device): w1 (dim,
    hidden) and w2 (hidden, dim) with entries N(0, 0.4^2), b1 and b2 with
    N(0, 0.1^2), the JAX launcher's scales."""
    gen = torch.Generator().manual_seed(seed + 17)

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, dtype=dtype)
                * scale).to(device)

    return {"w1": normal((dim, hidden), 0.4), "b1": normal((hidden,), 0.1),
            "w2": normal((hidden, dim), 0.4), "b2": normal((dim,), 0.1)}


def ode_field(x, t, p):
    """dx/dt = tanh(x w1 + b1) w2 + b2."""
    return torch.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def ode_config(max_steps: int) -> AdaptiveConfig:
    """The server's controller: rtol 1e-4, atol 1e-6 for lanes no request
    has taken yet, initial step 0.02."""
    return AdaptiveConfig(rtol=1e-4, atol=1e-6, max_steps=max_steps,
                          initial_step=0.02)


def _ode_main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve ode")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes: rot-check that the engine runs")
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the weights, the stream and the arrivals")
    ap.add_argument("--method", default="dopri5")
    ap.add_argument("--buckets", type=int, nargs="+", default=[4, 8, 16])
    ap.add_argument("--max-steps", type=int, default=512)
    ap.add_argument("--rate", type=float, default=None,
                    help="offered load in requests/s (Poisson arrivals); "
                    "default: submit everything up front and drain")
    ap.add_argument("--naive", action="store_true",
                    help="also run the sequential single-solve baseline")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.smoke:
        args.dim, args.hidden = 4, 8
        args.requests = min(args.requests, 8)
        args.buckets = [2, 4]

    device = _device(args.device)
    dim, tab = args.dim, get_tableau(args.method)
    params = ode_params(dim, args.hidden, args.seed, device=device)
    cfg = ode_config(args.max_steps)
    reqs = synthetic_stream(args.requests, dim, seed=args.seed,
                            device=device)

    t0 = time.perf_counter()
    engine = SolveEngine(ode_field, tab, cfg, params,
                         x0_template=torch.zeros(dim, device=device),
                         engine_cfg=EngineConfig(buckets=tuple(args.buckets)))
    _sync(device)
    t_init = time.perf_counter() - t0
    print(f"[serve ode] engine up in {t_init:.3f}s on {device} (each "
          f"bucket of {tuple(args.buckets)} warmed)")

    arrivals = None
    if args.rate is not None:
        arrivals = poisson_arrivals(args.requests, args.rate, seed=args.seed)
    t0 = time.perf_counter()
    results = serve_timed(engine, reqs, arrivals)
    _sync(device)
    wall = time.perf_counter() - t0
    ok = sum(r.succeeded for r in results.values())
    lat = latency_summary(results)
    print(f"[serve ode] {len(results)} requests ({ok} ok) in {wall:.3f}s "
          f"-> {len(results) / wall:.3f} req/s"
          + (f" at offered {args.rate:.3f} req/s" if args.rate else
             " (drain mode)"))
    print(f"[serve ode] latency p50 {lat['p50_ms']:.3f} ms, "
          f"p99 {lat['p99_ms']:.3f} ms; engine stats {engine.stats}")
    out = {"requests": len(results), "ok": ok, "wall_s": wall,
           "rps": len(results) / wall, "engine_init_s": t_init,
           "stats": engine.stats, **lat}

    if args.naive:
        sols, lats = naive_sequential_solve(ode_field, tab, cfg, params,
                                            reqs)
        wall_n = float(np.sum(lats))       # steady state: warmup excluded
        ok_n = sum(bool(s.succeeded) for s in sols)
        print(f"[serve ode] naive sequential: {len(reqs)} requests ({ok_n} "
              f"ok) in {wall_n:.3f}s -> {len(reqs) / wall_n:.3f} req/s; "
              f"per-solve p50 {np.percentile(lats, 50) * 1e3:.3f} ms")
        out["naive"] = {"ok": ok_n, "wall_s": wall_n,
                        "rps": len(reqs) / wall_n,
                        "p50_ms": float(np.percentile(lats, 50) * 1e3),
                        "p99_ms": float(np.percentile(lats, 99) * 1e3)}
    return out


def main(argv: Optional[Sequence[str]] = None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("lm", "ode"):
        return {"lm": _lm_main, "ode": _ode_main}[argv[0]](argv[1:])
    # legacy spelling: no subcommand = the LM flags
    return _lm_main(argv)


if __name__ == "__main__":
    main()
