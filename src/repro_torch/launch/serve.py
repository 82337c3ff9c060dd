"""Serving entry point: batched LM decoding (prefill a batch of prompts into a
bfloat16 KV cache, then decode token by token).

    PYTHONPATH=src python -m repro_torch.launch.serve lm --arch qwen3-0.6b \\
        [--smoke] [--batch 8 --prompt-len 1024 --gen-len 32] [--device cpu]

Runs on ``cuda`` unless ``--device`` says otherwise (and raises when there
is no CUDA device).  Weights are random, from ``--seed``; prompts are the
synthetic token stream of ``data/tokens.py``.  ``main`` returns the
generated tokens and the timings it prints.  The bare legacy form (no
subcommand) routes to ``lm``; the ``ode`` subcommand (the continuous-
batching ODE engine) is not ported yet (ROADMAP queue 1, item 12).
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Sequence

import torch

from repro_torch.configs import get_arch, get_smoke_arch
from repro_torch.data.tokens import synthetic_lm_batch
from repro_torch.models.lm import init_lm
from repro_torch.train import make_decode_step, make_prefill_step


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to serve on the CPU)")
    arch = get_smoke_arch(args.arch) if args.smoke else get_arch(args.arch)
    params = init_lm(arch, seed=args.seed, device=device)
    max_len = args.prompt_len + args.gen_len
    prefill = make_prefill_step(arch, args.batch, max_len)
    decode = make_decode_step(arch)

    b = synthetic_lm_batch(0, args.batch, args.prompt_len + 1, arch.vocab,
                           seed=args.seed)
    tokens = torch.as_tensor(b["tokens"], dtype=torch.long, device=device)
    sampler = torch.Generator(device=device).manual_seed(args.seed)

    _sync(device)
    t0 = time.perf_counter()
    logits, caches = prefill(params, {"tokens": tokens})
    _sync(device)
    t_prefill = time.perf_counter() - t0

    finite = torch.isfinite(logits).all()
    tok = torch.argmax(logits[:, -1], -1)[:, None]
    out_tokens = [tok]
    t0 = time.perf_counter()
    for i in range(args.gen_len - 1):
        logits, caches = decode(params, caches, tok, args.prompt_len + i)
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
    return {"tokens": gen, "prefill_ms": t_prefill * 1e3,
            "decode_ms": t_decode * 1e3,
            "decode_ms_per_token": t_decode / steps * 1e3,
            "logits_finite": bool(finite)}


def _ode_main(argv=None):
    raise NotImplementedError(
        "serve ode (the continuous-batching ODE engine) is not ported to "
        "repro_torch yet (ROADMAP queue 1, item 12)")


def main(argv: Optional[Sequence[str]] = None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("lm", "ode"):
        return {"lm": _lm_main, "ode": _ode_main}[argv[0]](argv[1:])
    # legacy spelling: no subcommand = the LM flags
    return _lm_main(argv)


if __name__ == "__main__":
    main()
