"""Build the port's kernels on the card and hold the two backward kernels
(``rms_norm_bwd``, ``flash_attention_bwd``) and the forward's row
log-sum-exp against their plain versions at a few shapes, bitwise against
a second call, then time them at the LM's training shapes (float32, CUDA
events over back-to-back calls).  The short first check of a new kernel;
``chip_smoke.py`` phase 31 is the full one.

    python3 tools/chip_bwd_check.py        # on a machine with an H100
    python3 tools/chip_bwd_check.py --rms-only --chunks 128 256 512
    python3 tools/chip_bwd_check.py --bf16

``--bf16`` checks only the bfloat16 flash backward instead: every
bfloat16 case of ``chip_smoke.py``'s phase 31 (the training shapes and the
tiles cut off-edge at every head dim) against the plain version at 2e-2
of the largest entry, bitwise against a second call, then per-call and
per-kernel times at qwen3-0.6b's and stablelm-12b's shapes beside SDPA's
bfloat16 backward and the five-product bound.  ``--rms-only`` skips flash attention; ``--chunks`` times rms_norm_bwd at
each given chunk target (``rmsnorm.DW_CHUNKS``) beside the default, at the
three training shapes (per call, each kernel alone, and ``F.rms_norm``'s
backward).  Exits 1 when a case is out of tolerance (1e-5 / 1e-4 of max |plain| in
float32, 1e-12 in float64) or a second call differs.
"""
import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from repro_torch.kernels import _build, butcher_combine  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402

CASES = [(8, 16, 8, 1024, 1024, 128, True, None, 0),
         (1, 4, 4, 128, 128, 64, True, None, 0),
         (1, 4, 1, 128, 128, 128, True, 64, 0),
         (1, 4, 2, 100, 100, 64, True, None, 0),
         (1, 4, 4, 64, 256, 64, True, None, 192),
         (1, 4, 4, 128, 128, 64, False, None, 0),
         (1, 4, 2, 200, 200, 16, True, None, 0),
         (1, 4, 2, 200, 150, 32, False, None, 0),
         (1, 16, 4, 300, 300, 128, True, 100, 0),
         (2, 8, 2, 65, 300, 64, True, 40, 235),
         # the float32 kernels' tiles cut off-edge (chip_smoke.py phase 31)
         (1, 4, 4, 77, 77, 16, True, None, 0),
         (1, 4, 2, 130, 200, 32, False, None, 0),
         (1, 8, 2, 100, 333, 64, True, None, 233),
         (1, 4, 4, 256, 256, 128, True, 8, 0),
         (2, 8, 4, 48, 300, 128, True, 20, 252),
         (1, 8, 2, 129, 129, 32, True, 5, 0)]


def check_bf16(g, dev):
    """The bfloat16 flash backward: every bfloat16 case of chip_smoke.py's
    phase 31 (``BWD_NEW_CASES``), then the times at its timed shapes
    (``BWD_VARIANTS``); returns the number of cases out of tolerance."""
    import torch.nn.functional as F
    from chip_smoke import BWD_NEW_CASES, BWD_VARIANTS
    bad = 0
    for case in BWD_NEW_CASES[torch.bfloat16]:
        B, H, Hkv, Sq, Sk, D, causal, window, q_offset = case
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        q, do = (torch.randn(B, H, Sq, D, generator=g, device=dev,
                             dtype=torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(B, Hkv, Sk, D, generator=g, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))
        o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        again = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        want = ref.attention_bwd_ref(q, k, v, o, lse, do, **kw)
        errs = [rel(a.double(), b.double()) for a, b in zip(got, want)]
        ok = max(errs) <= 2e-2 and all(
            torch.equal(a, b) for a, b in zip(got, again))
        bad += not ok
        print(f"flash_attention_bwd bfloat16 {case}: dq/dk/dv "
              f"{[f'{e:.3e}' for e in errs]} {'ok' if ok else 'BAD'}",
              flush=True)
    for case, dtype in BWD_VARIANTS.values():
        if dtype != torch.bfloat16:
            continue
        B, H, Hkv, S, _, D = case[:6]
        q, do = (torch.randn(B, H, S, D, generator=g, device=dev,
                             dtype=torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(B, Hkv, S, D, generator=g, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))
        o, lse = fa.flash_attention(q, k, v, return_lse=True)
        ms = timed(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do), 20)
        alone = kernel_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse,
                                                         do), 10)
        qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
        o_lib = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True,
                                               enable_gqa=True)
        lib = timed(lambda: torch.autograd.grad(o_lib, (qr, kr, vr), do,
                                                retain_graph=True), 20)
        bound = 2.5 * 4 * B * H * D * (S * (S + 1) // 2) / 989e12 * 1e3
        print(f"bfloat16 backward B{B} H{H}/{Hkv} S{S} D{D} causal: "
              f"{ms:.6f} ms per call, alone {sum(alone.values()):.6f} "
              f"{alone}; SDPA backward {lib:.6f}; bound {bound:.6f} (5 "
              f"products, {bound / ms * 100:.1f}%)", flush=True)
    return bad


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def timed(fn, n=10):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


# (rows, d, storage offset): the training shapes, a partial last chunk,
# fewer rows than a chunk, the scalar path (odd d, offset 1) and two walks
RMS_CASES = [(8192, 1024, 0), (131072, 128, 0), (65536, 128, 0),
             (12345, 1024, 0), (20, 128, 0), (77, 1000, 0), (5, 16, 0),
             (33, 999, 0), (64, 1024, 1), (9, 20000, 0), (5, 4099, 0)]
TRAIN_SHAPES = ((8192, 1024), (131072, 128), (65536, 128))


def kernel_ms(fn, n=20):
    """Device time per call of each kernel that ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {ev.key[:60]: round(ev.self_device_time_total / n / 1e3, 6)
            for ev in prof.key_averages() if ev.self_device_time_total > 0}


def time_rms_bwd(chunks, g, dev):
    """rms_norm_bwd at the training shapes: as it stands, then at each chunk
    target in ``chunks`` (``rmsnorm.DW_CHUNKS``)."""
    import torch.nn.functional as F
    for rows, d in TRAIN_SHAPES:
        x, dy = (torch.randn(rows, d, generator=g, device=dev)
                 for _ in range(2))
        w = torch.randn(d, generator=g, device=dev)
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = F.rms_norm(xr, (d,), wr, 1e-6)
        lib = timed(lambda: torch.autograd.grad(y, (xr, wr), dy,
                                                retain_graph=True), 50)
        bound = (3 * rows * d + 2 * d) * 4 / 3.35e12 * 1e3
        for target in [None] + list(chunks):
            saved = getattr(rn, "DW_CHUNKS", None)
            if target is not None:
                rn.DW_CHUNKS = target
            ms = timed(lambda: rn.rms_norm_bwd(x, w, None, dy), 100)
            alone = kernel_ms(lambda: rn.rms_norm_bwd(x, w, None, dy))
            split = rn._dw_chunks(rows, d)
            rn.DW_CHUNKS = saved
            total = sum(alone.values())
            print(f"rms_norm backward {rows}x{d} chunk target "
                  f"{target or saved} {split}: {ms:.6f} ms per call, alone "
                  f"{total:.6f} ({bound / total * 100:.1f}% of the "
                  f"{bound:.6f} ms byte bound) {alone}; F.rms_norm backward "
                  f"{lib:.6f}")


def time_flash_bwd(g, dev):
    q, do = (torch.randn(8, 16, 1024, 128, generator=g, device=dev)
             for _ in range(2))
    k, v = (torch.randn(8, 8, 1024, 128, generator=g, device=dev)
            for _ in range(2))
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    print(f"flash forward ms {timed(lambda: fa.flash_attention(q, k, v))}, "
          f"with lse "
          f"{timed(lambda: fa.flash_attention(q, k, v, return_lse=True))}")
    print(f"flash backward ms "
          f"{timed(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do))}")
    alone = kernel_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do), 5)
    print(f"  {alone}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rms-only", action="store_true")
    ap.add_argument("--chunks", nargs="*", type=int, default=[])
    ap.add_argument("--bf16", action="store_true")
    args = ap.parse_args(argv)
    t = time.perf_counter()
    _build.build_all([butcher_combine.LIBRARY, butcher_combine.ROWS_LIBRARY,
                      rn.LIBRARY, fa.LIBRARY, fa.BWD_LIBRARY])
    print(f"build {time.perf_counter() - t:.1f} s")
    for name, lib in (("flash_attention_bwd", fa.BWD_LIBRARY),
                      ("rms_norm_bwd", rn.LIBRARY)):
        keep = False   # the lines of the backward kernels' entries
        for line in lib.log.splitlines():
            if "Compiling" in line:
                keep = "bwd" in line
            if "warning" in line or keep and any(
                    k in line for k in ("registers", "spill", "Compiling")):
                print(f"  ptxas {name}: {line.strip()}")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    if args.bf16:
        bad = check_bf16(g, dev)
        print(f"cases out of tolerance: {bad}")
        return 1 if bad else 0
    bad = 0
    for dtype in (torch.float32, torch.float64):
        tol = 1e-12 if dtype == torch.float64 else 1e-5
        for rows, d, off in RMS_CASES:
            def view():
                return torch.randn(rows * d + off, generator=g, device=dev,
                                   dtype=dtype)[off:].view(rows, d)
            x, r, dy = view(), view(), view()
            w = torch.randn(d, generator=g, device=dev, dtype=dtype)
            for res in (None, r):
                dx, dw = rn.rms_norm_bwd(x, w, res, dy)
                again = rn.rms_norm_bwd(x, w, res, dy)
                want = ref.rms_norm_bwd_ref(x, w, res, dy)
                errs = (rel(dx, want[0]), rel(dw, want[1]))
                ok = max(errs) <= tol and torch.equal(dx, again[0]) and \
                    torch.equal(dw, again[1])
                bad += not ok
                print(f"rms_norm_bwd {dtype} {rows}x{d}+{off} residual="
                      f"{res is not None}: {errs} {'ok' if ok else 'BAD'}")
        torch.cuda.synchronize()
        if args.rms_only:
            continue
        tol = 1e-12 if dtype == torch.float64 else 1e-4
        for case in CASES:
            if dtype == torch.float64 and case[0] == 8:
                case = (2,) + case[1:]
            B, H, Hkv, Sq, Sk, D, causal, window, q_offset = case
            kw = dict(causal=causal, window=window, q_offset=q_offset)
            q, do = (torch.randn(B, H, Sq, D, generator=g, device=dev,
                                 dtype=dtype) for _ in range(2))
            k, v = (torch.randn(B, Hkv, Sk, D, generator=g, device=dev,
                                dtype=dtype) for _ in range(2))
            o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
            e_lse = float((lse - ref.attention_lse_ref(q, k, **kw).float())
                          .abs().max())
            got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
            again = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
            want = ref.attention_bwd_ref(q, k, v, o, lse, do, **kw)
            errs = [rel(a, b) for a, b in zip(got, want)]
            ok = max(errs) <= tol and e_lse < 1e-4 and all(
                torch.equal(a, b) for a, b in zip(got, again))
            bad += not ok
            print(f"flash_attention_bwd {dtype} {case}: lse {e_lse:.2e} "
                  f"dq/dk/dv {errs} {'ok' if ok else 'BAD'}")
    if not args.rms_only:
        time_flash_bwd(g, dev)
    time_rms_bwd(args.chunks, g, dev)
    print(f"cases out of tolerance: {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
