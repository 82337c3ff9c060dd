"""Build the port's kernels on the card and hold the two backward kernels
(``rms_norm_bwd``, ``flash_attention_bwd``) and the forward's row
log-sum-exp against their plain versions at a few shapes, bitwise against
a second call, then time them at the LM's training shapes (float32, CUDA
events over back-to-back calls).  The short first check of a new kernel;
``chip_smoke.py`` phase 31 is the full one.

    python3 tools/chip_bwd_check.py        # on a machine with an H100

Exits 1 when a case is out of tolerance (1e-5 / 1e-4 of max |plain| in
float32, 1e-12 in float64) or a second call differs.
"""
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

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


def main():
    t = time.perf_counter()
    _build.build_all([butcher_combine.LIBRARY, butcher_combine.ROWS_LIBRARY,
                      rn.LIBRARY, fa.LIBRARY, fa.BWD_LIBRARY])
    print(f"build {time.perf_counter() - t:.1f} s")
    for line in fa.BWD_LIBRARY.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line \
                or "warning" in line:
            print(f"  ptxas flash_attention_bwd: {line.strip()}")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bad = 0
    for dtype in (torch.float32, torch.float64):
        tol = 1e-12 if dtype == torch.float64 else 1e-5
        for rows, d in ((8192, 1024), (131072, 128), (77, 1000), (5, 16)):
            x, r, dy = (torch.randn(rows, d, generator=g, device=dev,
                                    dtype=dtype) for _ in range(3))
            w = torch.randn(d, generator=g, device=dev, dtype=dtype)
            for res in (None, r):
                dx, dw = rn.rms_norm_bwd(x, w, res, dy)
                again = rn.rms_norm_bwd(x, w, res, dy)
                want = ref.rms_norm_bwd_ref(x, w, res, dy)
                errs = (rel(dx, want[0]), rel(dw, want[1]))
                ok = max(errs) <= tol and torch.equal(dx, again[0]) and \
                    torch.equal(dw, again[1])
                bad += not ok
                print(f"rms_norm_bwd {dtype} {rows}x{d} residual="
                      f"{res is not None}: {errs} {'ok' if ok else 'BAD'}")
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
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fa.flash_attention_bwd(q, k, v, o, lse, do)
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0)
        if us > 0:
            print(f"  {us / 5 / 1e3:.4f} ms per call  {ev.key[:90]}")
    for rows, d in ((8192, 1024), (131072, 128)):
        x, dy = (torch.randn(rows, d, generator=g, device=dev)
                 for _ in range(2))
        w = torch.randn(d, generator=g, device=dev)
        print(f"rms_norm backward {rows}x{d} ms "
              f"{timed(lambda: rn.rms_norm_bwd(x, w, None, dy))}")
    print(f"cases out of tolerance: {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
