"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each fatal on failure (any failure exits non-zero and prints no
result line):

  1. build   — compile the five CUDA sources of ``src/repro_torch/csrc``
               (one nvcc each, in parallel) and load them (build seconds
               and ptxas registers/spills are printed).
  2. kernels — each kernel against its plain PyTorch version on the card:
               float32/float64/bfloat16, n in {256*43, 256, 1, 127,
               1000003}, s in {1, 6, 7, 12, 13}, m = 2 rows; then the lane
               forms (one coefficient row per lane): B in {1, 3, 256},
               n_lane in {1, 43, 44, 4096}, the same s, m in {1, 2, 13} for
               rows, at storage offsets 0 and 1.  Tolerance:
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
               larger), the host cost per call of the kernel and of the
               library call (a host clock over 1000 calls with no
               synchronise), the kernel/library ratio of the times per
               call, and a ``kernels`` JSON line whose ``ms`` is the time
               per call including the wrapper, ``device_ms`` the kernel
               alone and ``host_ms`` the wrapper's host cost.
  7. profile — one fixed-grid loss+gradient under torch.profiler: wall
               time, kernel time, the device's busy share, top kernels.

The LM serving slice (qwen3-0.6b, float32 weights, bfloat16 KV cache):

  8. LM kernels vs plain — rms_norm at rows x d in {8192x1024, 131072x128,
               4099x1000, 77x16} and at decode's {8x1024, 128x128,
               64x128}, with and without residual; flash
               attention on the JAX package's eight kernel-test cases, head
               dims 16 and 32, 65 queries against 4096 and 8192 keys, a
               GQA group of 4 with a window, and the prefill shape
               (8, 16/8, 1024, 128) causal; float32 and bfloat16.
               |kernel - plain| <= atol + rtol*|plain| with (rtol, atol) (1e-6, 1e-6) / (1e-5, 1e-5) in float32 and one
               bfloat16 ulp / 2e-2 in bfloat16.
  9. serve   — the main path: ``repro_torch.launch.serve lm --arch
               qwen3-0.6b`` at full width, batch 8, prompt 1024, 32 tokens
               (after a 2-token warm-up); prefill ms, decode ms/token, and
               the launch counters, zeroed just before: 113 rms_norm per
               forward and 28 flash_attention per prefill.  Logits finite.
 10. serve vs plain — the same prefill and 4 decode steps with the kernels
               and with the plain versions (``use_kernels=False``) on the
               card, fed the same tokens: logits within 1e-3 of max|plain
               logits|; launches per prefill and per decode step; greedy
               token agreement (reported, not a pass condition).
 11. card vs CPU — the smoke width, the same seed weights on both devices:
               prefill + 4 decode logits within 1e-5 of max|CPU logits|
               with a float32 KV cache, within 1e-3 with the path's
               bfloat16 cache (entries may round the other way).
 12. report  — float32 ms per call of both LM kernels at the serving shapes,
               their plain versions, one library call (F.rms_norm,
               F.scaled_dot_product_attention) and the bound: bytes over
               3.35 TB/s (rms_norm); for flash attention 3 x the causal
               flops over 495 TFLOP/s (3xTF32 on the tensor cores, its
               float32-accurate least time; the float32-FMA bound at
               67 TFLOP/s printed beside it); host cost per call of the
               kernel and the library call, as in phase 6, and the
               kernel/library ratio.
 13. profile — one prefill and one decode step under torch.profiler.

The per-sample CNF slice (``solve(..., batch_axis=0)``: a step controller
per sample, the lane forms of both combines):

 14. per-sample train — the main path: 3 float32 SGD steps of the trainer
               with ``--adaptive --per-sample`` (dim 43, hidden (64, 64),
               batch 256 = 256 lanes, dopri5, Hutchinson, rtol 1e-4, atol
               1e-6, max_steps 48, symplectic adjoint); seconds per step,
               both combines' launch counters (zeroed just before, both >
               0), loss and gradient finite.  Then the solver on step 0's
               batch and weights: attempts, accepted steps per lane (min,
               median, max), failed lanes, launches per attempt at B 256
               and B 16 (must be equal), and host reads per attempt (CUDA
               synchronisations counted by ``torch.cuda``'s sync debug
               mode: must be 1).
 15. per-sample exactness — float64, B 16, the same widths: the
               ``batch_axis=0`` symplectic gradient equals DirectBackprop
               through the batched driver and the mean of 16 single-sample
               symplectic gradients, to rtol 1e-9 (phase 4's rule).
 16. per-sample memory — peak allocated bytes of one float32 B 256
               per-sample loss+gradient, symplectic vs DirectBackprop:
               symplectic must be below.
 17. lane report — float32 ms per call, alone and host of both lane forms
               at the per-sample shape (B 256, n_lane 43, s 7; m 2), their
               plain versions, the bound (bytes over 3.35 TB/s, coefficient
               rows included), one ``torch.baddbmm`` for the one-row form,
               and launches per per-sample attempt.
 18. profile — one per-sample loss+gradient under torch.profiler.

The paper's baselines (``RematStep``, ``RematSolve``, ``ContinuousAdjoint``
beside the symplectic adjoint and DirectBackprop):

 19. Table 1 — one float32 MiniBooNE loss+gradient (batch 256, Hutchinson)
               for all five strategies, dopri5 at N = 8 and 32 and bosh3 /
               dopri8 at N = 8: peak allocated bytes and both combines'
               launches of the first (warm-up) call, then the median ms of
               2 or 3 synchronised calls; one line per case and a table.
               Fatal: at N = 32 symplectic < remat_step < remat_solve,
               remat_step < backprop and adjoint < remat_step in peak
               bytes; the adjoint's peak at N = 32 within 1.2x of N = 8.
 20. baselines exactness — float64, fixed 8 steps, batch 256: remat_step
               and remat_solve equal DirectBackprop to rtol 1e-9 (phase 4's
               rule); the adjoint's error against it is printed (finite,
               non-zero); at batch 16 the adjoint on the card equals the
               port's CPU result to 1e-9, fixed and adaptive.
 21. baselines train — the main path of this slice: 2 float32 SGD steps
               of the trainer for ``--grad-mode remat_step``,
               ``remat_solve``, ``adjoint`` and ``adjoint --adaptive``:
               loss and gradient finite, butcher_combine launched (and the
               rows kernel for the adaptive adjoint), counted from 0
               around each run.
 22. per-sample adjoint memory — peak bytes of one float32 B 256
               ``--adaptive --per-sample --grad-mode adjoint``
               loss+gradient at max_steps 48 and 96: within 5 % of each
               other (neither adjoint solve records its steps), printed
               beside phase 16's symplectic and DirectBackprop.

SaveAt (observations at user times) and the models that observe through
it (the physics workload of the paper's Table 4, the CNF flow path):

 23. physics train — the main path of this slice: 3 float32 SGD steps of
               ``repro_torch.launch.train_physics`` at the example's full
               settings (KdV, grid 64, dx 0.5, channels 16, hidden 64,
               dopri8, 4 steps per snapshot interval, 6 trajectories x 16
               snapshots of 80 substeps, batch 32, lr 3e-3, symplectic),
               then its held-out rollout (one SaveAt(ts) solve, horizon 7):
               seconds per step, losses and rollout MSE finite, the
               combines' launches of the run (zeroed just before, > 0) and
               of one loss+gradient alone, and that loss+gradient under
               torch.profiler (busy share, top kernels).
 24. SaveAt cells — one float32 ``rollout_loss`` loss+gradient (horizon
               ``SAVEAT_HORIZON``, 2: 32 windows of 3 consecutive snapshots
               of phase 23's trajectories; KdV, dopri8, fixed 4 steps per interval) for
               all five strategies, then the adaptive ts cells (symplectic,
               backprop, adjoint; rtol 1e-6, atol 1e-8, max_steps 64)
               single and ``per_sample=True``: peak allocated bytes and
               combine launches of the first call, median ms of 3 more;
               then the one-row kernel's ms at the new call shapes
               (dopri8's s 12 and 13 at n 32 x 64, the Hermite lane rows)
               beside its plain version, addmv / baddbmm and the bound.
 25. SaveAt exactness (float64) — the symplectic ts gradient equals
               DirectBackprop's (fixed, adaptive, per-sample; rtol 1e-9 of
               the largest entry per leaf); the card equals the port's CPU
               result on the same inputs (values, gradients rtol 1e-9,
               integer stats equal) for the threaded ts cells; dense
               output: stats equal, values rtol 1e-9, and values and
               gradients rtol 1e-9 against a CPU replay of the card's
               accepted grid (each device's grid moves at rounding level
               and the Hermite interpolant with it: the CPU's own change
               under a 1e-15 change of the input is printed); Hermite
               dense output at the accepted steps' start times equals the
               checkpoints (rtol 1e-12).
 26. SaveAt memory on the CNF — MiniBooNE, dim 43, hidden (64, 64), batch
               256, dopri5, float32: the symplectic SaveAt(ts) flow path
               with 8 equal segments x 4 steps against SaveAt(t1) with N 32
               (the same 32 checkpoints), each peak from a second call:
               peaks within 10 % of the t1 peak plus the 8 observations'
               bytes; DirectBackprop printed the
               same way; per-sample adaptive ts against t1 printed, with
               the lane driver's residual rows.
 27. CNF flow path — ``cnf_flow_path`` at MiniBooNE width, batch 256, 8
               observation times ending at t1, fixed (1 step per segment,
               the grid of cnf_forward's 8 steps) and per-sample: the
               endpoint equals ``cnf_forward`` (float32 rtol 1e-5, float64
               rtol 1e-12; per-sample with ts = [t1]); ms and launches.

The continuous-batching ODE solve server (``repro_torch.serve``,
``repro_torch.launch.serve ode``):

 28. serve ode — the main path: ``benchmarks/bench_serve.py::main``'s
               configuration (tanh-MLP field, dim 1024, hidden 1024,
               dopri5, float32; 20 requests of horizons in [0.5, 1.0] and
               three tolerance pairs, stream seed 7; engine rtol 1e-4, atol
               1e-6, initial_step 0.02, max_steps 96, buckets (8, 16)),
               weights from seed 0, through the port's API: the naive
               sequential baseline (after a warm-up pass), a drain run on a
               fresh engine after one throwaway run, and Poisson-paced runs
               at 0.5x and 1.5x the naive rate.  Per run: req/s, p50/p99
               latency, the engine's stats, both combines' launches and the
               CUDA synchronisations (sync debug mode), each per engine
               step; engine_init_s.  Fatal: a request failed, no request
               joined a running batch, the lanes did not grow to 16,
               launches per step other than 6 one-row + 1 rows (lane
               forms), or more synchronisations than one per eviction sweep
               plus one per harvested lane.  Then the CLI at its defaults
               (``serve ode --naive``: dim 32, hidden 64, 64 requests,
               buckets 4 8 16, max_steps 512): every request succeeds.
 29. serve exactness — float64, dim 8, hidden 16, 10 requests, buckets
               (2, 4, 8): each request served out of the shared state
               equals it served alone at the same bucket bitwise, and alone
               at B 2 with equal stats and rtol 1e-12; the card's engine
               equals the port's CPU engine on the same stream (stats
               equal, rtol 1e-9); the slot state moved card -> host -> card
               after 5 steps finishes bitwise as the uninterrupted run.
 30. serve report — float32 ms per call, alone and host of both lane forms
               at the engine's shape (B 16, n_lane 1024, s 7; m 2), their
               plain versions, one ``torch.baddbmm`` (one-row form) and the
               byte bound; one engine step (16 lanes occupied) under
               torch.profiler.

LM training (``repro_torch.launch.train``: qwen3-0.6b at full width,
float32, discrete with remat and node mode with the symplectic adjoint over
depth; the backward kernels of rms_norm and flash attention):

 31. backward kernels vs plain — ``rms_norm_bwd`` at rows x d 8192 x
               1024, 131072 x 128 and 65536 x 128 (a training step's), 12345
               x 1024 (a partial last chunk), 20 x 128 (under one chunk), 77
               x 1000 and 5 x 16, with and without residual; ``flash_attention_bwd`` at the LM's shape
               (B 8, H 16/8, S 1024, D 128, causal; B 2 in float64) and at
               window, q_offset, Sq != Sk, D 16/32/64 cases; the forward's
               row log-sum-exp against the plain one (1e-4).  Tolerance:
               max |kernel - plain| <= 1e-4 (dq/dk/dv) / 1e-5 (dx/dw) of
               max |plain| in float32, 1e-12 in float64; a second call
               bitwise equal.  Then ms per call of both backward kernels
               (rms_norm_bwd at the three training shapes; the forward with
               and without ``return_lse``), their plain versions, the
               library call's backward (``F.rms_norm``,
               ``F.scaled_dot_product_attention``; for the forward with the
               lse, memory-efficient attention with ``compute_log_sumexp``,
               K/V expanded to 16 heads untimed), float32, and the bound;
               fatal where rms_norm_bwd per call is slower than
               ``F.rms_norm``'s backward;
               the kernels' device time alone from torch.profiler in a
               process of its own (``python3 chip_smoke.py
               --bwd-device-times``: late in this long process the
               profiler loses kernel records), every kernel of each call
               counted; the phase fails without it.
 32. LM train — the main path of this slice: ``launch.train.main`` at
               full width, in a process of its own (``chip_smoke.py
               --lm-train``: the launcher's deterministic algorithms need
               cuBLAS's fixed workspace set before CUDA starts, and that
               setting costs the other phases host time), batch 8 x seq
               1024, 3 discrete steps (remat) and
               3 node steps (``--grad-mode symplectic --node-method euler``,
               28 steps), counters zeroed before each run: s/step, loss
               (finite), launches per step of every kernel (each > 0 where
               the path runs it); one step of each under torch.profiler
               (busy share, kernels by time); the CUDA synchronisations of
               one node loss+gradient (the unit index is read to the host
               once per field evaluation).
 33. LM exactness (float64, 28 layers, full width, batch 1 x seq 128) —
               node-symplectic gradient vs DirectBackprop through the same
               node solve (rtol 1e-9 per leaf, phase 4's rule); node (euler,
               n_steps 28) vs the discrete stack: loss rtol 1e-8, each
               gradient leaf ||diff|| <= 1e-8 ||ref|| (max-based printed);
               the unit sequence of the solve equal to 0..27.
 34. LM memory — peak allocated bytes of one float32 loss+gradient (batch
               8 x 1024): discrete without remat, discrete with remat,
               node-symplectic, at the trainer's loss chunk 512 and at 64
               (where the head's logits block no longer sets the peak;
               node-symplectic's printed beside remat's); fatal unless
               symplectic < discrete without remat at both (the paper's
               ordering), and where node-symplectic's chunk-64 peak passes
               5.5 GB (the zero cotangents of untouched units are back).
 35. resume — three ``python -m repro_torch.launch.train`` processes at
               full width and 4 of the 28 layers (``--layers 4``, cut for
               the script's time), float32, batch 4 x seq 512,
               4 steps: one
               uninterrupted and, beside it on the card, one killed once
               its step-2 checkpoint is published; then one that resumes
               from it.  The metrics lines
               (loss, grad_norm, lr) of the resumed steps bitwise equal the
               uninterrupted run's.
 36. train -> serve — ``launch.serve lm --ckpt-dir`` boots from phase 35's
               step-4 checkpoint: its prefill logits equal (bitwise) those
               computed here from the checkpoint's params.

Phase 2 also holds the kernels against their plain versions at this
slice's new call shapes: the Hermite lane rows (s 3, 8 lanes, the CNF's and
the physics' leaves) and dopri8's s 12 (and 13 with the FSAL error slope)
one-row and rows calls at the physics shape (n 32 x 64).

The mesh (``repro_torch.parallel``), each phase in a process of its own
(38 and, below, 41 run beside phases 33-35, which time nothing either: they
print when joined after phase 35):

 37. mesh solve — a world of 1 over NCCL: phase 14's per-sample CNF (256
               lanes, dopri5, rtol 1e-4 / atol 1e-6, max_steps 48) through
               ``solve(..., batch_axis=0, mesh=)`` for the symplectic and
               continuous adjoints, fixed and adaptive, t1 and SaveAt(ts):
               loss, values, stats, success and gradients bitwise those of
               ``solve()``; no collective in the forward, one all_reduce
               per parameter leaf in the backward; peak bytes and ms of
               one loss+gradient with and without the mesh.
 38. mesh over gloo — 2 ranks sharing the card, 128 lanes each, float64:
               each rank's block bitwise the single-process solve of that
               block, stats equal to the full width's, gradients within
               1e-12; combine launches per rank.
 39. serve on a mesh — phase 28's server with ``EngineConfig(mesh=)`` (a
               world of 1): results bitwise the no-mesh engine's, the slot
               state DTensors on the lane axis, req/s and collectives per
               engine step beside the no-mesh engine's.
 40. data-parallel training — ``launch.train --mesh debug`` (ZeRO-1, a
               world of 1, NCCL) for 3 discrete steps at batch 8 x 1024:
               metrics bitwise phase 32's discrete run's; s/step, the
               collectives per step, and peak bytes.  Then ``--microbatches
               2 --compression int8`` without and with ``--mesh debug``:
               metrics bitwise, collectives per step by kind exactly (every
               leaf reduced whole, the loss, the norm, ZeRO-1's gathers).
 52. tensor parallelism — 2 gloo ranks sharing the card on a ("data" 1,
               "model" 2) mesh (``python3 chip_smoke.py --mesh 52``):
               qwen3-0.6b at full width cut to ``TP_LAYERS`` (4) of its 28
               layers, batch 8 x 1024, float32, ZeRO-1, 2 discrete steps
               (remat) and 1 node-symplectic step, each from the seed-0
               state, against the same steps in one process (in this
               process, before the ranks start): loss and grad_norm within
               ``TP_LOSS_RTOL`` / ``TP_GNORM_RTOL``, the ranks' params that
               "model" does not split bitwise equal, launches per step of
               every kernel equal to the single process's (flash at H 8/4,
               rms_norm on 512 of the 1024 positions), the collectives per
               step exactly ``step_collectives``; s/step, bytes per step by
               kind and peak bytes per rank.
 53. tensor parallelism of the zoo — the same mesh (``python3
               chip_smoke.py --zoo-tp``): deepseek-v2-lite-16b at 3 of its
               27 layers, 2 discrete steps TP-in-expert, 1 node-symplectic
               step, 1 discrete step expert parallel; internvl2-1b at 4 of
               24 layers with 256 patches + 768 tokens, 1 step; each
               against a single-process run (in this process, before the
               ranks start) whose expert choices the ranks replay: loss and grad_norm within
               ``ZOO_TP_LOSS_RTOL`` / ``ZOO_TP_GNORM_RTOL``, the ranks' own
               top-k choices and unsplit params bitwise equal, each named
               kernel launched, the collectives exactly
               ``step_collectives``; the unforced share of rerouted rows,
               s/step, bytes per step and peak bytes per rank.

The recurrent archs and the enc-dec model on a mesh (``python3
chip_smoke.py --rec-tp`` alone), its single-process runs in the script's
process while its two rank processes start:

 54. tensor parallelism of Mamba, xLSTM and the enc-dec model — phase 53's
               mesh: jamba-v0.1-52b at its layer 0 (Mamba with a dense
               FFN) with Mamba laid out by channel and laid out whole
               (``extra_replicated=MAMBA_PARAM_NAMES``); xlstm-1.3b at 8
               of its 48 layers, discrete and node-symplectic, its labels
               past position ``REC_TP_KEEP`` (32) IGNORE (the random
               sLSTM's float32 gradient overflows beyond ~100 steps) and
               its forward replayed (``_TrainReplay``: each layer's input
               and each sLSTM step's state from the single-process run);
               seamless-m4t-medium at 2 of 12 layers each side, 1024
               source frames and 256 target tokens; batch 8, one step
               each against a single-process run (in the phase's process,
               before the ranks start): loss and grad_norm within
               ``REC_TP_LOSS_RTOL`` / ``REC_TP_GNORM_RTOL``, the ranks'
               unsplit params bitwise equal, each named kernel launched,
               the collectives exactly ``step_collectives``; s/step, bytes
               per step by kind and peak bytes per rank.

The auditor, in a process of its own (``python3 chip_smoke.py --mesh 41``):

 41. analysis — ``repro_torch.analysis.run_analysis(device="cuda")``: every
               enumerated case with the combine kernels, the sharded cells
               on an in-process gloo world of 1 with CUDA tensors, the
               engine's ``advance_in_place``; no ERROR finding against the
               committed ``cuda`` budgets (without them, the counts go to
               ``chiprun_out/analysis_counts_cuda.json``); both combines
               launched under it; every gradient records backward ops; six
               cases with the plain combines on the card and on the CPU
               (their op counts and the op names the card adds or drops,
               printed); then the memory rule, each strategy x (dopri5,
               bosh3) x N (8, 64) at dim 8, hidden 1024 (float64): the
               recorder's peak beside ``max_memory_allocated`` above the
               inputs, the same growth class per row and no memory-bound
               finding from either.

The LM zoo's attention-and-expert half, in a process of its own
(``python3 chip_smoke.py --zoo``: deepseek-v2-lite-16b's 62.8 GB of float32
weights need a card no earlier phase has filled):

 42. zoo kernels vs plain — flash at head dim 160 (stablelm-12b's prefill
               (8, 32/8, 1024, 160) causal, 65 queries against 4096 keys
               with an offset, a window), internvl2-1b's GQA group of 7 and
               mixtral's window 4096 at 8192 (against the blocked plain
               version, its plain route), float32 and bfloat16, at phase
               8's tolerances; ``attention_blocked_ref`` against
               ``attention_ref`` at two shapes both hold (1e-5); rms_norm at
               d 512 (MLA's kv_norm), 896, 2048, 2304, 4096, 5120.  Then ms
               per call of rms_norm at those widths and of flash at D 160
               and at mixtral's window beside the plain version, SDPA (a
               boolean mask for the window) and the bound.
 43. zoo serve — the main path of this slice: ``launch.serve lm --arch
               deepseek-v2-lite-16b`` at full width and depth (27 layers,
               MLA, 64 experts top-6 + 2 shared), batch 8, prompt 1024, 32
               tokens after a 2-token warm-up: prefill ms, decode ms/token,
               ``max_memory_allocated``, launches (82 rms_norm per forward,
               no flash: MLA attends with the plain version, as in JAX).
 44. deepseek kernels vs plain — prefill and 4 decode steps with the
               kernels and with ``use_kernels=False`` fed the same tokens;
               the plain side routed by the kernel side's expert choices
               (``_Gates(forced=...)``), so both differ by rounding alone:
               logits and every position's final hidden state within 1e-3
               of the plain side's largest.  A third run routed on its own
               reports the rows and positions routed differently beside
               the bound fixed before the first card run (0.5; exceeded,
               PERF.md).  One prefill and one decode step under the
               profiler.
 45. the other five at full width — stablelm-12b, qwen3-1.7b, minicpm-2b,
               internvl2-1b (256 patch embeddings before 768 tokens) and
               mixtral-8x7b (8 of its 32 layers, batch 1 x 8192, window
               4096: the plain side's attention takes the blocked route):
               prefill and 4 decode steps, kernels vs plain as in 44,
               launches per prefill and decode step, ms.
 46. zoo card vs CPU (smoke width) — the six archs from the same CPU-made
               weights: prefill and 4 decode steps, the card routed by the
               CPU's choices, float32 cache at 1e-5 and bfloat16 cache at
               1e-3 (the card decoding from the CPU's cache contents, the
               caches held to one bfloat16 ulp + 1e-5 of the largest entry
               apart); then one training step per arch (the backward
               kernels at the smoke head dims), loss and params at 1e-5.

The LM zoo's recurrent and enc-dec half, in a process of its own
(``python3 chip_smoke.py --zoo2``: jamba's one block holds 53.2 GB):

 47. flash at the enc-dec shapes — seamless-m4t-medium's encoder (8,
               16/16, 1024 x 1024, D 64, non-causal) and cross-attention
               (256 x 1024, Sq != Sk), jamba's attention (GQA 32/8, D 128,
               causal), float32 and bfloat16 against the plain version at
               phase 8's tolerances, the float32 error printed per case;
               then ms per call of the two enc-dec shapes beside the plain
               version, SDPA and the bound.  Then flash's backward at
               seamless's per-rank training shapes on "model" 2 (phase
               54's: 8 heads, the encoder 1024 x 1024, the cross-attention
               256 x 1024, the decoder's causal 256 x 256; D 64) against
               its plain version (``BWD_TOL``), and timed the same way.
 48-50. jamba-v0.1-52b (8 of its 32 layers: one block), xlstm-1.3b (8
               of its 48 layers, one block, for the script's time) and
               seamless-m4t-medium (random frames (8, 1024, 160)) served
               through ``launch.serve lm`` at full width, batch 8 x 1024,
               32 tokens: prefill ms, decode ms/token,
               ``max_memory_allocated``, rms_norm and flash launches as the
               layer specs give them; then kernels vs plain (prefill and 4
               decode steps, 1e-3 of the plain side's largest logit and
               final hidden state; jamba's plain side routed by the
               kernels' expert choices, the unforced share reported;
               xlstm's plain side started per layer and per sLSTM step from
               the kernels' inputs (``_Trajectory``: the model is chaotic
               under rounding at full width), every layer's output and
               every sLSTM step's new state held to the same 1e-3 of the
               plain side's largest entry, the unforced divergence
               reported); one prefill and one decode step under the
               profiler (every launch counted).
 51. card vs CPU (smoke width) — the three archs as phase 46, each run on
               its own (jamba's card side also routed by the CPU's
               choices; the enc-dec prefill reading the CPU's cross K/V in
               the bfloat16 variant, the card's own held apart), and
               against a float64 CPU run (``repro_torch.float64.lifted``):
               with the float32 cache the logits, the final hidden states
               and each cache tensor are held to 1e-5 of the CPU's largest
               entry, or to twice the CPU float32 run's own distance from
               the float64 one where that is larger; the train steps and
               xlstm's node-mode step (euler, symplectic) leaf by leaf by
               the same rule.

The combines' ``launches`` in the ``kernels`` line sum phases 3, 21, 23,
24, 27 and 41 (``launches_by_path`` splits them; the lane forms' rows sum
phase 14, the per-sample cells of phases 24 and 27 and phase 28's drain
run, and carry phase 30's numbers as ``serve_shape``); rms_norm's and
flash's add the zoo's paths (phases 43, 45 and 48-50; flash at D 160 has
its own row, ``flash_attention_d160``, from stablelm-12b's run; flash's
row carries phase 47's enc-dec shapes as ``encdec_shapes``).  The card's
name and power limit are printed early; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import json
import math
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
LM_TRAIN_CHILD = "--lm-train"
BWD_TIMES_CHILD = "--bwd-device-times"
MESH_CHILD = "--mesh"
if sys.argv[1:] == [LM_TRAIN_CHILD] or sys.argv[1:3] == [MESH_CHILD, "40"]:
    # phase 32's own process: the training launcher turns on deterministic
    # algorithms, which need cuBLAS's fixed workspace set before CUDA
    # starts; the rest of the script runs without it (it costs host time
    # per GEMM call: PERF.md §7)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
F32_FLOP_PER_S = 67e12           # H100 SXM float32, outside the tensor cores
TF32_FLOP_PER_S = 495e12         # H100 SXM TF32 on the tensor cores, dense
BF16_FLOP_PER_S = 989e12         # H100 SXM bfloat16 on the tensor cores, dense
MAIN_N = 256 * 43                # the CNF state leaf: batch 256 x dim 43
MAIN_S = 7                       # dopri5
LANE_B = (1, 3, 256)             # lane counts of phase 2's lane forms
LANE_N = (1, 43, 44, 4096)       # elements per lane (43: the per-sample x)
LANE_M = (1, 2, 13)              # rows of the rows kernel's lane form
PER_SAMPLE = ["--dataset", "miniboone", "--batch", "256", "--n-steps", "8",
              "--adaptive", "--per-sample", "--device", "cuda"]


def fail(msg: str):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


_T0 = time.perf_counter()


def phase(name: str):
    print(f"== {name} [t {time.perf_counter() - _T0:.1f} s]", flush=True)


# ---------------------------------------------------------------------------

def build():
    from repro_torch.kernels import _build
    from repro_torch.kernels import butcher_combine, flash_attention, rmsnorm
    phase("1 build")
    t = time.perf_counter()
    logs = _build.build_all([butcher_combine.LIBRARY,
                             butcher_combine.ROWS_LIBRARY, rmsnorm.LIBRARY,
                             flash_attention.LIBRARY,
                             flash_attention.BWD_LIBRARY])
    print(f"build_seconds {time.perf_counter() - t:.2f} (one nvcc per "
          f"source, in parallel)")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line or \
                    "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")


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
    max_err = {"butcher_combine": 0.0, "butcher_combine_rows": 0.0,
               "butcher_combine_lanes": 0.0,
               "butcher_combine_rows_lanes": 0.0}
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
    n_cases += _lane_cases(kern, ref, dev, max_err)
    n_cases += _saveat_shape_cases(kern, ref, dev, max_err)
    n_cases += _serve_shape_cases(kern, ref, dev, max_err)
    torch.cuda.synchronize()
    print(f"kernel cases {n_cases} all within tolerance; float32 max abs "
          f"err {max_err}")
    return max_err


def _offset_view(shape, offset, dtype, g, dev):
    """A contiguous tensor of ``shape`` at storage offset ``offset``
    elements (1 breaks 16-byte alignment: the scalar path)."""
    n = math.prod(shape)
    flat = torch.randn(n + offset, generator=g, device=dev).to(dtype)
    return flat[offset:].view(shape)


def _lane_cases(kern, ref, dev, max_err):
    """The lane forms against the plain versions: x (B, n_lane), ks (s, B,
    n_lane), one (s,) or (m, s) row per lane."""
    n_cases = 0
    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        acc = torch.promote_types(dtype, torch.float32)
        for B in LANE_B:
            for n_lane in LANE_N:
                for s in (1, 6, 7, 12, 13):
                    for offset in (0, 1):
                        g = torch.Generator(device=dev).manual_seed(
                            B * 1000 + n_lane * 20 + s + offset)
                        x = _offset_view((B, n_lane), offset, dtype, g, dev)
                        ks = _offset_view((s, B, n_lane), offset, dtype, g,
                                          dev)
                        ka = ks.to(acc).abs()
                        xa = x.to(acc).abs()
                        hc = (0.3 * torch.randn((B, s), generator=g,
                                                device=dev,
                                                dtype=torch.float64)).to(acc)
                        got = kern.butcher_combine(x, ks, hc)
                        mag = xa + torch.einsum("bi,ibn->bn", hc.abs(), ka)
                        ok, e = _close(got, ref.butcher_combine_ref(
                            x, ks, hc, 1.0), mag, dtype)
                        check(ok, f"butcher_combine lanes {dtype} B={B} "
                                  f"n_lane={n_lane} s={s} offset={offset}: "
                                  f"max err {e}")
                        if dtype == torch.float32:
                            max_err["butcher_combine_lanes"] = max(
                                max_err["butcher_combine_lanes"], e)
                        n_cases += 1
                        for m in LANE_M:
                            hm = (0.3 * torch.randn(
                                (B, m, s), generator=g, device=dev,
                                dtype=torch.float64)).to(acc)
                            sc = torch.randn(m, generator=g, device=dev,
                                             dtype=torch.float64).to(acc)
                            got = kern.butcher_combine_rows(x, ks, hm, sc)
                            want = ref.butcher_combine_rows_ref(x, ks, hm,
                                                                sc, 1.0)
                            mag = sc.abs()[:, None, None] * xa + \
                                torch.einsum("bri,ibn->rbn", hm.abs(), ka)
                            ok, e = _close(got, want, mag, dtype)
                            check(ok, f"butcher_combine_rows lanes {dtype} "
                                      f"B={B} n_lane={n_lane} s={s} m={m} "
                                      f"offset={offset}: max err {e}")
                            if dtype == torch.float32:
                                max_err["butcher_combine_rows_lanes"] = max(
                                    max_err["butcher_combine_rows_lanes"], e)
                            n_cases += 1
    return n_cases


# this slice's new call shapes: the Hermite lane rows (s 3, one lane per
# observation) over the CNF's leaves (x, eps (256, 43), dlp (256,)) and the
# physics state (32, 64); dopri8's s 12 rows and s 13 error combine at the
# physics shape
HERMITE_LEAVES = ((256, 43), (256,), (32, 64))
PHYS_N = 32 * 64


def _saveat_shape_cases(kern, ref, dev, max_err):
    n_cases = 0
    for dtype in (torch.float32, torch.float64):
        acc = torch.promote_types(dtype, torch.float32)
        for leaf in HERMITE_LEAVES:
            g = torch.Generator(device=dev).manual_seed(sum(leaf))
            x = torch.randn((8,) + leaf, generator=g, device=dev).to(dtype)
            ks = torch.randn((3, 8) + leaf, generator=g, device=dev).to(dtype)
            hc = torch.rand((8, 3), generator=g, device=dev,
                            dtype=torch.float64).to(acc)
            got = kern.butcher_combine(x, ks, hc)
            mag = x.to(acc).abs() + torch.einsum(
                "bi,ib...->b...", hc.abs(), ks.to(acc).abs())
            ok, e = _close(got, ref.butcher_combine_ref(x, ks, hc, 1.0), mag,
                           dtype)
            check(ok, f"hermite lane rows {dtype} leaf {leaf}: max err {e}")
            if dtype == torch.float32:
                max_err["butcher_combine_lanes"] = max(
                    max_err["butcher_combine_lanes"], e)
            n_cases += 1
        for s in (12, 13):
            g = torch.Generator(device=dev).manual_seed(s)
            x = torch.randn((32, 64), generator=g, device=dev).to(dtype)
            ks = torch.randn((s, 32, 64), generator=g, device=dev).to(dtype)
            hc = (0.1 * torch.randn((2, s), generator=g, device=dev,
                                    dtype=torch.float64)).to(acc)
            sc = torch.tensor([1.0, 0.0], dtype=acc, device=dev)
            kmag = torch.einsum("ri,i...->r...", hc.abs(),
                                ks.to(acc).abs())
            xmag = x.to(acc).abs()
            ok, e1 = _close(kern.butcher_combine(x, ks, hc[0]),
                            ref.butcher_combine_ref(x, ks, hc[0], 1.0),
                            xmag + kmag[0], dtype)
            check(ok, f"butcher_combine {dtype} physics n={PHYS_N} s={s}: "
                      f"max err {e1}")
            rows = kern.butcher_combine_rows(x, ks, hc, sc)
            want = ref.butcher_combine_rows_ref(x, ks, hc, sc, 1.0)
            ok0, e2 = _close(rows[0], want[0], xmag + kmag[0], dtype)
            ok1, e3 = _close(rows[1], want[1], kmag[1], dtype)
            check(ok0 and ok1, f"butcher_combine_rows {dtype} physics "
                               f"n={PHYS_N} s={s}: max err {max(e2, e3)}")
            if dtype == torch.float32:
                max_err["butcher_combine"] = max(max_err["butcher_combine"],
                                                 e1)
                max_err["butcher_combine_rows"] = max(
                    max_err["butcher_combine_rows"], e2, e3)
            n_cases += 2
    print(f"SaveAt call shapes: Hermite lane rows (s 3, 8 lanes) at leaves "
          f"{HERMITE_LEAVES}, dopri8 s 12/13 one-row and rows (m 2) at n "
          f"{PHYS_N}: {n_cases} cases within tolerance")
    return n_cases


def _serve_shape_cases(kern, ref, dev, max_err):
    """The ODE server's call shapes: dopri5's stage combines (one-row lane
    form, s 1..6) and its fused solution + error (rows lane form, s 7, m 2,
    sc (1, 0)) at B 8 and 16 lanes of n_lane = dim, each lane's rows h_b
    times the tableau's, and every third lane free (h 0: all-zero rows),
    which must return x (one-row) and x, 0 (rows) exactly."""
    from repro_torch.core import get_tableau
    tab = get_tableau("dopri5")
    a = torch.tensor(tab.a, dtype=torch.float64, device=dev)
    be = torch.tensor((tab.b, tab.b_err), dtype=torch.float64, device=dev)
    n_lane = SERVE_ODE["dim"]
    n_cases = 0
    for dtype in (torch.float32, torch.float64):
        for B in SERVE_ODE["buckets"]:
            g = torch.Generator(device=dev).manual_seed(B)
            h = torch.empty(B, device=dev, dtype=torch.float64).uniform_(
                0.005, 0.2, generator=g)
            free = torch.arange(B, device=dev) % 3 == 1
            h[free] = 0.0
            x = torch.randn((B, n_lane), generator=g, device=dev).to(dtype)
            ks = torch.randn((tab.s, B, n_lane), generator=g,
                             device=dev).to(dtype)
            xa, ka = x.abs(), ks.abs()
            for s in range(1, tab.s):
                hc = (h[:, None] * a[s, :s]).to(dtype)
                got = kern.butcher_combine(x, ks[:s], hc)
                mag = xa + torch.einsum("bi,ibn->bn", hc.abs(), ka[:s])
                ok, e = _close(got, ref.butcher_combine_ref(x, ks[:s], hc,
                                                            1.0), mag, dtype)
                check(ok, f"serve shape butcher_combine {dtype} B={B} "
                          f"n_lane={n_lane} s={s}: max err {e}")
                check(torch.equal(got[free], x[free]),
                      f"serve shape butcher_combine {dtype} B={B} s={s}: a "
                      f"free lane (all-zero row) is not returned exactly")
                if dtype == torch.float32:
                    max_err["butcher_combine_lanes"] = max(
                        max_err["butcher_combine_lanes"], e)
                n_cases += 1
            hm = (h[:, None, None] * be).to(dtype)
            sc = torch.tensor([1.0, 0.0], dtype=dtype, device=dev)
            got = kern.butcher_combine_rows(x, ks, hm, sc)
            mag = sc.abs()[:, None, None] * xa + \
                torch.einsum("bri,ibn->rbn", hm.abs(), ka)
            ok, e = _close(got, ref.butcher_combine_rows_ref(x, ks, hm, sc,
                                                             1.0), mag, dtype)
            check(ok, f"serve shape butcher_combine_rows {dtype} B={B} "
                      f"n_lane={n_lane} s={tab.s} m=2: max err {e}")
            check(torch.equal(got[0][free], x[free]) and
                  not bool(got[1][free].any()),
                  f"serve shape butcher_combine_rows {dtype} B={B}: a free "
                  f"lane's rows are not x and 0 exactly")
            if dtype == torch.float32:
                max_err["butcher_combine_rows_lanes"] = max(
                    max_err["butcher_combine_rows_lanes"], e)
            n_cases += 1
    print(f"serve shapes: dopri5 stages s 1..{tab.s - 1} (one-row) and s "
          f"{tab.s} m 2 (rows) at B {SERVE_ODE['buckets']} x n_lane {n_lane}, "
          f"free lanes exact: {n_cases} cases within tolerance")
    return n_cases


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


def _value_and_grads(loss_fn, params, *args):
    """(loss, parameter gradients) of one ``loss_fn(params, *args)``."""
    from torch.utils import _pytree as pytree
    leaves = pytree.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    val = loss_fn(params, *args)
    return val.detach(), torch.autograd.grad(val, leaves)


def _loss_and_grads(cfg, params, u, eps):
    from repro_torch.models.cnf import cnf_nll
    return _value_and_grads(cnf_nll, params, u, eps, cfg)


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
        _card_vs_cpu(dataclasses.replace(base, adaptive=adaptive), params,
                     u[:16], eps[:16])


def _card_vs_cpu(cfg, params, us, es):
    """The loss and gradient on the card equal the port's CPU result on
    the same inputs to rtol 1e-9 (phase 4's rule)."""
    v_gpu, g_gpu = _loss_and_grads(cfg, params, us, es)
    cpu = {k: [{n: t.detach().cpu() for n, t in layer.items()}
               for layer in v] for k, v in params.items()}
    v_cpu, g_cpu = _loss_and_grads(cfg, cpu, us.cpu(), es.cpu())
    worst = max(float((a.cpu() - b).abs().max() / b.abs().max())
                for a, b in zip(g_gpu, g_cpu))
    label = f"{cfg.grad_mode}, adaptive={cfg.adaptive}"
    check(_rel_close(v_gpu.cpu(), v_cpu, 1e-9) and
          all(_rel_close(a.cpu(), b, 1e-9) for a, b in zip(g_gpu, g_cpu)),
          f"card != CPU reference ({label}): {worst}")
    print(f"card == CPU reference (batch {us.shape[0]}, {label}): "
          f"loss {float(v_gpu):.12f} worst leaf rel err {worst:.3e}")


def _peak_bytes(fn):
    """Peak allocated bytes of ``fn()`` above what was allocated before,
    from an emptied cache."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - before


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
            out[(n_steps, mode)] = _peak_bytes(
                lambda: _loss_and_grads(cfg, params, u, eps))
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


def _host_ms(fn, calls=1000):
    """Host time per call: a host clock over ``calls`` back-to-back calls
    with no synchronise, so the enqueue cost of the wrapper or library call
    (once the launch queue is full it is paced by the device instead)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t) / calls * 1e3
    torch.cuda.synchronize()
    return ms


def _device_ms(fn, name, iters=50, kernels=None):
    """Kernel time on the device timeline from torch.profiler: the device
    time of the kernels whose name holds ``name``, per call, or None.  With
    ``kernels`` (the launches of such kernels one call makes), a profile
    holding fewer than ``iters * kernels`` of their records is incomplete:
    it prints what it saw and profiles again, three times at most."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(3 if kernels else 1):
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
        except RuntimeError as exc:   # CUPTI unavailable: report, don't guess
            print(f"  profiler unavailable: {exc}")
            return None
        seen = [ev for ev in prof.key_averages() if _self_device_us(ev) > 0]
        hits = [ev for ev in seen if name in ev.key]
        total = sum(_self_device_us(ev) for ev in hits)
        count = sum(ev.count for ev in hits)
        if total > 0 and (kernels is None or count == iters * kernels):
            return total / iters / 1e3
        print(f"  profiler, attempt {attempt + 1}: {count} records of "
              f"*{name}* kernels for {iters} calls; seen "
              f"{[(ev.key[:60], ev.count) for ev in seen[:12]]}")
    return None


def report(max_err, launches):
    from repro_torch.kernels import butcher_combine as kern
    from repro_torch.kernels import ref
    phase("6 report")
    dev = torch.device("cuda")
    dtype = torch.float32
    esize = 4
    lines = []
    # 1000003 x 9 float32 rows fit in the 50 MB L2 (L2-warm reading);
    # 8000000 x 9 do not (an HBM-bound reading).  The share of the HBM byte
    # bound is printed only where the rows kernel's working set exceeds
    # the L2: back-to-back calls on a smaller one read it from the L2.
    l2_bytes = getattr(torch.cuda.get_device_properties(dev),
                       "L2_cache_size", 50 * 2 ** 20)
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
            h1 = _host_ms(lambda: kern.butcher_combine(x, ks, h0))
            hl1 = _host_ms(lambda: torch.addmv(x.flatten(), k2, h0))
            h2 = _host_ms(lambda: kern.butcher_combine_rows(x, ks, hc, sc))
            lines.append(
                f"n={n:8d} s={s:2d} | combine kernel {t_k1:.6f} ms "
                f"(device {d1 if d1 is None else f'{d1:.6f}'}, host "
                f"{h1:.6f}) plain {t_p1:.6f} addmv {t_l1:.6f} (host "
                f"{hl1:.6f}) kernel/addmv {t_k1 / t_l1:.3f} bound {b1:.6f} "
                f"| rows(m=2) kernel {t_k2:.6f} ms (device "
                f"{d2 if d2 is None else f'{d2:.6f}'}, host {h2:.6f}) plain "
                f"{t_p2:.6f} bound {b2:.6f}"
                + ("" if d2 is None or (s + 3) * n * esize <= l2_bytes
                   else f" ({b2 / d2 * 100:.1f}% of it alone)"))
            if n == MAIN_N and s == MAIN_S:
                main = dict(t_k1=t_k1, t_p1=t_p1, t_l1=t_l1, b1=b1, t_k2=t_k2,
                            t_p2=t_p2, b2=b2, d1=d1, d2=d2, h1=h1, h2=h2)
    print("float32 ms per call (CUDA events over 200 back-to-back calls, "
          "wrapper included; device = kernel time from torch.profiler; "
          "host = host clock per call over 1000 calls, no synchronise):")
    for line in lines:
        print("  " + line)
    src = "src/repro_torch/csrc/butcher_combine.cu"
    rows_out = [
        {"name": "butcher_combine", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/butcher_combine.py:69",
         "launches": launches["butcher_combine"],
         "max_abs_err": max_err["butcher_combine"],
         "ms": main["t_k1"], "device_ms": main["d1"],
         "host_ms": main["h1"], "plain_ms": main["t_p1"],
         "bound_ms": main["b1"], "bound_by": "bytes",
         "library_ms": main["t_l1"],
         "shape": f"float32 n={MAIN_N} s={MAIN_S}"},
        {"name": "butcher_combine_rows", "route": "cuda",
         "source": "src/repro_torch/csrc/butcher_combine_rows.cu",
         "replaces": "src/repro/kernels/butcher_combine.py:110",
         "launches": launches["butcher_combine_rows"],
         "max_abs_err": max_err["butcher_combine_rows"],
         "ms": main["t_k2"], "device_ms": main["d2"],
         "host_ms": main["h2"], "plain_ms": main["t_p2"],
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
    _profile_once("step", lambda: _loss_and_grads(cfg, params, u, eps))


def _profile_once(label, fn, host_ops=True):
    """One call of ``fn`` under torch.profiler (warm it up first): wall
    time, summed kernel time, the device's busy share, kernel launches and
    the kernels that take the most device time (printed; the first four
    returned, or None without a profiler).  ``host_ops`` False records the
    device activity alone (a call of ~10^5 launches costs the host's op
    records minutes to summarise)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    try:
        acts = [ProfilerActivity.CUDA] + \
            ([ProfilerActivity.CPU] if host_ops else [])
        with profile(activities=acts) as prof:
            t = time.perf_counter()
            fn()
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
    print(f"{label} wall {wall_us / 1e3:.3f} ms, kernel time "
          f"{busy_us / 1e3:.3f} ms, device busy share "
          f"{busy_us / wall_us:.4f}, kernel launches {launches}")
    for ev in sorted(kernels, key=_self_device_us, reverse=True)[:8]:
        print(f"  {_self_device_us(ev) / 1e3:9.3f} ms  x{ev.count:6d}  "
              f"{ev.key[:90]}")
    return {"wall_ms": wall_us / 1e3, "kernel_ms": busy_us / 1e3,
            "busy": busy_us / wall_us, "launches": launches}


# ---------------------------------------------------------------------------
# The LM serving slice: qwen3-0.6b prefill + greedy decode

# (B, H, Hkv, Sq, Sk, D, causal, window, q_offset): the JAX package's
# kernel test cases, then the serving path's prefill shape
ATTN_CASES = [
    (1, 4, 4, 128, 128, 64, True, None, 0),     # MHA causal
    (2, 8, 2, 256, 256, 64, True, None, 0),     # GQA causal
    (1, 4, 1, 128, 128, 128, True, 64, 0),      # MQA + sliding window
    (1, 4, 2, 100, 100, 64, True, None, 0),     # ragged (padding path)
    (2, 8, 4, 1, 512, 64, True, None, 511),     # decode: 1 query vs cache
    (1, 4, 4, 64, 256, 64, True, None, 192),    # chunked prefill offset
    (1, 4, 4, 128, 128, 64, False, None, 0),    # non-causal (encoder)
    (1, 16, 8, 1, 300, 64, True, 128, 299),     # decode + SWA, ragged cache
    (1, 4, 2, 200, 200, 16, True, None, 0),     # D 16
    (1, 4, 2, 200, 200, 32, False, None, 0),    # D 32, non-causal
    (1, 8, 2, 65, 4096, 128, True, None, 4031),  # Sq 65, long Sk, offset
    (1, 4, 2, 65, 8192, 64, False, None, 0),    # Sq 65, Sk 8192
    (1, 16, 4, 300, 300, 128, True, 100, 0),    # GQA group 4 + window
    (8, 16, 8, 1024, 1024, 128, True, None, 0),  # qwen3-0.6b prefill
]
# kernel vs plain, both float32 inside, differing in summation order:
# |diff| <= atol + rtol*|plain|; bfloat16 adds one output ulp
RMS_TOL = {torch.float32: (1e-6, 1e-6), torch.bfloat16: (2.0 ** -7, 1e-6)}
ATTN_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 2e-2)}
# full-width logits, kernels vs plain versions on the card: float32
# rounding carried through 28 layers, plus bfloat16 cache entries that
# round the other way: |diff| <= 1e-3 * max|plain logits|
LOGITS_RTOL = 1e-3
# the smoke width, card vs CPU (2 layers), relative to max|CPU logits|:
# with a float32 cache, float32 rounding alone (1e-5); with the path's
# bfloat16 cache, also entries that round the other way (a flipped entry
# moves by 2^-8 of itself), as for the full-width check (1e-3)
SMOKE_RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}
SERVE = dict(batch=8, prompt=1024, gen=32)


def _allclose(got, want, tol):
    rtol, atol = tol
    err = (got.float() - want.float()).abs()
    return bool(torch.all(err <= atol + rtol * want.float().abs())), \
        float(err.max())


def lm_kernels_vs_plain():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn
    phase("8 LM kernels vs plain")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(12)
    max_err = {"rms_norm": 0.0, "flash_attention": 0.0}
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for rows, d in ((8192, 1024), (131072, 128), (4099, 1000), (77, 16),
                        (8, 1024), (128, 128), (64, 128)):
            x = torch.randn(rows, d, generator=g, device=dev).to(dtype)
            r = torch.randn(rows, d, generator=g, device=dev).to(dtype)
            w = torch.randn(d, generator=g, device=dev)
            for res in (None, r):
                ok, e = _allclose(rn.rms_norm(x, w, res),
                                  ref.rms_norm_ref(x, w, res), RMS_TOL[dtype])
                check(ok, f"rms_norm {dtype} {rows}x{d} residual="
                          f"{res is not None}: max err {e}")
                if dtype == torch.float32:
                    max_err["rms_norm"] = max(max_err["rms_norm"], e)
                n += 1
        for case in ATTN_CASES:
            B, H, Hkv, Sq, Sk, D, causal, window, q_offset = case
            q = torch.randn(B, H, Sq, D, generator=g, device=dev).to(dtype)
            k = torch.randn(B, Hkv, Sk, D, generator=g, device=dev).to(dtype)
            v = torch.randn(B, Hkv, Sk, D, generator=g, device=dev).to(dtype)
            kw = dict(causal=causal, window=window, q_offset=q_offset)
            ok, e = _allclose(fa.flash_attention(q, k, v, **kw),
                              ref.attention_ref(q, k, v, **kw),
                              ATTN_TOL[dtype])
            check(ok, f"flash_attention {dtype} {case}: max err {e}")
            if dtype == torch.float32:
                max_err["flash_attention"] = max(max_err["flash_attention"],
                                                 e)
                print(f"  flash_attention float32 {case}: max abs err "
                      f"{e:.3e}")
            n += 1
    torch.cuda.synchronize()
    print(f"LM kernel cases {n} all within tolerance; float32 max abs err "
          f"{max_err}")
    return max_err


def _lm_counts():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    return rn.rms_norm.launches, fa.flash_attention.launches


def _zero_lm_counts():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    rn.rms_norm.launches = 0
    fa.flash_attention.launches = 0


def serve_main_path():
    """The LM main path: the serving CLI at full width on the card."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    phase("9 serve (LM main path): qwen3-0.6b, full width")
    cfg = get_arch("qwen3-0.6b")
    argv = ["lm", "--arch", "qwen3-0.6b", "--batch", str(SERVE["batch"]),
            "--prompt-len", str(SERVE["prompt"]), "--device", "cuda"]
    serve.main(argv + ["--gen-len", "2"])       # warm-up: first-call set-up
    _zero_lm_counts()
    torch.cuda.synchronize()
    out = serve.main(argv + ["--gen-len", str(SERVE["gen"])])
    rms, flash = _lm_counts()
    check(out["logits_finite"], "serve: non-finite logits")
    check(tuple(out["tokens"].shape) == (SERVE["batch"], SERVE["gen"]),
          f"serve: tokens of shape {tuple(out['tokens'].shape)}")
    per_forward = 4 * cfg.n_layers + 1        # block, q, k, ffn norms + final
    print(f"serve: prefill {out['prefill_ms']:.3f} ms ({SERVE['batch']} x "
          f"{SERVE['prompt']} tokens), decode "
          f"{out['decode_ms_per_token']:.3f} ms/token ({SERVE['gen'] - 1} "
          f"steps of batch {SERVE['batch']}); launches rms_norm {rms} "
          f"flash_attention {flash} (expected {per_forward} x "
          f"{SERVE['gen']} forwards and {cfg.n_layers})")
    check(rms == per_forward * SERVE["gen"] and flash == cfg.n_layers,
          f"serve: launches rms_norm {rms}, flash_attention {flash}")
    return {"rms_norm": rms, "flash_attention": flash,
            "prefill_ms": out["prefill_ms"],
            "decode_ms_per_token": out["decode_ms_per_token"]}


def _greedy(logits):
    return torch.argmax(logits[:, -1], -1)[:, None]


def serve_vs_plain():
    """Prefill + 4 decode steps at full width with the kernels and with the
    plain versions (use_kernels=False), fed the same tokens; launches per
    prefill and per decode step from the counters."""
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import synthetic_lm_batch
    from repro_torch.models.lm import init_lm
    from repro_torch.train import make_decode_step, make_prefill_step
    phase("10 serve: kernels vs plain versions on the card (full width)")
    dev = torch.device("cuda")
    cfg = get_arch("qwen3-0.6b")
    plain = cfg.with_(use_kernels=False)
    B, S, steps = SERVE["batch"], SERVE["prompt"], 4
    params = init_lm(cfg, seed=0, device=dev)
    toks = torch.as_tensor(synthetic_lm_batch(0, B, S + 1, cfg.vocab)[
        "tokens"], dtype=torch.long, device=dev)
    pre_k = make_prefill_step(cfg, B, S + steps)
    pre_p = make_prefill_step(plain, B, S + steps)
    dec_k, dec_p = make_decode_step(cfg), make_decode_step(plain)
    _zero_lm_counts()
    lk, ck = pre_k(params, {"tokens": toks})
    torch.cuda.synchronize()
    per_prefill = _lm_counts()
    lp, cp = pre_p(params, {"tokens": toks})
    errs, agree, total = [], 0, 0
    per_decode = []
    for i in range(steps + 1):
        err = float((lk - lp).abs().max() / lp.abs().max())
        errs.append(err)
        check(bool(torch.isfinite(lk).all()),
              f"serve vs plain: non-finite kernel logits at step {i}")
        check(err <= LOGITS_RTOL, f"serve vs plain: step {i} logits differ "
                                  f"by {err:.3e} of max|logits|")
        tok = _greedy(lk)
        agree += int((tok == _greedy(lp)).sum())
        total += B
        if i == steps:
            break
        _zero_lm_counts()
        lk, ck = dec_k(params, ck, tok, S + i)
        torch.cuda.synchronize()
        per_decode.append(_lm_counts())
        lp, cp = dec_p(params, cp, tok, S + i)
    n_rms = 4 * cfg.n_layers + 1
    check(per_prefill == (n_rms, cfg.n_layers),
          f"launches per prefill {per_prefill}")
    check(all(c == (n_rms, 0) for c in per_decode),
          f"launches per decode step {per_decode}")
    print(f"launches per prefill: rms_norm {per_prefill[0]} flash_attention "
          f"{per_prefill[1]}; per decode step: rms_norm {per_decode[0][0]} "
          f"flash_attention {per_decode[0][1]}")
    print(f"logits kernels vs plain: max|diff| / max|plain| per step "
          f"(prefill, then {steps} decode steps) "
          f"{[f'{e:.3e}' for e in errs]} (tolerance {LOGITS_RTOL}); greedy "
          f"tokens agree {agree}/{total}")
    return params


def serve_card_vs_cpu():
    """The smoke width: the port's own seed weights, built once on the CPU
    and copied to the card; prefill + 4 decode steps on both devices, with
    a float32 cache (the kernels' arithmetic alone) and with the path's
    bfloat16 cache."""
    from repro_torch.configs import get_smoke_arch
    from repro_torch.data.tokens import synthetic_lm_batch
    from torch.utils import _pytree as pytree
    from repro_torch.models.lm import init_lm
    from repro_torch.train import make_decode_step, make_prefill_step
    phase("11 serve: card vs CPU (smoke width)")
    cfg = get_smoke_arch("qwen3-0.6b")
    B, S, steps = 4, 32, 4
    cpu_params = init_lm(cfg, seed=0, device="cpu")
    gpu_params = pytree.tree_map(lambda t: t.to("cuda"), cpu_params)
    toks = torch.as_tensor(synthetic_lm_batch(0, B, S + 1, cfg.vocab)[
        "tokens"], dtype=torch.long)
    decode = make_decode_step(cfg)
    for cache_dtype, rtol in SMOKE_RTOL.items():
        prefill = make_prefill_step(cfg, B, S + steps, cache_dtype)
        lc, cc = prefill(cpu_params, {"tokens": toks})
        lg, cg = prefill(gpu_params, {"tokens": toks.cuda()})
        errs = []
        for i in range(steps + 1):
            err = float((lg.cpu() - lc).abs().max() / lc.abs().max())
            errs.append(err)
            check(err <= rtol, f"card vs CPU ({cache_dtype} cache): step "
                               f"{i} logits differ by {err:.3e} of "
                               f"max|logits|")
            if i == steps:
                break
            tok = _greedy(lc)
            lc, cc = decode(cpu_params, cc, tok, S + i)
            lg, cg = decode(gpu_params, cg, tok.cuda(), S + i)
        print(f"card == CPU (smoke, batch {B}, prompt {S}, {steps} decode "
              f"steps, {cache_dtype} cache): max|diff| / max|CPU| per step "
              f"{[f'{e:.3e}' for e in errs]} (tolerance {rtol})")


def lm_report(max_err, launches):
    """ms per call of each LM kernel at the serving path's shapes, beside
    its plain version, one library call and the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn
    phase("12 report (LM kernels, float32, serving shapes)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(21)
    lines, main = [], {}
    # prefill: block/final norms (B*S, 1024), q-norm (B*S*16, 128), k-norm
    # (B*S*8, 128); decode: (B, 1024) and (B*16, 128)
    for rows, d in ((8192, 1024), (131072, 128), (65536, 128), (8, 1024),
                    (128, 128)):
        x = torch.randn(rows, d, generator=g, device=dev)
        w = torch.randn(d, generator=g, device=dev)
        iters = 200 if rows * d <= 1 << 24 else 50
        t_k = _time_ms(lambda: rn.rms_norm(x, w), iters)
        t_p = _time_ms(lambda: ref.rms_norm_ref(x, w), iters)
        t_l = _time_ms(lambda: F.rms_norm(x, (d,), w, 1e-6), iters)
        d_k = _device_ms(lambda: rn.rms_norm(x, w), "rms_norm_kernel")
        h_k = _host_ms(lambda: rn.rms_norm(x, w))
        h_l = _host_ms(lambda: F.rms_norm(x, (d,), w, 1e-6))
        bound = (2 * rows * d + d) * 4 / HBM_BYTES_PER_S * 1e3
        lines.append(f"rms_norm {rows}x{d}: kernel {t_k:.6f} ms (device "
                     f"{d_k if d_k is None else f'{d_k:.6f}'}, host "
                     f"{h_k:.6f}) plain {t_p:.6f} F.rms_norm {t_l:.6f} (host "
                     f"{h_l:.6f}) kernel/F.rms_norm {t_k / t_l:.3f} bound "
                     f"{bound:.6f}")
        if (rows, d) == (8192, 1024):
            main["rms_norm"] = dict(ms=t_k, device_ms=d_k, host_ms=h_k,
                                    plain_ms=t_p, library_ms=t_l,
                                    bound_ms=bound, bound_by="bytes",
                                    shape="float32 rows 8192 d 1024")
    B, H, Hkv, S, D = 8, 16, 8, 1024, 128
    q = torch.randn(B, H, S, D, generator=g, device=dev)
    k = torch.randn(B, Hkv, S, D, generator=g, device=dev)
    v = torch.randn(B, Hkv, S, D, generator=g, device=dev)
    t_k = _time_ms(lambda: fa.flash_attention(q, k, v), 50, 5)
    t_p = _time_ms(lambda: ref.attention_ref(q, k, v), 20, 3)
    t_l = _time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 50, 5)
    d_k = _device_ms(lambda: fa.flash_attention(q, k, v),
                     "flash_attention_kernel", 10)
    h_k = _host_ms(lambda: fa.flash_attention(q, k, v), 100)
    h_l = _host_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 100)
    flops = 4 * B * H * D * (S * (S + 1) // 2)     # the causal pairs only
    nbytes = (2 * B * H * S * D + 2 * B * Hkv * S * D) * 4
    # float32 accuracy on the tensor cores takes three TF32 products
    t_ops = 3 * flops / TF32_FLOP_PER_S
    t_fma = flops / F32_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    bound = max(t_ops, t_bytes) * 1e3
    alone = d_k if d_k is not None else t_k
    lines.append(f"flash_attention B{B} H{H}/{Hkv} S{S} D{D} causal: kernel "
                 f"{t_k:.6f} ms (device "
                 f"{d_k if d_k is None else f'{d_k:.6f}'}, host {h_k:.6f}) "
                 f"plain {t_p:.6f} sdpa {t_l:.6f} (host {h_l:.6f}) "
                 f"kernel/sdpa {t_k / t_l:.3f} bound {bound:.6f} "
                 f"({'operations' if t_ops >= t_bytes else 'bytes'}, 3xTF32 "
                 f"on the tensor cores; {bound / alone * 100:.1f}% of it "
                 f"alone) float32-FMA bound {t_fma * 1e3:.6f} "
                 f"({t_fma * 1e3 / alone * 100:.1f}% of it alone) "
                 f"({flops / (t_k * 1e-3) / 1e12:.2f} TFLOP/s achieved per "
                 f"call, {flops / (alone * 1e-3) / 1e12:.2f} alone)")
    main["flash_attention"] = dict(
        ms=t_k, device_ms=d_k, host_ms=h_k, plain_ms=t_p, library_ms=t_l,
        bound_ms=bound,
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        shape=f"float32 B{B} H{H} Hkv{Hkv} S{S} D{D} causal")
    print("float32 ms per call (CUDA events over back-to-back calls, wrapper "
          "included; device = kernel time from torch.profiler; host = host "
          "clock per call with no synchronise, over 1000 calls, 100 for "
          "flash attention):")
    for line in lines:
        print("  " + line)
    srcs = {"rms_norm": ("src/repro_torch/csrc/rmsnorm.cu",
                         "src/repro/kernels/rmsnorm.py:39"),
            "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                "src/repro/kernels/flash_attention.py:94")}
    return [{"name": name, "route": "cuda", "source": srcs[name][0],
             "replaces": srcs[name][1], "launches": launches[name],
             "max_abs_err": max_err[name], **main[name]}
            for name in ("rms_norm", "flash_attention")]


def profile_serve(params):
    """Where a serving step's time goes: one full-width prefill and one
    decode step under torch.profiler (after a warm-up of each)."""
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import synthetic_lm_batch
    from repro_torch.train import make_decode_step, make_prefill_step
    phase("13 profile (one prefill, one decode step; qwen3-0.6b float32)")
    cfg = get_arch("qwen3-0.6b")
    B, S = SERVE["batch"], SERVE["prompt"]
    toks = torch.as_tensor(synthetic_lm_batch(0, B, S + 1, cfg.vocab)[
        "tokens"], dtype=torch.long, device="cuda")
    prefill = make_prefill_step(cfg, B, S + 2)
    decode = make_decode_step(cfg)
    logits, caches = prefill(params, {"tokens": toks})
    decode(params, caches, _greedy(logits), S)
    _profile_once("prefill:", lambda: prefill(params, {"tokens": toks}))
    _profile_once("decode step:",
                  lambda: decode(params, caches, _greedy(logits), S))


# ---------------------------------------------------------------------------
# The per-sample CNF slice: solve(..., batch_axis=0), a controller per sample

def _zero_combine_counts():
    from repro_torch.kernels import butcher_combine as kern
    kern.butcher_combine.launches = 0
    kern.butcher_combine_rows.launches = 0


def _combine_counts():
    from repro_torch.kernels import butcher_combine as kern
    return kern.butcher_combine.launches, kern.butcher_combine_rows.launches


def _per_sample_inputs(B, dtype=torch.float32, seed=0):
    """Step 0 of the per-sample trainer: its weights (``init_cnf`` from
    ``seed``), its first batch and its Hutchinson noise (the trainer's
    generator from ``seed``), the first B samples of each."""
    from repro_torch.data.tabular import make_tabular_dataset
    from repro_torch.launch.train_cnf import make_config
    from repro_torch.models.cnf import init_cnf
    dev = torch.device("cuda")
    cfg = make_config("miniboone", adaptive=True, per_sample=True)
    params = init_cnf(cfg, seed=seed, device=dev, dtype=dtype)
    u = torch.as_tensor(make_tabular_dataset("miniboone", n=256 * 8)[:256],
                        dtype=dtype, device=dev)
    noise = torch.Generator(device=dev).manual_seed(seed)
    eps = torch.randn(u.shape, generator=noise, dtype=dtype, device=dev)
    return cfg, params, u[:B], eps[:B]


def _counted(run):
    """``run()`` with the combines' launch counters set to 0 just before and
    the CUDA synchronisations it makes counted by ``torch.cuda``'s sync
    debug mode; returns (its result, synchronisations, (one-row launches,
    rows launches))."""
    import warnings
    torch.cuda.synchronize()
    _zero_combine_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("called a synchronizing" in str(w.message) for w in caught)
    return out, syncs, _combine_counts()


def _lane_solve(cfg, params, u, eps):
    """The per-sample forward solve of ``cnf_forward`` (one component, no
    graph) through the batched driver; returns (solution, CUDA
    synchronisations during the solve, combine launches during it)."""
    from repro_torch.core import AdaptiveConfig, get_tableau
    from repro_torch.core.rk import rk_solve_adaptive_batched
    from repro_torch.models.cnf import cnf_field, component
    state = (u[:, None], torch.zeros((u.shape[0], 1), dtype=u.dtype,
                                     device=u.device), eps[:, None])
    acfg = AdaptiveConfig(rtol=cfg.rtol, atol=cfg.atol,
                          max_steps=cfg.max_steps)
    with torch.no_grad():
        return _counted(lambda: rk_solve_adaptive_batched(
            cnf_field(cfg), get_tableau(cfg.method), state, 0.0, cfg.t1,
            component(params, 0), acfg))


def per_sample_main_path():
    """The per-sample main path: the trainer CLI with --per-sample."""
    from repro_torch.launch import train_cnf
    phase("14 per-sample train (main path): MiniBooNE CNF, 256 lanes")
    steps = 3
    _zero_combine_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    hist = train_cnf.main(PER_SAMPLE + ["--steps", str(steps)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    one, rows = _combine_counts()
    for rec in hist:
        check(math.isfinite(rec["nll"]) and math.isfinite(rec["grad_norm"])
              and rec["grad_norm"] > 0,
              f"per-sample train: non-finite loss or gradient {rec}")
    per_step = [round(b["seconds"] - a, 4) for a, b in
                zip([0.0] + [r["seconds"] for r in hist[:-1]], hist)]
    print(f"per-sample train: {steps} steps in {secs:.3f}s (seconds per "
          f"step {per_step}) nll {[round(r['nll'], 5) for r in hist]}; "
          f"launches butcher_combine {one} ({one / steps:.1f}/step) "
          f"butcher_combine_rows {rows} ({rows / steps:.1f}/step)")
    check(one > 0 and rows > 0,
          f"per-sample train: lane forms launched {one} / {rows} times")
    out = {"butcher_combine_lanes": one, "butcher_combine_rows_lanes": rows,
           "seconds_per_step": per_step}
    per_attempt = {}
    for B in (256, 16):
        cfg, params, u, eps = _per_sample_inputs(B)
        sol, syncs, (c1, c2) = _lane_solve(cfg, params, u, eps)
        attempts = int(sol.n_attempts.max())
        acc = sol.n_accepted.cpu().float()
        failed = int((~sol.succeeded).sum())
        per_attempt[B] = (c1 / attempts, c2 / attempts)
        print(f"solver on step 0's batch, B {B}: {attempts} attempts; "
              f"accepted steps per lane min {int(acc.min())} median "
              f"{float(acc.median()):.0f} max {int(acc.max())}; failed lanes "
              f"{failed} (max_steps {cfg.max_steps}); launches per attempt "
              f"butcher_combine {c1 / attempts:.2f} butcher_combine_rows "
              f"{c2 / attempts:.2f}; host reads per attempt "
              f"{syncs / attempts:.3f} ({syncs} CUDA synchronisations)")
        check(syncs == attempts, f"B {B}: {syncs} host reads in {attempts} "
                                 f"attempts")
        if B == 256:
            out["attempts"] = attempts
            out["per_attempt"] = per_attempt[B]
    check(per_attempt[256] == per_attempt[16],
          f"launches per attempt grow with B: {per_attempt}")
    return out


def per_sample_exactness():
    import dataclasses
    phase("15 per-sample exactness (float64, B 16)")
    cfg, params, u, eps = _per_sample_inputs(16, torch.float64, seed=3)
    v_sym, g_sym = _loss_and_grads(cfg, params, u, eps)
    v_bp, g_bp = _loss_and_grads(
        dataclasses.replace(cfg, grad_mode="backprop"), params, u, eps)
    worst = max(float((a - b).abs().max() / b.abs().max())
                for a, b in zip(g_sym, g_bp))
    check(_rel_close(v_sym, v_bp, 1e-9) and
          all(_rel_close(a, b, 1e-9) for a, b in zip(g_sym, g_bp)),
          f"per-sample symplectic != backprop: worst leaf rel err {worst}")
    print(f"per-sample symplectic == DirectBackprop through the batched "
          f"driver: worst leaf rel err {worst:.3e}")
    single = dataclasses.replace(cfg, per_sample=False)
    v_one, g_one = 0.0, None
    for b in range(u.shape[0]):
        v, g = _loss_and_grads(single, params, u[b:b + 1], eps[b:b + 1])
        v_one = v_one + v / u.shape[0]
        g = [x / u.shape[0] for x in g]
        g_one = g if g_one is None else [a + c for a, c in zip(g_one, g)]
    worst = max(float((a - b).abs().max() / b.abs().max())
                for a, b in zip(g_sym, g_one))
    check(_rel_close(v_sym, v_one, 1e-9) and
          all(_rel_close(a, b, 1e-9) for a, b in zip(g_sym, g_one)),
          f"per-sample != mean of single-sample solves: {worst}")
    print(f"per-sample symplectic == mean of 16 single-sample symplectic "
          f"solves: loss {float(v_sym):.12f} worst leaf rel err "
          f"{worst:.3e}")


def per_sample_memory():
    import dataclasses
    phase("16 per-sample memory (float32, B 256, one loss+gradient)")
    out = {}
    for mode in ("symplectic", "backprop"):
        cfg, params, u, eps = _per_sample_inputs(256)
        cfg = dataclasses.replace(cfg, grad_mode=mode)
        out[mode] = _peak_bytes(lambda: _loss_and_grads(cfg, params, u, eps))
    sym, bp = out["symplectic"], out["backprop"]
    print(f"per-sample peak_bytes: symplectic {sym} backprop {bp} (ratio "
          f"{bp / sym:.2f})")
    check(sym < bp, f"per-sample: symplectic peak {sym} not below "
                    f"backprop {bp}")
    return out


def lane_report(max_err, ps):
    """ms per call of both lane forms at the per-sample shape, beside the
    plain versions, the bound and (one-row form) one torch.baddbmm."""
    from repro_torch.kernels import butcher_combine as kern
    from repro_torch.kernels import ref
    phase("17 lane report (float32, B 256, n_lane 43, s 7, m 2)")
    dev = torch.device("cuda")
    B, n_lane, s, m, esize = 256, 43, MAIN_S, 2, 4
    n = B * n_lane
    g = torch.Generator(device=dev).manual_seed(17)
    x = torch.randn((B, 1, n_lane), generator=g, device=dev)
    ks = torch.randn((s, B, 1, n_lane), generator=g, device=dev)
    hc = torch.randn((B, s), generator=g, device=dev)
    hm = torch.randn((B, m, s), generator=g, device=dev)
    sc = torch.tensor([1.0, 0.0], device=dev)
    xb, kb = x.view(B, 1, n_lane), ks.view(s, B, n_lane).transpose(0, 1)
    hb = hc.view(B, 1, s)
    rows = []
    for name, fn, plain, lib, nbytes, flops, launches in (
            ("butcher_combine_lanes", lambda: kern.butcher_combine(x, ks, hc),
             lambda: ref.butcher_combine_ref(x, ks, hc, 1.0),
             lambda: torch.baddbmm(xb, hb, kb),
             (s + 2) * n * esize + B * s * esize, 2 * s * n,
             ps["butcher_combine_lanes"]),
            ("butcher_combine_rows_lanes",
             lambda: kern.butcher_combine_rows(x, ks, hm, sc),
             lambda: ref.butcher_combine_rows_ref(x, ks, hm, sc, 1.0), None,
             (s + 1 + m) * n * esize + (B * m * s + m) * esize,
             2 * m * (s + 1) * n, ps["butcher_combine_rows_lanes"])):
        kname = name[:-len("_lanes")] + "_kernel"
        t_k, t_p = _time_ms(fn), _time_ms(plain)
        t_l = _time_ms(lib) if lib is not None else None
        d_k = _device_ms(fn, kname)
        h_k = _host_ms(fn)
        bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S) * 1e3
        per_attempt = ps["per_attempt"][0 if "rows" not in name else 1]
        print(f"  {name}: kernel {t_k:.6f} ms (device "
              f"{d_k if d_k is None else f'{d_k:.6f}'}, host {h_k:.6f}) "
              f"plain {t_p:.6f} "
              + ("" if t_l is None else f"baddbmm {t_l:.6f} kernel/baddbmm "
                 f"{t_k / t_l:.3f} ")
              + f"bound {bound:.6f} ({nbytes} bytes); launches {launches} "
              f"in 3 per-sample steps, {per_attempt:.2f} per forward "
              f"attempt")
        rows.append({
            "name": name, "route": "cuda",
            "source": ("src/repro_torch/csrc/butcher_combine_rows.cu"
                       if "rows" in name else
                       "src/repro_torch/csrc/butcher_combine.cu"),
            "replaces": ("src/repro/kernels/butcher_combine.py:110"
                         if "rows" in name else
                         "src/repro/kernels/butcher_combine.py:69"),
            "launches": launches, "max_abs_err": max_err[name], "ms": t_k,
            "device_ms": d_k, "host_ms": h_k, "plain_ms": t_p,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": t_l,
            "shape": f"float32 B={B} n_lane={n_lane} s={s}"
                     + (f" m={m}" if "rows" in name else "")})
    return rows


def per_sample_profile():
    """Where a per-sample training step's time goes: one float32 B 256
    loss+gradient under torch.profiler (after a warm-up)."""
    phase("18 profile (one per-sample loss+gradient, float32, B 256)")
    cfg, params, u, eps = _per_sample_inputs(256)
    _loss_and_grads(cfg, params, u, eps)
    _profile_once("per-sample step",
                  lambda: _loss_and_grads(cfg, params, u, eps))


# ---------------------------------------------------------------------------
# The paper's baselines: RematStep, RematSolve, ContinuousAdjoint

TABLE1_MODES = ("symplectic", "backprop", "remat_step", "remat_solve",
                "adjoint")
# (method, N, timed calls after the warm-up): dopri5 over N, and over s at
# N = 8 with bosh3 (s 4) and dopri8 (s 12)
TABLE1_CASES = (("dopri5", 8, 3), ("dopri5", 32, 2), ("bosh3", 8, 3),
                ("dopri8", 8, 2))


def table1():
    """The paper's Table 1 on the card: peak bytes, ms and combine launches
    of one float32 loss+gradient of the MiniBooNE CNF for all five
    gradient strategies, over N (dopri5) and over s (N = 8)."""
    import dataclasses
    import statistics
    from repro_torch.launch.train_cnf import make_config
    from repro_torch.models.cnf import init_cnf
    phase("19 Table 1 on the card (float32, one loss+gradient, batch 256)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(19)
    out = {}
    for method, n, repeats in TABLE1_CASES:
        for mode in TABLE1_MODES:
            cfg = dataclasses.replace(
                make_config("miniboone", n_steps=n, grad_mode=mode),
                method=method)
            params = init_cnf(cfg, seed=0, device=dev)
            u = torch.randn((256, cfg.dim), generator=g, device=dev)
            eps = torch.randn(u.shape, generator=g, device=dev)
            _zero_combine_counts()
            # the warm-up call: peak bytes and launches per loss+gradient
            peak = _peak_bytes(lambda: _loss_and_grads(cfg, params, u, eps))
            one, rows = _combine_counts()
            times = []
            for _ in range(repeats):
                torch.cuda.synchronize()
                t = time.perf_counter()
                _loss_and_grads(cfg, params, u, eps)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            ms = statistics.median(times)
            out[(mode, method, n)] = {"peak_bytes": peak, "ms": ms,
                                      "butcher_combine": one,
                                      "butcher_combine_rows": rows}
            print(f"table1 {mode:11s} {method} N={n:2d}: peak_bytes {peak} "
                  f"ms {ms:.3f} (median of {repeats} synchronised calls "
                  f"after one warm-up: "
                  f"{', '.join(f'{x:.3f}' for x in times)}) launches "
                  f"butcher_combine {one} butcher_combine_rows {rows}")
    cols = [f"{m} N={n}" for m, n, _ in TABLE1_CASES]
    print("table1 peak MB / ms per loss+gradient:")
    print("  " + f"{'strategy':11s}" + "".join(f" | {c:>17s}" for c in cols))
    for mode in TABLE1_MODES:
        cells = [out[(mode, m, n)] for m, n, _ in TABLE1_CASES]
        print("  " + f"{mode:11s}" + "".join(
            f" | {c['peak_bytes'] / 2 ** 20:7.2f} / {c['ms']:7.1f}"
            for c in cells))
    peak = {mode: out[(mode, "dopri5", 32)]["peak_bytes"]
            for mode in TABLE1_MODES}
    check(peak["symplectic"] < peak["remat_step"] < peak["remat_solve"]
          and peak["remat_step"] < peak["backprop"],
          f"N=32: not symplectic < remat_step < remat_solve and remat_step "
          f"< backprop in peak bytes: {peak}")
    check(peak["adjoint"] < peak["remat_step"],
          f"N=32: adjoint peak {peak['adjoint']} not below remat_step's "
          f"{peak['remat_step']}")
    adj8 = out[("adjoint", "dopri5", 8)]["peak_bytes"]
    check(peak["adjoint"] <= 1.2 * adj8,
          f"adjoint peak grows with N: {adj8} at N=8, {peak['adjoint']} at "
          f"N=32")
    print(f"table1 checks: at N=32 symplectic < remat_step < remat_solve, "
          f"remat_step < backprop, adjoint < remat_step; adjoint peak N=32 "
          f"/ N=8 {peak['adjoint'] / adj8:.3f}")
    return out


def baselines_exactness():
    """float64: the remat strategies equal autograd through the solver; the
    adjoint's error against it is printed; the adjoint on the card equals
    the port's CPU result."""
    import dataclasses
    from repro_torch.launch.train_cnf import make_config
    from repro_torch.models.cnf import init_cnf
    phase("20 baselines exactness (float64)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(20)
    base = make_config("miniboone", n_steps=8)
    u = torch.randn((256, base.dim), generator=g, device=dev,
                    dtype=torch.float64)
    eps = torch.randn(u.shape, generator=g, device=dev, dtype=torch.float64)
    params = init_cnf(base, seed=3, device=dev, dtype=torch.float64)
    v_bp, g_bp = _loss_and_grads(
        dataclasses.replace(base, grad_mode="backprop"), params, u, eps)
    for mode in ("remat_step", "remat_solve", "adjoint"):
        v, gr = _loss_and_grads(dataclasses.replace(base, grad_mode=mode),
                                params, u, eps)
        worst = max(float((a - b).abs().max() / b.abs().max())
                    for a, b in zip(gr, g_bp))
        if mode == "adjoint":
            check(math.isfinite(worst) and worst > 0,
                  f"adjoint vs backprop: rel err {worst}")
            print(f"adjoint vs backprop (fixed 8 steps, batch 256): worst "
                  f"leaf rel err {worst:.3e} (the continuous adjoint is "
                  f"not the discrete map's gradient)")
            continue
        check(_rel_close(v, v_bp, 1e-9) and
              all(_rel_close(a, b, 1e-9) for a, b in zip(gr, g_bp)),
              f"{mode} != backprop: worst leaf rel err {worst}")
        print(f"{mode} == backprop (fixed 8 steps, batch 256): worst leaf "
              f"rel err {worst:.3e}")
    for adaptive in (False, True):
        _card_vs_cpu(dataclasses.replace(base, grad_mode="adjoint",
                                         adaptive=adaptive),
                     params, u[:16], eps[:16])


def baselines_main_path():
    """This slice's main path: 2 float32 SGD steps of the trainer for each
    new --grad-mode; returns the combine launches of all four runs."""
    from repro_torch.launch import train_cnf
    phase("21 baselines train (main path): MiniBooNE CNF, batch 256")
    steps = 2
    total = {"butcher_combine": 0, "butcher_combine_rows": 0}
    for extra in (["--grad-mode", "remat_step"],
                  ["--grad-mode", "remat_solve"],
                  ["--grad-mode", "adjoint"],
                  ["--grad-mode", "adjoint", "--adaptive"]):
        label = " ".join(extra)
        _zero_combine_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        hist = train_cnf.main(["--dataset", "miniboone", "--steps",
                               str(steps), "--batch", "256", "--n-steps",
                               "8", "--device", "cuda"] + extra)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        one, rows = _combine_counts()
        for rec in hist:
            check(math.isfinite(rec["nll"]) and
                  math.isfinite(rec["grad_norm"]) and rec["grad_norm"] > 0,
                  f"train {label}: non-finite loss or gradient {rec}")
        print(f"train {label}: {steps} steps in {secs:.3f}s nll "
              f"{[round(r['nll'], 5) for r in hist]} launches "
              f"butcher_combine {one} ({one / steps:.1f}/step) "
              f"butcher_combine_rows {rows} ({rows / steps:.1f}/step)")
        check(one > 0, f"train {label}: butcher_combine never launched")
        if "--adaptive" in extra:
            check(rows > 0,
                  f"train {label}: butcher_combine_rows never launched")
        total["butcher_combine"] += one
        total["butcher_combine_rows"] += rows
    return total


def per_sample_adjoint_memory(ps_mem):
    """The per-sample adjoint records no per-step state: its peak bytes do
    not move with max_steps (the checkpoint buffers' row count)."""
    import dataclasses
    phase("22 per-sample adjoint memory (float32, B 256, one "
          "loss+gradient)")
    out = {}
    for max_steps in (48, 96):
        cfg, params, u, eps = _per_sample_inputs(256)
        cfg = dataclasses.replace(cfg, grad_mode="adjoint",
                                  max_steps=max_steps)
        out[max_steps] = _peak_bytes(
            lambda: _loss_and_grads(cfg, params, u, eps))
    a48, a96 = out[48], out[96]
    print(f"per-sample peak_bytes: adjoint {a48} (max_steps 48) {a96} "
          f"(max_steps 96), ratio {a96 / a48:.4f}; symplectic "
          f"{ps_mem['symplectic']} backprop {ps_mem['backprop']} (phase 16)")
    check(abs(a96 - a48) <= 0.05 * a48,
          f"per-sample adjoint peak moves with max_steps: {out}")
    return out


# ---------------------------------------------------------------------------
# SaveAt: observations at user times, the physics workload, the CNF path

PHYS_TRAJ = dict(n_traj=6, grid=64, n_snapshots=16, substeps=80)
SAVEAT_ADAPTIVE = dict(adaptive=True, rtol=1e-6, atol=1e-8, max_steps=64)
# phase 24's rollout: observations per window (each cell's time grows with
# it, host-bound; short for the script's time limit, PERF.md §4)
SAVEAT_HORIZON = 2


_TRAJS = {}


def _physics_windows(B, horizon=8, dtype=torch.float32, device="cuda"):
    """(horizon + 1, B, 64): B windows of horizon + 1 consecutive snapshots
    of phase 23's trajectories (the trainer's settings and seed)."""
    import numpy as np
    from repro_torch.data.physics_gen import generate_trajectories
    if "kdv" not in _TRAJS:
        _TRAJS["kdv"] = generate_trajectories("kdv", **PHYS_TRAJ)
    trajs = _TRAJS["kdv"]
    n_snap = trajs.shape[1]
    windows = [trajs[t, s:s + horizon + 1] for t in range(trajs.shape[0])
               for s in range(n_snap - horizon)]
    check(len(windows) >= B, f"only {len(windows)} windows for batch {B}")
    return torch.as_tensor(np.stack(windows[:B], axis=1), dtype=dtype,
                           device=device)


def physics_main_path():
    """The slice's main path: the physics trainer CLI at the example's full
    settings, 3 steps, then its held-out SaveAt(ts) rollout."""
    from repro_torch.launch import train_physics
    from repro_torch.models import physics
    phase("23 physics train (main path): KdV HNN++, dopri8, full width")
    steps = 3
    _zero_combine_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = train_physics.main(["--steps", str(steps), "--device", "cuda"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    one, rows = _combine_counts()
    hist = out["history"]
    for rec in hist:
        check(math.isfinite(rec["mse"]) and math.isfinite(rec["grad_norm"])
              and rec["grad_norm"] > 0,
              f"physics train: non-finite loss or gradient {rec}")
    check(len(out["rollout_mse"]) == 7 and
          all(math.isfinite(e) for e in out["rollout_mse"]),
          f"physics rollout: {out['rollout_mse']}")
    per_step = [round(b["seconds"] - a, 4) for a, b in
                zip([0.0] + [r["seconds"] for r in hist[:-1]], hist)]
    print(f"physics train: {steps} steps + rollout in {secs:.3f}s (seconds "
          f"per step {per_step}) mse {[round(r['mse'], 7) for r in hist]}; "
          f"rollout MSE per horizon "
          f"{[round(e, 6) for e in out['rollout_mse']]}; launches "
          f"butcher_combine {one} butcher_combine_rows {rows}")
    check(one > 0, "physics train: butcher_combine never launched")
    # one loss+gradient alone: the launches of a training step
    cfg = physics.PhysicsConfig()
    params = physics.init_energy_net(cfg, seed=1, device="cuda")
    u = _physics_windows(32, horizon=1)
    _zero_combine_counts()
    _value_and_grads(physics.physics_loss, params, u[0], u[1], cfg)
    step_one, step_rows = _combine_counts()
    print(f"physics: one loss+gradient (batch 32) launches butcher_combine "
          f"{step_one} butcher_combine_rows {step_rows}")
    _profile_once("physics step", lambda: _value_and_grads(
        physics.physics_loss, params, u[0], u[1], cfg))
    return {"butcher_combine": one, "butcher_combine_rows": rows,
            "per_step": (step_one, step_rows), "seconds_per_step": per_step}


def _cell_measure(fn, repeats=3):
    """Peak bytes and combine launches of the first (warm-up) call, then
    the median ms of ``repeats`` synchronised calls; "last" holds the last
    call's result."""
    import statistics
    _zero_combine_counts()
    peak = _peak_bytes(fn)
    one, rows = _combine_counts()
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t = time.perf_counter()
        last = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return {"peak_bytes": peak, "ms": statistics.median(times),
            "times": times, "butcher_combine": one,
            "butcher_combine_rows": rows, "last": last}


def saveat_cells():
    """One rollout_loss loss+gradient per SaveAt cell on the card."""
    import dataclasses
    from repro_torch.models import physics
    phase(f"24 SaveAt cells (float32, rollout_loss, horizon "
          f"{SAVEAT_HORIZON}, batch 32, dopri8)")
    u = _physics_windows(32, horizon=SAVEAT_HORIZON)
    base = physics.PhysicsConfig()
    params = physics.init_energy_net(base, seed=0, device="cuda")
    cells = [(mode, "fixed", dataclasses.replace(base, grad_mode=mode))
             for mode in TABLE1_MODES]
    cells += [(mode, "per_sample" if ps else "adaptive",
               dataclasses.replace(base, grad_mode=mode, per_sample=ps,
                                   **SAVEAT_ADAPTIVE))
              for ps in (False, True)
              for mode in ("symplectic", "backprop", "adjoint")]
    out = {}
    for mode, kind, cfg in cells:
        # the checks read the last timed call (no call of their own)
        res = _cell_measure(lambda: _value_and_grads(
            physics.rollout_loss, params, u, cfg))
        val, grads = res.pop("last")
        check(math.isfinite(float(val)) and
              all(bool(torch.isfinite(g).all()) for g in grads),
              f"SaveAt cell {mode} {kind}: non-finite loss or gradient")
        check(res["butcher_combine"] > 0,
              f"SaveAt cell {mode} {kind}: butcher_combine never launched")
        out[(mode, kind)] = res
        print(f"saveat {mode:11s} {kind:10s}: peak_bytes "
              f"{res['peak_bytes']} ms {res['ms']:.3f} (median of 3 after "
              f"one warm-up: {', '.join(f'{x:.3f}' for x in res['times'])})"
              f" launches butcher_combine {res['butcher_combine']} "
              f"butcher_combine_rows {res['butcher_combine_rows']} loss "
              f"{float(val):.7f}")
    _saveat_shape_times()
    return out


def _saveat_shape_times():
    """float32 ms per call of the one-row kernel at this slice's new call
    shapes, beside its plain version, one library call and the bound:
    dopri8's stage and update rows (s 12) and its FSAL error row (s 13) at
    the physics state (n 32 x 64), and the Hermite lane rows (s 3, 8
    lanes, one per observation) at the physics and CNF states."""
    from repro_torch.kernels import butcher_combine as kern
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(24)
    esize = 4
    print("one-row kernel at the SaveAt call shapes (float32; CUDA events "
          "over 200 calls, wrapper included; device = kernel alone from "
          "torch.profiler; bound = bytes over 3.35 TB/s):")
    for label, lanes, n_lane, s in (("dopri8 rows", None, PHYS_N, 12),
                                    ("dopri8 FSAL error", None, PHYS_N, 13),
                                    ("Hermite physics", 8, PHYS_N, 3),
                                    ("Hermite CNF x", 8, MAIN_N, 3)):
        lead = () if lanes is None else (lanes,)
        x = torch.randn(lead + (n_lane,), generator=g, device=dev)
        ks = torch.randn((s,) + lead + (n_lane,), generator=g, device=dev)
        hc = torch.randn(lead + (s,), generator=g, device=dev)
        if lanes is None:
            k2 = ks.reshape(s, -1).t()
            lib = (lambda: torch.addmv(x, k2, hc)), "addmv"
        else:
            xb, kb = x.view(lanes, 1, n_lane), ks.transpose(0, 1)
            hb = hc.view(lanes, 1, s)
            lib = (lambda: torch.baddbmm(xb, hb, kb)), "baddbmm"
        t_k = _time_ms(lambda: kern.butcher_combine(x, ks, hc))
        t_p = _time_ms(lambda: ref.butcher_combine_ref(x, ks, hc, 1.0))
        t_l = _time_ms(lib[0])
        d_k = _device_ms(lambda: kern.butcher_combine(x, ks, hc),
                         "butcher_combine_kernel")
        n = x.numel()
        bound = max((s + 2) * n * esize / HBM_BYTES_PER_S,
                    2 * s * n / F32_FLOP_PER_S) * 1e3
        print(f"  {label} (lanes {lanes}, n_lane {n_lane}, s {s}): kernel "
              f"{t_k:.6f} ms (device "
              f"{d_k if d_k is None else f'{d_k:.6f}'}) plain {t_p:.6f} "
              f"{lib[1]} {t_l:.6f} kernel/{lib[1]} {t_k / t_l:.3f} bound "
              f"{bound:.6f}")


def _max_rel(got, want):
    return max(float((a.cpu() - b.cpu()).abs().max()
                     / b.cpu().abs().max().clamp_min(1e-300))
               for a, b in zip(got, want))


def _ts_solve(field, u0, params, saveat, **kw):
    """A physics SaveAt solve and its gradient: (ys, stats, grads)."""
    from torch.utils import _pytree as pytree
    from repro_torch.core import solve
    leaves = pytree.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    sol = solve(field, u0, params, saveat=saveat, method="dopri8", **kw)
    loss = torch.sum(torch.tanh(sol.ys) ** 2)
    grads = torch.autograd.grad(loss, leaves)
    stats = {k: v.tolist() for k, v in sol.stats.items()}
    return sol.ys.detach(), stats, grads


def saveat_exactness():
    """float64: symplectic ts == DirectBackprop ts; card == CPU; Hermite at
    the step endpoints == the checkpoints."""
    import dataclasses
    import numpy as np
    from torch.utils import _pytree as pytree
    from repro_torch.core import AdaptiveConfig, SaveAt, get_tableau
    from repro_torch.core.rk import hermite_observe, rk_solve_adaptive
    from repro_torch.models import physics
    phase("25 SaveAt exactness (float64)")
    f64 = torch.float64
    u = _physics_windows(8, dtype=f64)
    base = physics.PhysicsConfig()
    params = physics.init_energy_net(base, seed=0, device="cuda", dtype=f64)
    for kind, kw in (("fixed", {}), ("adaptive", SAVEAT_ADAPTIVE),
                     ("per_sample", dict(SAVEAT_ADAPTIVE, per_sample=True))):
        got = {}
        for mode in ("symplectic", "backprop"):
            cfg = dataclasses.replace(base, grad_mode=mode, **kw)
            got[mode] = _value_and_grads(physics.rollout_loss, params, u,
                                            cfg)
        v_s, g_s = got["symplectic"]
        v_b, g_b = got["backprop"]
        worst = _max_rel(g_s, g_b)
        check(_rel_close(v_s, v_b, 1e-9) and worst <= 1e-9,
              f"SaveAt {kind}: symplectic != backprop, worst leaf rel err "
              f"{worst}")
        print(f"SaveAt {kind}: symplectic ts gradient == DirectBackprop "
              f"(rollout_loss, horizon 8, batch 8): worst leaf rel err "
              f"{worst:.3e}")
    # card vs CPU: the threaded ts cells (single, lanes) and dense output
    ts = 0.1 * np.arange(1, 9)
    cpu_params = {k: v.detach().cpu() for k, v in params.items()}
    acfg = AdaptiveConfig(rtol=1e-6, atol=1e-8, max_steps=64)
    func_field = physics.hnn_field("kdv", 0.5, True)
    cases = (("ts symplectic", physics.hnn_field("kdv", 0.5), u[0],
              dict(saveat=SaveAt(ts=ts), stepping=acfg)),
             ("ts lanes symplectic", func_field, u[0][:, None],
              dict(saveat=SaveAt(ts=ts), stepping=acfg, batch_axis=0)),
             ("dense backprop", func_field, u[0],
              dict(saveat=SaveAt(ts=ts, dense=True), stepping=acfg,
                   gradient="backprop")))
    for label, field, u0, kw in cases:
        _zero_combine_counts()
        ys, st, g = _ts_solve(field, u0, params, **kw)
        launches = _combine_counts()
        ys_c, st_c, g_c = _ts_solve(field, u0.cpu(), cpu_params, **kw)
        check(st == st_c, f"card vs CPU {label}: stats {st} != {st_c}")
        err_v, err_g = _max_rel([ys], [ys_c]), _max_rel(g, g_c)
        print(f"card vs CPU ({label}, batch 8, dopri8, 8 observations): "
              f"stats {st} equal; worst rel err values {err_v:.3e}, "
              f"gradients {err_g:.3e}; launches butcher_combine "
              f"{launches[0]} butcher_combine_rows {launches[1]}")
        check(err_v <= 1e-9, f"card vs CPU {label}: values rel err {err_v}")
        if not label.startswith("dense"):
            check(err_g <= 1e-9, f"card vs CPU {label}: gradients rel err "
                                 f"{err_g}")
    _dense_same_grid(func_field, u[0], params, cpu_params, ts, acfg)
    # Hermite at the accepted steps' start times: the checkpoints
    field = physics.hnn_field("kdv", 0.5, True)
    sol = rk_solve_adaptive(field, get_tableau("dopri8"), u[0], 0.0, 0.8,
                            pytree.tree_map(lambda p: p.detach(), params),
                            acfg)
    n = sol.n_accepted
    check(n > 2, f"Hermite: only {n} accepted steps")
    with torch.no_grad():
        ys = hermite_observe(field, get_tableau("dopri8"), sol, params,
                             torch.stack(sol.ts[1:n]))
    want = torch.stack(sol.xs[1:n])
    err = float((ys - want).abs().max() / want.abs().max())
    check(err <= 1e-12, f"Hermite at step endpoints: rel err {err}")
    print(f"Hermite dense output at {n - 1} accepted step starts == the "
          f"checkpoints: rel err {err:.3e}")


def _dense_loss(field, sol, params, ts):
    from repro_torch.core import get_tableau
    from repro_torch.core.rk import hermite_observe
    from torch.utils import _pytree as pytree
    ys = hermite_observe(field, get_tableau("dopri8"), sol, params, ts)
    loss = torch.sum(torch.tanh(ys) ** 2)
    return ys.detach(), torch.autograd.grad(loss, pytree.tree_leaves(params))


def _dense_same_grid(field, u0, params, cpu_params, ts, acfg):
    """Dense output's gradient, card against CPU on the SAME accepted
    grid.  Each device's controller picks its grid from an error estimate
    that is a cancellation, so two devices' grids differ at rounding level,
    and the Hermite interpolant (error O(h^4)) moves with the grid at first
    order: printed here as the CPU's own change under a 1e-15 relative
    change of the initial state.  The card's run (``rk_solve_adaptive`` +
    ``hermite_observe``, what the dense cell does) is held against a CPU
    replay of the card's accepted steps followed by the same Hermite
    observation: the same function at the same grid, rtol 1e-9."""
    from repro_torch.core import get_tableau
    from repro_torch.core.rk import (AdaptiveSolution, rk_solve_adaptive,
                                     rk_step)
    tab = get_tableau("dopri8")
    ts = torch.as_tensor(ts, dtype=u0.dtype)
    for p in params.values():
        p.requires_grad_(True)
    sol = rk_solve_adaptive(field, tab, u0, 0.0, ts[-1], params, acfg)
    ys, g = _dense_loss(field, sol, params, ts.to(u0.device))
    grid = [(t.cpu(), h.cpu()) for t, h in zip(sol.ts, sol.hs)]
    for p in cpu_params.values():
        p.requires_grad_(True)
    x, xs = u0.cpu(), []
    for t, h in grid:
        xs.append(x)
        x = rk_step(field, tab, x, t, h, cpu_params, with_error=False)[0]
    replay = AdaptiveSolution(x, xs, [t for t, _ in grid],
                              [h for _, h in grid], len(grid), 0, True,
                              grid[-1][1], len(grid))
    ys_c, g_c = _dense_loss(field, replay, cpu_params, ts)
    err = max(_max_rel([ys], [ys_c]), _max_rel(g, g_c))
    # the CPU's own sensitivity: its independent grids from u0 and from
    # u0 * (1 + 1e-15)
    cpu_runs, cpu_sols = [], []
    for scale in (1.0, 1.0 + 1e-15):
        s_c = rk_solve_adaptive(field, tab, u0.cpu() * scale, 0.0, ts[-1],
                                cpu_params, acfg)
        cpu_sols.append(s_c)
        cpu_runs.append(_dense_loss(field, s_c, cpu_params, ts))
    sens = max(_max_rel([cpu_runs[0][0]], [cpu_runs[1][0]]),
               _max_rel(cpu_runs[0][1], cpu_runs[1][1]))
    # the grids themselves: the card's accepted steps against the CPU's own
    # (u0 unscaled), over the steps both took
    own = cpu_sols[0]
    m = min(len(grid), own.n_accepted)
    h_rel = max(abs(float(h) / float(own.hs[i]) - 1.0)
                for i, (_, h) in enumerate(grid[:m]))
    t_abs = max(abs(float(t) - float(own.ts[i]))
                for i, (t, _) in enumerate(grid[:m]))
    g_err = _max_rel(g, cpu_runs[0][1])
    print(f"dense output grids: card {len(grid)} accepted steps, CPU "
          f"{own.n_accepted}; over the first {m}: max |h_card/h_cpu - 1| "
          f"{h_rel:.3e}, max |t_card - t_cpu| {t_abs:.3e}; gradients, card "
          f"vs CPU on their own grids: worst rel err {g_err:.3e}")
    # which part of the card's solve moves its grid: the same solve on the
    # card with the plain combines (torch ops, core/combine.py's "torch"
    # backend) in place of the kernels, and one field evaluation card vs CPU
    plain = rk_solve_adaptive(field, tab, u0, 0.0, ts[-1], params, acfg,
                              combine_backend="torch")
    mp = min(plain.n_accepted, own.n_accepted)
    h_plain = max(abs(float(plain.hs[i]) / float(own.hs[i]) - 1.0)
                  for i in range(mp))
    h_kp = max(abs(float(grid[i][1]) / float(plain.hs[i]) - 1.0)
               for i in range(min(m, plain.n_accepted)))
    f_card = field(u0, torch.zeros((), dtype=u0.dtype, device=u0.device),
                   params)
    f_cpu = field(u0.cpu(), torch.zeros((), dtype=u0.dtype), cpu_params)
    f_err = _max_rel([f_card.detach()], [f_cpu.detach()])
    print(f"dopri8 grid on the card, float64: kernel combines max "
          f"|h/h_cpu - 1| {h_rel:.3e}; plain combines {h_plain:.3e} "
          f"({plain.n_accepted} accepted steps); kernel vs plain on the card "
          f"{h_kp:.3e}; one field evaluation at u0, card vs CPU: worst rel "
          f"err {f_err:.3e}")
    print(f"dense output, card vs CPU replay of the card's {len(grid)} "
          f"accepted steps: worst rel err of values and gradients "
          f"{err:.3e}; the CPU's own change under a 1e-15 relative change "
          f"of u0 (its own grids): {sens:.3e}")
    check(err <= 1e-9, f"dense output on the same grid, card vs CPU: rel "
                       f"err {err}")


def _flow_nll(params, u, eps, cfg, ts):
    """The CNF's NLL read at the flow path's last point (the t1 loss when
    ts ends at t1)."""
    from repro_torch.models.cnf import cnf_flow_path
    xs, dlps = cnf_flow_path(params, u, eps, cfg, ts)
    z, dlp = xs[-1], dlps[-1]
    logpz = -0.5 * torch.sum(z ** 2, -1) - \
        0.5 * cfg.dim * math.log(2 * math.pi)
    return -torch.mean(logpz - dlp)


def _warm_peak_bytes(fn):
    """``_peak_bytes`` of a second call: the first call's one-time
    allocations (a library's workspace) do not count."""
    fn()
    return _peak_bytes(fn)


def saveat_memory():
    """SaveAt(ts) against SaveAt(t1) over the same 32 checkpoints: peak
    bytes of one float32 CNF loss+gradient."""
    import dataclasses
    import numpy as np
    from repro_torch.launch.train_cnf import make_config
    from repro_torch.models.cnf import init_cnf
    phase("26 SaveAt memory (float32, MiniBooNE CNF, batch 256, dopri5)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(26)
    ts = (np.arange(1, 9) / 8.0).tolist()
    out = {}
    for mode in ("symplectic", "backprop"):
        t1_cfg = make_config("miniboone", n_steps=32, grad_mode=mode)
        ts_cfg = dataclasses.replace(t1_cfg, n_steps=4)
        params = init_cnf(t1_cfg, seed=0, device=dev)
        u = torch.randn((256, t1_cfg.dim), generator=g, device=dev)
        eps = torch.randn(u.shape, generator=g, device=dev)
        p_t1, p_ts = (_warm_peak_bytes(fn) for fn in (
            lambda: _loss_and_grads(t1_cfg, params, u, eps),
            lambda: _value_and_grads(_flow_nll, params, u, eps, ts_cfg,
                                     ts)))
        obs_bytes = len(ts) * (2 * u.numel() + u.shape[0]) * u.element_size()
        out[mode] = (p_t1, p_ts)
        print(f"{mode}: peak_bytes SaveAt(t1) N=32 {p_t1}, SaveAt(ts) 8 x 4 "
              f"steps {p_ts} (ts - t1 = {p_ts - p_t1}; allowed for the "
              f"symplectic adjoint: 10 % of t1 {0.1 * p_t1:.0f} + the 8 "
              f"observations {obs_bytes})")
        if mode == "symplectic":
            check(abs(p_ts - p_t1) <= 0.1 * p_t1 + obs_bytes,
                  f"symplectic SaveAt(ts) peak {p_ts} vs SaveAt(t1) {p_t1}")
    # per-sample adaptive: ts (8 segments) against t1
    cfg, params, u, eps = _per_sample_inputs(256)
    p_t1, p_ts = (_warm_peak_bytes(fn) for fn in (
        lambda: _loss_and_grads(cfg, params, u, eps),
        lambda: _value_and_grads(_flow_nll, params, u, eps, cfg, ts)))
    rows = _lane_residual_rows(cfg, params, u, eps, ts)
    out["per_sample"] = (p_t1, p_ts)
    print(f"per-sample symplectic: peak_bytes SaveAt(t1) {p_t1}, SaveAt(ts) "
          f"8 segments {p_ts} (ratio {p_ts / p_t1:.3f}); residual checkpoint "
          f"rows per segment {rows} (sum {sum(rows)}; whole buffers would "
          f"be {len(ts)} x {cfg.max_steps + 1})")
    return out


def _lane_residual_rows(cfg, params, u, eps, ts):
    """The checkpoint rows the lane SaveAt driver keeps, per segment."""
    from repro_torch.core import AdaptiveConfig, get_tableau
    from repro_torch.core.rk import rk_solve_adaptive_batched_saveat_stacked
    from repro_torch.models.cnf import cnf_field, component
    state = (u[:, None], torch.zeros((u.shape[0], 1), dtype=u.dtype,
                                     device=u.device), eps[:, None])
    acfg = AdaptiveConfig(rtol=cfg.rtol, atol=cfg.atol,
                          max_steps=cfg.max_steps)
    with torch.no_grad():
        _, sols = rk_solve_adaptive_batched_saveat_stacked(
            cnf_field(cfg), get_tableau(cfg.method), state, 0.0,
            torch.tensor(ts, dtype=u.dtype, device=u.device),
            component(params, 0), acfg)
    return [int(s.ts.shape[0]) for s in sols]


def cnf_flow_path_phase():
    """cnf_flow_path at MiniBooNE width: endpoint against cnf_forward, ms
    and launches, fixed and per-sample."""
    import dataclasses
    from repro_torch.launch.train_cnf import make_config
    from repro_torch.models.cnf import cnf_flow_path, cnf_forward, init_cnf
    phase("27 CNF flow path (MiniBooNE, batch 256, 8 observation times)")
    dev = torch.device("cuda")
    ts = [k / 8.0 for k in range(1, 9)]
    out = {}
    for kind in ("fixed", "per_sample"):
        for dtype, rtol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
            if kind == "fixed":
                cfg = make_config("miniboone", n_steps=1)
                params = init_cnf(cfg, seed=0, device=dev, dtype=dtype)
                g = torch.Generator(device=dev).manual_seed(27)
                u = torch.randn((256, cfg.dim), generator=g, device=dev,
                                dtype=dtype)
                eps = torch.randn(u.shape, generator=g, device=dev,
                                  dtype=dtype)
                # 8 segments of 1 step: cnf_forward's grid of 8 steps
                ref_cfg, path_ts = dataclasses.replace(cfg, n_steps=8), ts
            else:
                cfg, params, u, eps = _per_sample_inputs(256, dtype)
                ref_cfg, path_ts = cfg, [cfg.t1]
            with torch.no_grad():
                xs, dlps = cnf_flow_path(params, u, eps, cfg, path_ts)
                z, dlp = cnf_forward(params, u, eps, ref_cfg)
            n_pts = cfg.n_components * len(path_ts)
            check(xs.shape == (n_pts,) + u.shape,
                  f"flow path {kind}: xs shape {tuple(xs.shape)}")
            err = max(_max_rel([xs[-1]], [z]), _max_rel([dlps[-1]], [dlp]))
            check(err <= rtol, f"flow path {kind} {dtype}: endpoint rel err "
                               f"{err} > {rtol}")
            print(f"flow path {kind} {dtype}: endpoint == cnf_forward, rel "
                  f"err {err:.3e} (rtol {rtol})")
        # ms and launches: the 8-observation path, float32, loss+gradient
        if kind == "per_sample":
            cfg, params, u, eps = _per_sample_inputs(256)
        else:
            params = init_cnf(cfg, seed=0, device=dev)
            u, eps = u.float(), eps.float()
        res = _cell_measure(lambda: _value_and_grads(_flow_nll, params, u,
                                                     eps, cfg, ts))
        res.pop("last")
        out[kind] = res
        print(f"flow path {kind}: one loss+gradient over 8 observations: "
              f"ms {res['ms']:.3f} (median of 3: "
              f"{', '.join(f'{x:.3f}' for x in res['times'])}) peak_bytes "
              f"{res['peak_bytes']} launches butcher_combine "
              f"{res['butcher_combine']} butcher_combine_rows "
              f"{res['butcher_combine_rows']}")
        check(res["butcher_combine"] > 0,
              f"flow path {kind}: butcher_combine never launched")
        if kind == "per_sample":
            check(res["butcher_combine_rows"] > 0,
                  "flow path per_sample: butcher_combine_rows never launched")
    return out


# ---------------------------------------------------------------------------
# The ODE solve server: the continuous-batching SolveEngine

# benchmarks/bench_serve.py::main's configuration, nothing cut: a tanh-MLP
# field at dim 1024, hidden 1024, dopri5, float32; 20 requests of horizons
# uniform in [0.5, 1.0] and tolerances drawn from three pairs (stream seed
# 7); max_steps 96, lane buckets (8, 16); Poisson loads at 0.5x and 1.5x
# the naive baseline's rate
SERVE_ODE = dict(dim=1024, hidden=1024, requests=20, max_steps=96,
                 buckets=(8, 16), t1_range=(0.5, 1.0), seed=7,
                 tol_choices=((1e-3, 1e-5), (1e-4, 1e-6), (3e-4, 3e-6)),
                 loads=(0.5, 1.5))
# the exactness phase's small width (float64)
SERVE_EXACT = dict(dim=8, hidden=16, requests=10, max_steps=128,
                   buckets=(2, 4, 8), seed=3)


def _serve_engine(dim, hidden, max_steps, buckets, dtype=torch.float32,
                  device="cuda"):
    """A SolveEngine of the ``serve ode`` launcher's field, weights (seed 0)
    and controller, through the port's API; returns (make_engine, field,
    cfg, params): ``make_engine()`` builds a fresh engine."""
    from repro_torch.core import get_tableau
    from repro_torch.launch.serve import ode_config, ode_field, ode_params
    from repro_torch.serve import EngineConfig, SolveEngine
    params = ode_params(dim, hidden, 0, dtype, device)
    cfg = ode_config(max_steps)

    def make_engine():
        return SolveEngine(ode_field, get_tableau("dopri5"), cfg, params,
                           torch.zeros(dim, dtype=dtype, device=device),
                           EngineConfig(buckets=tuple(buckets)))
    return make_engine, ode_field, cfg, params


def _timed_engine(make_engine):
    """A fresh engine and its construction seconds (engine_init_s: each
    bucket's warm-up attempt included)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    engine = make_engine()
    torch.cuda.synchronize()
    return engine, time.perf_counter() - t


def _serve_run(label, engine, init_s, run, n):
    """One counted engine run: prints req/s, p50/p99, engine_init_s, the
    engine's stats, the combines' launches (per engine step) and the CUDA
    synchronisations (per step); checks every request succeeded and syncs
    <= one per eviction sweep plus one per harvested lane."""
    from repro_torch.serve import latency_summary
    t = time.perf_counter()
    results, syncs, (one, rows) = _counted(run)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    lat = latency_summary(results)
    st = engine.stats
    steps = st["steps_total"]
    ok = sum(r.succeeded for r in results.values())
    print(f"  {label}: {n} requests ({ok} ok) in {wall:.6f} s -> "
          f"{n / wall:.3f} req/s; latency p50 {lat['p50_ms']:.3f} ms p99 "
          f"{lat['p99_ms']:.3f} ms; engine_init_s {init_s:.6f}; stats "
          f"{st}; launches butcher_combine "
          f"{one} ({one / steps:.3f}/step) butcher_combine_rows {rows} "
          f"({rows / steps:.3f}/step); CUDA synchronisations {syncs} "
          f"({syncs / steps:.3f}/step)")
    check(len(results) == n and ok == n,
          f"serve ode {label}: {ok} of {n} requests succeeded")
    check(syncs <= steps // engine.engine_cfg.check_every + n,
          f"serve ode {label}: {syncs} synchronisations in {steps} steps "
          f"and {n} harvests")
    check(one == 6 * steps and rows == steps,
          f"serve ode {label}: {one} one-row and {rows} rows launches in "
          f"{steps} dopri5 steps (6 and 1 per step)")
    return {"rps": n / wall, "wall_s": wall, **lat, "stats": st,
            "engine_init_s": init_s,
            "butcher_combine": one, "butcher_combine_rows": rows,
            "syncs": syncs}


def serve_ode_main_path():
    """bench_serve's configuration through the engine: the naive baseline,
    a drain run, two Poisson loads; then the CLI at its defaults."""
    from repro_torch.core import get_tableau
    from repro_torch.launch import serve
    from repro_torch.serve import (naive_sequential_solve, poisson_arrivals,
                                   serve_timed, synthetic_stream)
    c = SERVE_ODE
    phase("28 serve ode (main path): bench_serve's configuration, dim "
          f"{c['dim']}, hidden {c['hidden']}, {c['requests']} requests, "
          f"buckets {c['buckets']}, float32")
    make_engine, field, cfg, params = _serve_engine(
        c["dim"], c["hidden"], c["max_steps"], c["buckets"])
    n = c["requests"]
    reqs = synthetic_stream(n, c["dim"], seed=c["seed"],
                            t1_range=c["t1_range"],
                            tol_choices=c["tol_choices"], device="cuda")
    sols, lats = naive_sequential_solve(field, get_tableau("dopri5"), cfg,
                                        params, reqs)
    wall_n = float(sum(lats))
    rps_n = n / wall_n
    ok_n = sum(bool(s.succeeded) for s in sols)
    print(f"  naive sequential: {n} requests ({ok_n} ok) in {wall_n:.6f} s "
          f"-> {rps_n:.3f} req/s; per-solve p50 "
          f"{sorted(lats)[n // 2] * 1e3:.3f} ms, max {max(lats) * 1e3:.3f} "
          f"ms; accepted steps {[int(s.n_accepted) for s in sols]}")
    check(ok_n == n, f"serve ode naive: {ok_n} of {n} succeeded")
    engine, init_s = _timed_engine(make_engine)
    print(f"  engine_init_s {init_s:.6f} (the first engine; each bucket "
          f"warmed)")
    engine.run(reqs)                        # throwaway run
    engine, init_s = _timed_engine(make_engine)
    out = {"naive_rps": rps_n}
    out["drain"] = _serve_run("drain", engine, init_s,
                              lambda: engine.run(reqs), n)
    st = out["drain"]["stats"]
    check(st["lanes"] == c["buckets"][-1],
          f"serve ode: lanes {st['lanes']}, not grown to {c['buckets'][-1]}")
    check(st["inserted_while_running"] > 0,
          "serve ode: no request joined a running batch")
    print(f"  drain: {out['drain']['rps'] / rps_n:.3f}x the naive rate")
    for k in c["loads"]:
        engine, init_s = _timed_engine(make_engine)
        arrivals = poisson_arrivals(n, k * rps_n, seed=c["seed"])
        out[f"load_{k}"] = _serve_run(
            f"Poisson {k}x naive ({k * rps_n:.3f} req/s offered)", engine,
            init_s, lambda: serve_timed(engine, reqs, arrivals), n)
    cli = serve.main(["ode", "--naive"])
    check(cli["ok"] == cli["requests"] and
          cli["naive"]["ok"] == cli["requests"],
          f"serve ode CLI: {cli['ok']} / {cli['naive']['ok']} of "
          f"{cli['requests']} succeeded")
    out["cli"] = cli
    return out


def _same_result(got, want, rtol):
    """Integer stats equal and x_final equal (rtol None) or within rtol of
    the largest entry."""
    stats = ("succeeded", "n_accepted", "n_fevals", "n_attempts")
    if tuple(getattr(got, k) for k in stats) != \
            tuple(getattr(want, k) for k in stats):
        return False
    a, b = got.x_final.cpu(), want.x_final.cpu()
    if rtol is None:
        return torch.equal(a, b)
    return float((a - b).abs().max()) <= rtol * float(b.abs().max())


def serve_exactness():
    from repro_torch.serve import synthetic_stream
    c = SERVE_EXACT
    phase(f"29 serve exactness (float64, dim {c['dim']}, hidden "
          f"{c['hidden']}, buckets {c['buckets']})")
    args = (c["dim"], c["hidden"], c["max_steps"])
    f64 = dict(dtype=torch.float64)
    make, _, _, _ = _serve_engine(*args, c["buckets"], **f64)
    make_top, _, _, _ = _serve_engine(*args, c["buckets"][-1:], **f64)
    make_low, _, _, _ = _serve_engine(*args, c["buckets"][:1], **f64)
    make_cpu, _, _, _ = _serve_engine(*args, c["buckets"], device="cpu",
                                      **f64)
    n = c["requests"]
    reqs = synthetic_stream(n, c["dim"], seed=c["seed"], dtype=torch.float64,
                            device="cuda")
    engine = make()
    results = engine.run(reqs)
    check(engine.stats["lanes"] == c["buckets"][-1] and
          engine.stats["inserted_while_running"] > 0,
          f"serve exactness: stats {engine.stats}")
    worst = 0.0
    for rid, req in enumerate(reqs):
        check(_same_result(results[rid], make_top().run([req])[0], None),
              f"request {rid}: not bitwise equal to serving it alone at "
              f"B {c['buckets'][-1]}")
        alone = make_low().run([req])[0]
        check(_same_result(results[rid], alone, 1e-12),
              f"request {rid}: served at B {c['buckets'][-1]} and alone at "
              f"B {c['buckets'][0]} differ beyond rtol 1e-12")
        worst = max(worst, float((results[rid].x_final - alone.x_final)
                                 .abs().max() / alone.x_final.abs().max()))
    print(f"  shared state == alone at the same bucket, bitwise ({n} "
          f"requests); across buckets stats equal, worst rel err "
          f"{worst:.3e}")
    cpu_reqs = [r._replace(x0=r.x0.cpu()) for r in reqs]
    cpu = make_cpu().run(cpu_reqs)
    worst = 0.0
    for rid in range(n):
        check(_same_result(results[rid], cpu[rid], 1e-9),
              f"request {rid}: card and CPU engines differ (stats or "
              f"rtol 1e-9)")
        worst = max(worst, float((results[rid].x_final.cpu()
                                  - cpu[rid].x_final).abs().max()
                                 / cpu[rid].x_final.abs().max()))
    print(f"  card == the port's CPU engine: stats equal, worst rel err "
          f"{worst:.3e}")
    full = make().run(reqs)
    engine = make()
    for r in reqs:
        engine.submit(r)
    paused = {}
    for _ in range(5):
        engine.step(paused)
    check(engine.occupancy > 0, "serve exactness: nothing in flight at the "
                                "pause")
    from torch.utils import _pytree as pytree
    engine._state = pytree.tree_map(
        lambda l: torch.from_numpy(l.cpu().numpy().copy()).to(l.device)
        if isinstance(l, torch.Tensor) else l, engine._state)
    while engine.pending or engine.occupancy:
        engine.step(paused)
    check(sorted(paused) == sorted(full) and
          all(_same_result(paused[r], full[r], None) for r in full),
          "serve exactness: the run paused card -> CPU -> card differs "
          "from the uninterrupted run")
    print(f"  pause/resume (slot state card -> host -> card after 5 steps, "
          f"{engine.stats['steps_total']} steps): bitwise equal")


def serve_report(launches):
    """Both lane forms at the engine's call shape (B 16, n_lane 1024, s 7,
    m 2), held against their plain versions (fatal) and timed beside them,
    one torch.baddbmm and the byte bound; and one engine step under
    torch.profiler."""
    from repro_torch.kernels import butcher_combine as kern
    from repro_torch.kernels import ref
    from repro_torch.serve import synthetic_stream
    c = SERVE_ODE
    B, n_lane, s, m, esize = c["buckets"][-1], c["dim"], MAIN_S, 2, 4
    phase(f"30 serve report (float32, B {B}, n_lane {n_lane}, s {s}, m {m})")
    dev = torch.device("cuda")
    n = B * n_lane
    g = torch.Generator(device=dev).manual_seed(30)
    x = torch.randn((B, n_lane), generator=g, device=dev)
    ks = torch.randn((s, B, n_lane), generator=g, device=dev)
    hc = torch.randn((B, s), generator=g, device=dev)
    hm = torch.randn((B, m, s), generator=g, device=dev)
    sc = torch.tensor([1.0, 0.0], device=dev)
    xb, kb, hb = x.view(B, 1, n_lane), ks.transpose(0, 1), hc.view(B, 1, s)
    xa, ka = x.abs(), ks.abs()
    rows = []
    for name, fn, plain, lib, nbytes, mag in (
            ("butcher_combine_lanes", lambda: kern.butcher_combine(x, ks, hc),
             lambda: ref.butcher_combine_ref(x, ks, hc, 1.0),
             lambda: torch.baddbmm(xb, hb, kb),
             (s + 2) * n * esize + B * s * esize,
             xa + torch.einsum("bi,ibn->bn", hc.abs(), ka)),
            ("butcher_combine_rows_lanes",
             lambda: kern.butcher_combine_rows(x, ks, hm, sc),
             lambda: ref.butcher_combine_rows_ref(x, ks, hm, sc, 1.0), None,
             (s + 1 + m) * n * esize + (B * m * s + m) * esize,
             sc.abs()[:, None, None] * xa
             + torch.einsum("bri,ibn->rbn", hm.abs(), ka))):
        kname = name[:-len("_lanes")] + "_kernel"
        ok, err = _close(fn(), plain(), mag, torch.float32)
        check(ok, f"serve report {name}: kernel and plain differ, max abs "
                  f"err {err}")
        t_k, t_p = _time_ms(fn), _time_ms(plain)
        t_l = _time_ms(lib) if lib is not None else None
        d_k = _device_ms(fn, kname)
        h_k = _host_ms(fn)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        per_step = 1 if "rows" in name else 6
        print(f"  {name}: kernel {t_k:.6f} ms (device "
              f"{d_k if d_k is None else f'{d_k:.6f}'}, host {h_k:.6f}) "
              f"plain {t_p:.6f} "
              + ("" if t_l is None else f"baddbmm {t_l:.6f} kernel/baddbmm "
                 f"{t_k / t_l:.3f} ")
              + f"bound {bound:.6f} ({nbytes} bytes); max abs err vs plain "
              f"{err}; launches "
              f"{launches[name[:-len('_lanes')]]} in phase 28's drain run, "
              f"{per_step} per engine step")
        rows.append(dict(shape=f"float32 B={B} n_lane={n_lane} s={s}"
                         + (f" m={m}" if "rows" in name else ""),
                         ms=t_k, device_ms=d_k, host_ms=h_k, plain_ms=t_p,
                         library_ms=t_l, bound_ms=bound, max_abs_err=err))
    make_engine, _, _, _ = _serve_engine(c["dim"], c["hidden"],
                                         c["max_steps"], c["buckets"])
    engine = make_engine()
    for r in synthetic_stream(c["requests"], c["dim"], seed=c["seed"],
                              t1_range=c["t1_range"],
                              tol_choices=c["tol_choices"], device="cuda"):
        engine.submit(r)
    results = {}
    for _ in range(3):
        engine.step(results)
    _profile_once(f"engine step ({engine.occupancy} of {engine.stats['lanes']}"
                  " lanes occupied)", lambda: engine.step(results))
    return rows


# ---------------------------------------------------------------------------
# LM training: qwen3-0.6b at full width, discrete and node mode, with the
# backward kernels of rms_norm and flash attention

TRAIN_BATCH, TRAIN_SEQ = 8, 1024
# phase 35 at 4 of the 28 layers, to keep the whole script inside its
# limit (each of its checkpoints' writes and reads falls from 7.2 to 2.6 GB;
# resuming does not depend on the depth)
RESUME = dict(batch=4, seq=512, steps=4, layers=4)
BWD_TOL = {torch.float32: 1e-4, torch.float64: 1e-12}
RMS_BWD_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
NODE_PEAK_CHUNK64 = 5.5e9       # bytes, phase 34's node-symplectic bound
LM_KERNELS = ("rms_norm", "flash_attention", "rms_norm_bwd",
              "flash_attention_bwd", "butcher_combine",
              "butcher_combine_rows")


def _timed(fn, *args):
    t = time.perf_counter()
    out = fn(*args)
    print(f"phase seconds {time.perf_counter() - t:.1f}")
    return out


def _rel_err(got, want):
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max().clamp_min(1e-300))


def _all_counts():
    from repro_torch.kernels import butcher_combine as bc
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    return {"rms_norm": rn.rms_norm.launches,
            "flash_attention": fa.flash_attention.launches,
            "rms_norm_bwd": rn.rms_norm_bwd.launches,
            "flash_attention_bwd": fa.flash_attention_bwd.launches,
            "butcher_combine": bc.butcher_combine.launches,
            "butcher_combine_rows": bc.butcher_combine_rows.launches}


def _zero_all_counts():
    from repro_torch.kernels import butcher_combine as bc
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    for fn in (rn.rms_norm, fa.flash_attention, rn.rms_norm_bwd,
               fa.flash_attention_bwd, bc.butcher_combine,
               bc.butcher_combine_rows):
        fn.launches = 0


# (B, H, Hkv, Sq, Sk, D, causal, window, q_offset)
BWD_CASES = [
    (8, 16, 8, 1024, 1024, 128, True, None, 0),   # qwen3-0.6b training
    # internvl2-1b's per-rank training shape on "model" 2 (phase 53): 7 of
    # its 14 heads over 1 of 2 kv heads, GQA group 7
    (8, 7, 1, 1024, 1024, 64, True, None, 0),
    (1, 4, 1, 128, 128, 128, True, 64, 0),        # MQA + window
    (1, 4, 2, 100, 100, 64, True, None, 0),       # ragged
    (1, 4, 4, 64, 256, 64, True, None, 192),      # q_offset, Sq != Sk
    (1, 4, 2, 200, 150, 32, False, None, 0),      # D 32, Sq > Sk
    (1, 4, 2, 200, 200, 16, True, None, 0),       # D 16
    (1, 16, 4, 300, 300, 128, True, 100, 0),      # GQA 4 + window
    (2, 8, 2, 65, 300, 64, True, 40, 235),        # window + offset
    # the float32 kernels' tiles cut off-edge (64 keys x 16 queries for
    # dK/dV and the dS blocks, 128 queries x 32 keys for dQ), GQA groups 1,
    # 2, 4 and every head dim (tests/test_torch_cuda.py::BWD_EDGE_CASES)
    (1, 4, 4, 77, 77, 16, True, None, 0),         # group 1, D 16, ragged
    (1, 4, 2, 130, 200, 32, False, None, 0),      # group 2, D 32
    (1, 8, 2, 100, 333, 64, True, None, 233),     # group 4, q_offset
    (1, 4, 4, 256, 256, 128, True, 8, 0),         # window under one tile
    (2, 8, 4, 48, 300, 128, True, 20, 252),       # window + offset, Sq < Sk
    (1, 8, 2, 129, 129, 32, True, 5, 0),          # window 5, one past 128
]


# rms_norm_bwd's (rows, d) in a training step at batch 8 x 1024: the
# blocks' and the final norm (57 calls), q_norm (28), k_norm (28)
RMS_BWD_SHAPES = ((8192, 1024), (131072, 128), (65536, 128))

# the backward variants of bfloat16 training and of head dim 160 (the
# bfloat16 wgmma kernels of csrc/flash_attention_bwd.cu, its FMA kernels
# for float32 at D 160): the shapes of the training paths (qwen3-0.6b's,
# stablelm-12b's B 8, H 32/8, D 160, internvl2-1b's GQA 7,
# seamless-m4t-medium's non-causal encoder) and tiles cut off-edge; the
# bfloat16 cases from "group 1" on cut the wgmma kernels' tiles (dK/dV 64
# keys over 64-query steps; dQ 128 queries, 64 a warpgroup, over 64-key
# steps) at every head dim: one past a tile,
# Sq < Sk with q_offset, windows under one tile, GQA groups 1, 2, 4 and 7
# (tests/test_torch_cuda.py::BWD_BF16_EDGE_CASES)
BWD_NEW_CASES = {
    torch.bfloat16: [
        (8, 16, 8, 1024, 1024, 128, True, None, 0),   # qwen3-0.6b training
        (8, 32, 8, 1024, 1024, 160, True, None, 0),   # stablelm-12b
        (8, 7, 1, 1024, 1024, 64, True, None, 0),     # internvl2-1b, GQA 7
        (8, 16, 16, 1024, 1024, 64, False, None, 0),  # seamless encoder
        (1, 4, 2, 100, 100, 160, True, None, 0),      # ragged
        (2, 8, 2, 65, 300, 160, True, 40, 235),       # window + offset
        (1, 4, 1, 128, 128, 160, True, 64, 0),        # MQA + window
        (1, 4, 2, 200, 150, 32, False, None, 0),      # D 32, Sq > Sk
        (1, 4, 2, 200, 200, 16, True, None, 0),       # D 16
        (1, 8, 2, 100, 333, 64, True, None, 233),     # group 4, q_offset
        (1, 8, 2, 129, 129, 32, True, 5, 0),          # window 5
        (1, 4, 4, 129, 129, 16, True, None, 0),       # group 1, 128 + 1
        (1, 7, 1, 65, 65, 16, False, None, 0),        # GQA 7, 64 + 1
        (1, 4, 2, 65, 193, 32, True, None, 128),      # group 2, Sq < Sk
        (1, 8, 2, 129, 129, 32, True, 16, 0),         # group 4, window 16
        (1, 8, 2, 129, 257, 64, False, None, 0),      # group 4, Sq < Sk
        (1, 7, 1, 130, 130, 64, True, None, 0),       # GQA 7, ragged
        (1, 4, 4, 100, 333, 64, True, 30, 233),       # window + offset
        (1, 14, 2, 65, 65, 128, True, None, 0),       # GQA 7, 64 + 1
        (1, 8, 4, 129, 129, 128, True, 40, 0),        # group 2, window 40
        (1, 8, 2, 65, 321, 128, True, None, 256),     # group 4, Sq < Sk
        (1, 4, 4, 1, 129, 128, True, None, 128),      # one query
        (1, 4, 4, 33, 97, 160, True, None, 64),       # 32 + 1, offset
        (1, 8, 4, 129, 129, 160, True, 20, 0),        # group 2, window 20
        (1, 7, 1, 65, 65, 160, True, None, 0),        # GQA 7
        (1, 8, 2, 129, 200, 160, False, None, 0)],    # group 4, Sq < Sk
    torch.float32: [
        (8, 32, 8, 1024, 1024, 160, True, None, 0),   # stablelm-12b
        (1, 4, 2, 100, 100, 160, True, None, 0),
        (2, 8, 2, 65, 300, 160, True, 40, 235),
        (1, 4, 1, 128, 128, 160, True, 64, 0),
        (1, 4, 2, 130, 200, 160, False, None, 0)],    # non-causal, Sq < Sk
}
# the timed variants: the kernels line's rows
BWD_VARIANTS = {
    "flash_attention_bwd_bf16": (BWD_NEW_CASES[torch.bfloat16][0],
                                 torch.bfloat16),
    "flash_attention_bwd_bf16_d160": (BWD_NEW_CASES[torch.bfloat16][1],
                                      torch.bfloat16),
    "flash_attention_bwd_d160": (BWD_NEW_CASES[torch.float32][0],
                                 torch.float32),
}
RMS_BWD_BF16 = (8192, 5120)        # stablelm-12b's norms at batch 8 x 1024


def _bwd_inputs(case, dtype, g):
    """q, k, v, dout of one backward case (B, H, Hkv, Sq, Sk, D, ...)."""
    B, H, Hkv, Sq, Sk, D = case[:6]
    dev = torch.device("cuda")
    q, do = (torch.randn(B, H, Sq, D, generator=g, device=dev, dtype=dtype)
             for _ in range(2))
    k, v = (torch.randn(B, Hkv, Sk, D, generator=g, device=dev, dtype=dtype)
            for _ in range(2))
    return q, k, v, do


def _bwd_device_times_child():
    """Phase 31's kernel times alone, in a process of its own: both
    backward wrappers at the training shapes (float32) under torch.profiler,
    every kernel of each call counted (rms_norm_bwd two, flash three);
    prints them as its last line."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(31)
    out = {}
    for rows, d in RMS_BWD_SHAPES:
        x, dy = (torch.randn(rows, d, generator=g, device=dev)
                 for _ in range(2))
        w = torch.randn(d, generator=g, device=dev)
        out[f"rms_norm_bwd {rows}x{d}"] = _device_ms(
            lambda: rn.rms_norm_bwd(x, w, None, dy), "rms_norm_bwd", 50, 2)
        del x, dy
    B, H, Hkv, S, D = 8, 16, 8, 1024, 128
    q, do = (torch.randn(B, H, S, D, generator=g, device=dev)
             for _ in range(2))
    k, v = (torch.randn(B, Hkv, S, D, generator=g, device=dev)
            for _ in range(2))
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    out["flash_attention_bwd"] = _device_ms(
        lambda: fa.flash_attention_bwd(q, k, v, o, lse, do), "attn_bwd", 20,
        3)
    del q, k, v, do, o, lse
    # the bfloat16 and D 160 variants (phase 31's second part), and the
    # bfloat16 forward with lse at the bfloat16 shapes
    for name, (case, dtype) in BWD_VARIANTS.items():
        q, k, v, do = _bwd_inputs(case, dtype, g)
        o, lse = fa.flash_attention(q, k, v, return_lse=True)
        out[name] = _device_ms(
            lambda: fa.flash_attention_bwd(q, k, v, o, lse, do), "attn_bwd",
            5, 3)
        if dtype == torch.bfloat16:
            out[name + " forward_lse"] = _device_ms(
                lambda: fa.flash_attention(q, k, v, return_lse=True),
                "flash_attention_kernel", 5, 1)
        del q, k, v, do, o, lse
    x, dy = (torch.randn(*RMS_BWD_BF16, generator=g, device=dev,
                         dtype=torch.bfloat16) for _ in range(2))
    w = torch.randn(RMS_BWD_BF16[1], generator=g, device=dev,
                    dtype=torch.bfloat16)
    out["rms_norm_bwd_bf16"] = _device_ms(
        lambda: rn.rms_norm_bwd(x, w, None, dy), "rms_norm_bwd", 50, 2)
    print(json.dumps(out), flush=True)


def _bwd_device_times():
    """Run ``_bwd_device_times_child`` and return its times; fails the phase
    when any is missing."""
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           BWD_TIMES_CHILD], capture_output=True, text=True,
                          timeout=300)
    lines = proc.stdout.rstrip("\n").splitlines()
    if lines[:-1]:
        print("\n".join(lines[:-1]))
    check(proc.returncode == 0 and lines,
          f"device-time process failed (rc {proc.returncode}):\n"
          f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    times = json.loads(lines[-1])
    for name, ms in times.items():
        check(ms is not None, f"{name}: no complete device time from the "
                              f"profiler")
    return times


def backward_kernels_vs_plain():
    """Phase 31: both backward kernels against their plain versions on the
    card, bitwise against themselves, then their times."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn
    phase("31 backward kernels vs plain (rms_norm_bwd, flash_attention_bwd; "
          "float32 and float64, then bfloat16 and head dim 160)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(31)
    max_err = {"rms_norm_bwd": 0.0, "flash_attention_bwd": 0.0}
    n = 0
    for dtype in (torch.float32, torch.float64):
        # the training shapes, a partial last chunk (12345 rows), fewer
        # rows than one chunk (20), d 1000 and 16
        for rows, d in RMS_BWD_SHAPES + ((12345, 1024), (20, 128),
                                         (77, 1000), (5, 16)):
            x, r, dy = (torch.randn(rows, d, generator=g, device=dev,
                                    dtype=dtype) for _ in range(3))
            w = torch.randn(d, generator=g, device=dev, dtype=dtype)
            for res in (None, r):
                dx, dw = rn.rms_norm_bwd(x, w, res, dy)
                dx2, dw2 = rn.rms_norm_bwd(x, w, res, dy)
                wdx, wdw, _ = ref.rms_norm_bwd_ref(x, w, res, dy)
                e = max(_rel_err(dx, wdx), _rel_err(dw, wdw))
                check(e <= RMS_BWD_TOL[dtype],
                      f"rms_norm_bwd {dtype} {rows}x{d} residual="
                      f"{res is not None}: rel err {e}")
                check(torch.equal(dx, dx2) and torch.equal(dw, dw2),
                      f"rms_norm_bwd {dtype} {rows}x{d}: two calls differ")
                if dtype == torch.float32:
                    max_err["rms_norm_bwd"] = max(
                        max_err["rms_norm_bwd"],
                        float((dx - wdx).abs().max()))
                n += 1
        for case in BWD_CASES:
            if dtype == torch.float64 and case[0] == 8:
                case = (2,) + case[1:]
            B, H, Hkv, Sq, Sk, D, causal, window, q_offset = case
            kw = dict(causal=causal, window=window, q_offset=q_offset)
            q = torch.randn(B, H, Sq, D, generator=g, device=dev, dtype=dtype)
            k, v = (torch.randn(B, Hkv, Sk, D, generator=g, device=dev,
                                dtype=dtype) for _ in range(2))
            do = torch.randn(B, H, Sq, D, generator=g, device=dev,
                             dtype=dtype)
            o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
            e_lse = float((lse - ref.attention_lse_ref(q, k, **kw).float())
                          .abs().max())
            check(e_lse <= 1e-4, f"flash lse {dtype} {case}: err {e_lse}")
            got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
            again = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
            want = ref.attention_bwd_ref(q, k, v, o, lse, do, **kw)
            errs = [_rel_err(a, b) for a, b in zip(got, want)]
            check(max(errs) <= BWD_TOL[dtype],
                  f"flash_attention_bwd {dtype} {case}: rel errs {errs}")
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"flash_attention_bwd {dtype} {case}: two calls differ")
            if dtype == torch.float32:
                max_err["flash_attention_bwd"] = max(
                    max_err["flash_attention_bwd"],
                    max(float((a - b).abs().max())
                        for a, b in zip(got, want)))
            n += 1
            del got, again, want
    torch.cuda.synchronize()
    print(f"backward cases {n} within tolerance and bitwise repeatable; "
          f"float32 max abs err {max_err}")

    # times at the training shapes, float32
    lines, main = [], {}
    alone = _bwd_device_times()
    by_shape = {}
    for rows, d in RMS_BWD_SHAPES:
        x, dy = (torch.randn(rows, d, generator=g, device=dev)
                 for _ in range(2))
        w = torch.randn(d, generator=g, device=dev)
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        y_lib = F.rms_norm(xr, (d,), wr, 1e-6)
        t_k = _time_ms(lambda: rn.rms_norm_bwd(x, w, None, dy), 100, 10)
        t_p = _time_ms(lambda: ref.rms_norm_bwd_ref(x, w, None, dy), 50, 5)
        t_l = _time_ms(lambda: torch.autograd.grad(
            y_lib, (xr, wr), dy, retain_graph=True), 100, 10)
        d_k = alone[f"rms_norm_bwd {rows}x{d}"]
        h_k = _host_ms(lambda: rn.rms_norm_bwd(x, w, None, dy), 300)
        # x and dy read, dx written; w read, dw written
        bound = (3 * rows * d + 2 * d) * 4 / HBM_BYTES_PER_S * 1e3
        lines.append(f"rms_norm_bwd {rows}x{d}: kernel {t_k:.6f} ms "
                     f"(device, 2 kernels {d_k:.6f}, host {h_k:.6f}) plain "
                     f"{t_p:.6f} F.rms_norm backward {t_l:.6f} "
                     f"kernel/library {t_k / t_l:.3f} bound {bound:.6f} "
                     f"(bytes; {bound / d_k * 100:.1f}% of it alone)")
        by_shape[f"{rows}x{d}"] = dict(
            ms=t_k, device_ms=d_k, host_ms=h_k, plain_ms=t_p,
            library_ms=t_l, bound_ms=bound)
        check(t_k <= t_l, f"rms_norm_bwd {rows}x{d}: {t_k} ms per call, "
                          f"slower than F.rms_norm's backward {t_l}")
        del x, dy, xr, wr, y_lib
    main["rms_norm_bwd"] = dict(**by_shape["8192x1024"], bound_by="bytes",
                                shape="float32 rows 8192 d 1024",
                                by_shape=by_shape)
    B, H, Hkv, S, D = 8, 16, 8, 1024, 128
    q = torch.randn(B, H, S, D, generator=g, device=dev)
    k, v = (torch.randn(B, Hkv, S, D, generator=g, device=dev)
            for _ in range(2))
    do = torch.randn(B, H, S, D, generator=g, device=dev)
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    t_f = _time_ms(lambda: fa.flash_attention(q, k, v), 30, 3)
    t_fl = _time_ms(lambda: fa.flash_attention(q, k, v, return_lse=True),
                    30, 3)
    # the library call with the row log-sum-exp: memory-efficient attention
    # (no GQA: K and V expanded to the H heads before the timing)
    ke, ve = (t.repeat_interleave(H // Hkv, dim=1) for t in (k, v))
    t_fll = _time_ms(
        lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
            q, ke, ve, None, True, is_causal=True), 30, 3)
    del ke, ve
    t_flp = _time_ms(lambda: (ref.attention_ref(q, k, v),
                              ref.attention_lse_ref(q, k)), 5, 1)
    # the forward's two products in 3xTF32, or its bytes with the lse row
    fl_ops = 3 * 4 * B * H * D * (S * (S + 1) // 2) / TF32_FLOP_PER_S
    fl_bytes = ((2 * B * H * S * D + 2 * B * Hkv * S * D + B * H * S) * 4
                / HBM_BYTES_PER_S)
    t_fl_bound = max(fl_ops, fl_bytes) * 1e3
    fl_by = "operations" if fl_ops >= fl_bytes else "bytes"
    t_k = _time_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do), 10, 2)
    t_p = _time_ms(lambda: ref.attention_bwd_ref(q, k, v, o, lse, do), 5, 1)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True,
                                           enable_gqa=True)
    t_l = _time_ms(lambda: torch.autograd.grad(o_lib, (qr, kr, vr), do,
                                               retain_graph=True), 10, 2)
    d_k = alone["flash_attention_bwd"]
    h_k = _host_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do), 20)
    # five products (S, dP, dV, dK, dQ) over the causal pairs
    flops = 2.5 * 4 * B * H * D * (S * (S + 1) // 2)
    t_ops = 3 * flops / TF32_FLOP_PER_S
    t_fma = flops / F32_FLOP_PER_S
    nbytes = (4 * B * H * S * D + 4 * B * Hkv * S * D + B * H * S) * 4
    bound = max(t_ops, nbytes / HBM_BYTES_PER_S) * 1e3
    # the dS scratch between the dK/dV and dQ kernels (not in the bound:
    # it is the kernel's own traffic, written and read once)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fa.flash_attention_bwd(q, k, v, o, lse, do)
    peak = torch.cuda.max_memory_allocated() - base
    lines.append(f"flash_attention_bwd B{B} H{H}/{Hkv} S{S} D{D} causal: "
                 f"kernel {t_k:.6f} ms (device, 3 kernels {d_k:.6f}, host "
                 f"{h_k:.6f}) plain {t_p:.6f} sdpa backward {t_l:.6f} "
                 f"kernel/library {t_k / t_l:.3f} bound {bound:.6f} "
                 f"(operations, 5 products in 3xTF32; "
                 f"{bound / d_k * 100:.1f}% of it alone) float32-FMA bound "
                 f"{t_fma * 1e3:.6f} ({t_fma * 1e3 / d_k * 100:.1f}% of it "
                 f"alone); bytes allocated by one call {peak} (outputs, "
                 f"row dots and the dS scratch); forward {t_f:.6f} ms, with "
                 f"lse {t_fl:.6f} (bound {t_fl_bound:.6f}, {fl_by}; plain "
                 f"{t_flp:.6f}; efficient attention with lse {t_fll:.6f}, "
                 f"kernel/library {t_fl / t_fll:.3f})")
    main["flash_attention_bwd"] = dict(
        ms=t_k, device_ms=d_k, host_ms=h_k, plain_ms=t_p, library_ms=t_l,
        bound_ms=bound, bound_by="operations", fma_bound_ms=t_fma * 1e3,
        forward_ms=t_f, forward_lse_ms=t_fl,
        forward_lse_bound_ms=t_fl_bound, forward_lse_plain_ms=t_flp,
        forward_lse_library_ms=t_fll,
        call_bytes=peak,
        shape=f"float32 B{B} H{H} Hkv{Hkv} S{S} D{D} causal")
    print("float32 ms per call (CUDA events; device = the kernels' time "
          "from torch.profiler; host = host clock per call, no "
          "synchronise):")
    for line in lines:
        print("  " + line)
    del q, k, v, do, o, lse, qr, kr, vr, o_lib
    new_err, new_main = bwd_variants_vs_plain(g, alone)
    max_err.update(new_err)
    main.update(new_main)
    return max_err, main


def bwd_variants_vs_plain(g, alone):
    """Phase 31's second part: the backward variants of bfloat16 training
    and of head dim 160 against their plain versions (float32 at D 160:
    1e-4 of the largest entry, phase 31's bound; bfloat16 flash:
    ``ATTN_TOL``'s 2e-2 of the largest entry; bfloat16 rms_norm_bwd:
    ``RMS_TOL``'s 2^-7), each twice and bitwise, then their times per
    call, alone (``alone``: the device-time process's) and host, against
    SDPA's (F.rms_norm's) backward in the same dtype, and the bfloat16
    forward with lse beside each bfloat16 row (``_forward_lse_bf16``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn
    dev = torch.device("cuda")
    tol = {torch.float32: BWD_TOL[torch.float32],
           torch.bfloat16: ATTN_TOL[torch.bfloat16][0]}
    err = {name: 0.0 for name in BWD_VARIANTS}
    err["rms_norm_bwd_bf16"] = 0.0
    for dtype, cases in BWD_NEW_CASES.items():
        for case in cases:
            kw = dict(zip(("causal", "window", "q_offset"), case[6:]))
            q, k, v, do = _bwd_inputs(case, dtype, g)
            o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
            got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
            again = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
            want = ref.attention_bwd_ref(q, k, v, o, lse, do, **kw)
            errs = [_rel_err(a, b) for a, b in zip(got, want)]
            abs_err = max(float((a.double() - b.double()).abs().max())
                          for a, b in zip(got, want))
            print(f"  flash_attention_bwd {str(dtype)[6:]} {case}: largest "
                  f"error {max(errs):.3e} of the largest entry (dq, dk, dv "
                  f"{[f'{e:.3e}' for e in errs]}), abs {abs_err:.3e}")
            check(max(errs) <= tol[dtype] and all(
                a.dtype == dtype for a in got),
                f"flash_attention_bwd {dtype} {case}: rel errs {errs} > "
                f"{tol[dtype]}")
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"flash_attention_bwd {dtype} {case}: two calls differ")
            for name, (c, dt) in BWD_VARIANTS.items():
                if dt == dtype and c[5] == case[5]:
                    err[name] = max(err[name], abs_err)
            del q, k, v, do, o, lse, got, again, want
    for rows, d in (RMS_BWD_BF16,) + RMS_BWD_SHAPES + (
            (12345, 1024), (20, 128), (77, 1000), (5, 16)):
        x, r, dy = (torch.randn(rows, d, generator=g, device=dev,
                                dtype=torch.bfloat16) for _ in range(3))
        w = torch.randn(d, generator=g, device=dev, dtype=torch.bfloat16)
        for res in (None, r):
            dx, dw = rn.rms_norm_bwd(x, w, res, dy)
            dx2, dw2 = rn.rms_norm_bwd(x, w, res, dy)
            wdx, wdw, _ = ref.rms_norm_bwd_ref(x, w, res, dy)
            e = max(_rel_err(dx, wdx), _rel_err(dw, wdw))
            print(f"  rms_norm_bwd bfloat16 {rows}x{d} residual="
                  f"{res is not None}: largest error {e:.3e} of the largest "
                  f"entry")
            check(e <= RMS_TOL[torch.bfloat16][0] and
                  dx.dtype == dw.dtype == torch.bfloat16,
                  f"rms_norm_bwd bfloat16 {rows}x{d} residual="
                  f"{res is not None}: rel err {e}")
            check(torch.equal(dx, dx2) and torch.equal(dw, dw2),
                  f"rms_norm_bwd bfloat16 {rows}x{d}: two calls differ")
            if (rows, d) == RMS_BWD_BF16:
                err["rms_norm_bwd_bf16"] = max(
                    err["rms_norm_bwd_bf16"],
                    float((dx.double() - wdx.double()).abs().max()))
        del x, r, dy
    torch.cuda.synchronize()

    lines, main = [], {}
    for name, (case, dtype) in BWD_VARIANTS.items():
        B, H, Hkv, S, _, D, causal = case[:7]
        q, k, v, do = _bwd_inputs(case, dtype, g)
        o, lse = fa.flash_attention(q, k, v, return_lse=True, causal=causal)
        t_k = _time_ms(lambda: fa.flash_attention_bwd(
            q, k, v, o, lse, do, causal=causal), 10, 2)
        t_p = _time_ms(lambda: ref.attention_bwd_ref(
            q, k, v, o, lse, do, causal=causal), 3, 1)
        qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
        o_lib = F.scaled_dot_product_attention(qr, kr, vr, is_causal=causal,
                                               enable_gqa=True)
        t_l = _time_ms(lambda: torch.autograd.grad(
            o_lib, (qr, kr, vr), do, retain_graph=True), 10, 2)
        h_k = _host_ms(lambda: fa.flash_attention_bwd(
            q, k, v, o, lse, do, causal=causal), 10)
        d_k = alone[name]
        pairs = S * (S + 1) // 2 if causal else S * S
        flops = 2.5 * 4 * B * H * D * pairs      # five products
        # float32: 3xTF32 on the tensor cores, as the D <= 128 row; bfloat16:
        # the tensor cores' bfloat16 rate
        t_ops = (3 * flops / TF32_FLOP_PER_S if dtype == torch.float32
                 else flops / BF16_FLOP_PER_S)
        size = q.element_size()
        nbytes = ((4 * B * H * S * D + 4 * B * Hkv * S * D) * size
                  + B * H * S * 4)
        t_bytes = nbytes / HBM_BYTES_PER_S
        bound = max(t_ops, t_bytes) * 1e3
        by = "operations" if t_ops >= t_bytes else "bytes"
        if dtype == torch.float32:
            # the design's own work: five products at the CUDA cores' FMA
            # rate
            own = flops / F32_FLOP_PER_S * 1e3
            extra = (f"float32-FMA bound {own:.6f} ({own / d_k * 100:.1f}% "
                     f"of it alone)")
            extra_row = dict(float32_FMA_bound_ms=own)
        else:
            # what one call allocates: the outputs, the row dots and the
            # bfloat16 dS scratch of the live tiles
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
            peak = torch.cuda.max_memory_allocated() - base
            extra = (f"bytes allocated by one call {peak} (outputs, row "
                     f"dots and the dS scratch)")
            extra_row = dict(call_bytes=peak)
        lines.append(f"{name} {str(dtype)[6:]} B{B} H{H}/{Hkv} S{S} D{D} "
                     f"{'causal' if causal else 'full'}: kernel {t_k:.6f} "
                     f"ms (device, 3 kernels {d_k:.6f}, host {h_k:.6f}) "
                     f"plain {t_p:.6f} sdpa backward {t_l:.6f} "
                     f"kernel/library {t_k / t_l:.3f} bound {bound:.6f} "
                     f"({by}; {bound / d_k * 100:.2f}% of it alone) {extra}")
        main[name] = dict(
            ms=t_k, device_ms=d_k, host_ms=h_k, plain_ms=t_p, library_ms=t_l,
            bound_ms=bound, bound_by=by, **extra_row,
            shape=f"{str(dtype)[6:]} B{B} H{H} Hkv{Hkv} S{S} D{D} "
                  f"{'causal' if causal else 'full'}")
        del qr, kr, vr, o_lib
        if dtype == torch.bfloat16:
            fwd = _forward_lse_bf16(q, k, v, causal,
                                    alone[name + " forward_lse"])
            main[name].update(fwd)
            share = fwd["forward_lse_bound_ms"] / fwd["forward_lse_device_ms"]
            lines.append(
                f"  its forward with lse: kernel {fwd['forward_lse_ms']:.6f} "
                f"ms (device {fwd['forward_lse_device_ms']:.6f}, host "
                f"{fwd['forward_lse_host_ms']:.6f}) plain "
                f"{fwd['forward_lse_plain_ms']:.6f} SDPA flash forward with "
                f"lse {fwd['forward_lse_library_ms']:.6f} kernel/library "
                f"{fwd['forward_lse_ms'] / fwd['forward_lse_library_ms']:.3f}"
                f" bound {fwd['forward_lse_bound_ms']:.6f} (operations at "
                f"the bfloat16 rate; {share * 100:.2f}% of it alone)")
        del q, k, v, do, o, lse
    rows, d = RMS_BWD_BF16
    x, dy = (torch.randn(rows, d, generator=g, device=dev,
                         dtype=torch.bfloat16) for _ in range(2))
    w = torch.randn(d, generator=g, device=dev, dtype=torch.bfloat16)
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    y_lib = F.rms_norm(xr, (d,), wr, 1e-6)
    t_k = _time_ms(lambda: rn.rms_norm_bwd(x, w, None, dy), 100, 10)
    t_p = _time_ms(lambda: ref.rms_norm_bwd_ref(x, w, None, dy), 20, 2)
    t_l = _time_ms(lambda: torch.autograd.grad(
        y_lib, (xr, wr), dy, retain_graph=True), 100, 10)
    h_k = _host_ms(lambda: rn.rms_norm_bwd(x, w, None, dy), 300)
    d_k = alone["rms_norm_bwd_bf16"]
    # x and dy read, dx written; w read, dw written (bfloat16)
    bound = (3 * rows * d + 2 * d) * 2 / HBM_BYTES_PER_S * 1e3
    lines.append(f"rms_norm_bwd_bf16 {rows}x{d}: kernel {t_k:.6f} ms "
                 f"(device, 2 kernels {d_k:.6f}, host {h_k:.6f}) plain "
                 f"{t_p:.6f} F.rms_norm backward {t_l:.6f} kernel/library "
                 f"{t_k / t_l:.3f} bound {bound:.6f} (bytes; "
                 f"{bound / d_k * 100:.1f}% of it alone)")
    main["rms_norm_bwd_bf16"] = dict(
        ms=t_k, device_ms=d_k, host_ms=h_k, plain_ms=t_p, library_ms=t_l,
        bound_ms=bound, bound_by="bytes", shape=f"bfloat16 rows {rows} d {d}")
    print("bfloat16 and D 160 variants, ms per call (CUDA events; device = "
          "the kernels' time alone, from torch.profiler; host = host clock "
          "per call, no synchronise):")
    for line in lines:
        print("  " + line)
    return err, main


def _forward_lse_bf16(q, k, v, causal, alone_ms):
    """The bfloat16 forward with the row log-sum-exp, as the bfloat16
    training steps call it: per call, alone (``alone_ms``, the device-time
    process's), host, plain, and SDPA's flash forward with lse (K and V
    expanded to the query heads before the timing); bound: its two
    products over the causal (or all) pairs at the bfloat16 rate."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    t_k = _time_ms(lambda: fa.flash_attention(q, k, v, causal=causal,
                                              return_lse=True), 10, 2)
    h_k = _host_ms(lambda: fa.flash_attention(q, k, v, causal=causal,
                                              return_lse=True), 10)
    t_p = _time_ms(lambda: (ref.attention_ref(q, k, v, causal=causal),
                            ref.attention_lse_ref(q, k, causal=causal)), 3, 1)
    ke, ve = (t.repeat_interleave(H // Hkv, dim=1) for t in (k, v))
    t_l = _time_ms(lambda: torch.ops.aten._scaled_dot_product_flash_attention(
        q, ke, ve, 0.0, causal), 10, 2)
    del ke, ve
    pairs = S * (S + 1) // 2 if causal else S * S
    bound = 4 * B * H * D * pairs / BF16_FLOP_PER_S * 1e3
    return dict(forward_lse_ms=t_k, forward_lse_device_ms=alone_ms,
                forward_lse_host_ms=h_k, forward_lse_plain_ms=t_p,
                forward_lse_library_ms=t_l, forward_lse_bound_ms=bound)


def _train_argv(*extra):
    return ["--arch", "qwen3-0.6b", "--global-batch", str(TRAIN_BATCH),
            "--seq-len", str(TRAIN_SEQ), "--steps", "3", "--device", "cuda",
            *extra]


def lm_train_main_path():
    """Phase 32: the training CLI at full width, discrete then node, in a
    process of its own (see ``LM_TRAIN_CHILD``); returns its counts."""
    phase(f"32 LM train (main path): qwen3-0.6b full width, batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}, float32")
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           LM_TRAIN_CHILD], capture_output=True, text=True,
                          timeout=600)
    lines = proc.stdout.rstrip("\n").splitlines()
    print("\n".join(lines[:-1]))
    check(proc.returncode == 0 and lines,
          f"phase 32 process failed (rc {proc.returncode}):\n"
          f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return json.loads(lines[-1])


def _lm_train_child():
    """Phase 32's process: 3 discrete and 3 node-symplectic steps through
    ``launch.train.main``, each kernel's counter zeroed just before each run
    and read just after, one more step of each under the profiler; prints
    the counts as its last line."""
    from repro_torch.data.tokens import synthetic_lm_batch
    from repro_torch.launch import train
    from repro_torch.train import TrainConfig, loss_and_grads, \
        make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for mode, extra in (("discrete", ()),
                        ("node_symplectic", ("--grad-mode", "symplectic",
                                             "--node-method", "euler"))):
        torch.cuda.synchronize()
        _zero_all_counts()
        t = time.perf_counter()
        res = train.main(_train_argv(*extra))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = _all_counts()
        rows = res["rows"]
        losses = [r["loss"] for r in rows]
        check(all(math.isfinite(x) for x in losses), f"{mode}: loss {losses}")
        per_step = {k: v / len(rows) for k, v in counts.items()}
        print(f"{mode}: s/step {[round(x, 4) for x in res['step_seconds']]} "
              f"(run {wall:.2f} s incl. set-up), losses {losses}, "
              f"grad_norm {[r['grad_norm'] for r in rows]}")
        print(f"{mode}: launches per step {per_step}")
        need = ["rms_norm", "flash_attention", "rms_norm_bwd",
                "flash_attention_bwd"] + (["butcher_combine"]
                                          if mode != "discrete" else [])
        for name in need:
            check(counts[name] > 0, f"{mode}: {name} never launched")
        # one more step under the profiler, on the run's final state
        arch, state = res["arch"], res["state"]
        b = synthetic_lm_batch(99, TRAIN_BATCH, TRAIN_SEQ + 1, arch.vocab)
        batch = {k: torch.as_tensor(v, dtype=torch.long, device="cuda")
                 for k, v in b.items()}
        step = make_train_step(arch, TrainConfig())
        _profile_once(f"{mode} step:", lambda: step(state, batch))
        if mode != "discrete":
            _, syncs, _ = _counted(lambda: loss_and_grads(
                state.params, batch, arch))
            print(f"{mode}: CUDA synchronisations in one loss+gradient "
                  f"{syncs} (the unit index read per field evaluation: "
                  f"{arch.n_repeats} forward + {arch.n_repeats} backward "
                  f"expected, plus the loop's own)")
        out[mode] = {"counts": counts, "steps": len(rows),
                     "step_seconds": res["step_seconds"], "losses": losses,
                     "rows": rows}
        del res, state, step
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def _leaf_errs(got, want):
    from torch.utils import _pytree as pytree
    mx, fro = 0.0, 0.0
    for a, b in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        mx = max(mx, _rel_err(a, b))
        fro = max(fro, float((a - b).norm() / b.norm().clamp_min(1e-300)))
    return mx, fro


def lm_exactness():
    """Phase 33: float64 at full width and depth, batch 1 x seq 128."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import NodeConfig
    from repro_torch.data.tokens import synthetic_lm_batch
    from repro_torch.models.lm import init_lm, node_depth_units
    from repro_torch.train import loss_and_grads
    phase("33 LM exactness (float64, 28 layers, full width, batch 1 x 128)")
    base = get_arch("qwen3-0.6b")
    params = init_lm(base, seed=0, device="cuda", dtype=torch.float64)
    b = synthetic_lm_batch(0, 1, 129, base.vocab)
    batch = {k: torch.as_tensor(v, dtype=torch.long, device="cuda")
             for k, v in b.items()}
    node = base.with_(node=NodeConfig(mode="node", method="euler",
                                      grad_mode="symplectic"))
    units = node_depth_units(node, torch.float64, device="cuda")
    check(units == list(range(base.n_repeats)), f"unit sequence {units}")
    print(f"unit sequence (float64 time, euler, 28 steps): {units}")
    sym = loss_and_grads(params, batch, node)
    bp = loss_and_grads(params, batch, node.with_(node=NodeConfig(
        mode="node", method="euler", grad_mode="backprop")))
    mx, fro = _leaf_errs(sym[1], bp[1])
    lerr = abs(float(sym[0]) - float(bp[0])) / abs(float(bp[0]))
    print(f"node symplectic vs DirectBackprop: loss rel err {lerr:.3e}, "
          f"max per-leaf rel err {mx:.3e} (rtol 1e-9), per-leaf "
          f"norm rel err {fro:.3e}")
    check(mx <= 1e-9 and lerr <= 1e-9,
          f"symplectic vs backprop: {mx}, loss {lerr}")
    del bp
    torch.cuda.empty_cache()
    disc = loss_and_grads(params, batch, base)
    mx, fro = _leaf_errs(sym[1], disc[1])
    lerr = abs(float(sym[0]) - float(disc[0])) / abs(float(disc[0]))
    print(f"node (euler, 28 steps) vs discrete stack: loss "
          f"{float(sym[0])!r} vs {float(disc[0])!r} (rel err "
          f"{lerr:.3e}, rtol 1e-8), per-leaf norm rel err {fro:.3e} "
          f"(rtol 1e-8), max per-leaf rel err {mx:.3e}")
    check(lerr <= 1e-8 and fro <= 1e-8,
          f"node vs discrete: loss {lerr}, grads {fro}")
    del params, sym, disc
    torch.cuda.empty_cache()


def lm_memory():
    """Phase 34: peak bytes of one float32 loss+gradient at full width."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import NodeConfig
    from repro_torch.data.tokens import synthetic_lm_batch
    from repro_torch.models.lm import init_lm
    from repro_torch.train import loss_and_grads
    phase(f"34 LM memory (float32, one loss+gradient, batch {TRAIN_BATCH} "
          f"x {TRAIN_SEQ})")
    base = get_arch("qwen3-0.6b")
    params = init_lm(base, seed=0, device="cuda")
    b = synthetic_lm_batch(1, TRAIN_BATCH, TRAIN_SEQ + 1, base.vocab)
    batch = {k: torch.as_tensor(v, dtype=torch.long, device="cuda")
             for k, v in b.items()}
    peaks = {}
    for chunk in (512, 64):
        for name, arch in (
                ("discrete_no_remat", base.with_(remat=False)),
                ("discrete_remat", base),
                ("node_symplectic", base.with_(node=NodeConfig(
                    mode="node", grad_mode="symplectic")))):
            peaks[name if chunk == 512 else f"{name}_chunk{chunk}"] = \
                _peak_bytes(lambda: loss_and_grads(params, batch, arch,
                                                   loss_chunk=chunk))
    grad_bytes = sum(p.numel() * 4 for p in
                     __import__("torch.utils._pytree", fromlist=["x"])
                     .tree_leaves(params))
    print(f"peak bytes above the params: {peaks} (the gradient tree alone "
          f"is {grad_bytes}; at the trainer's loss chunk 512 the head's "
          f"(8, 512, 151936) logits block and its backward can set the "
          f"peak of both remat and symplectic: the chunk-64 runs show the "
          f"depth part)")
    sym64, remat64 = (peaks["node_symplectic_chunk64"],
                      peaks["discrete_remat_chunk64"])
    print(f"chunk 64: node_symplectic {sym64} B beside discrete_remat "
          f"{remat64} B (ratio {sym64 / remat64:.3f}; without remat "
          f"{peaks['discrete_no_remat_chunk64']} B)")
    for sfx in ("", "_chunk64"):
        sym, bp = peaks[f"node_symplectic{sfx}"], \
            peaks[f"discrete_no_remat{sfx}"]
        check(sym < bp, f"symplectic peak{sfx} {sym} not below backprop "
                        f"{bp}")
    # no zero cotangents for untouched units: the growing gradient, the 28
    # step checkpoints and one unit's graph (4569973248 B on the H100)
    check(sym64 <= NODE_PEAK_CHUNK64,
          f"node_symplectic chunk-64 peak {sym64} above {NODE_PEAK_CHUNK64}")
    del params
    torch.cuda.empty_cache()
    return peaks


def _resume_cmd(metrics, *extra):
    return [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "qwen3-0.6b", "--global-batch", str(RESUME["batch"]),
            "--seq-len", str(RESUME["seq"]), "--steps",
            str(RESUME["steps"]), "--ckpt-every", "2", "--metrics-out",
            str(metrics), "--device", "cuda", "--layers",
            str(RESUME["layers"]), *extra]


def _metric_lines(path):
    with open(path) as f:
        return {json.loads(line)["step"]: line.rstrip("\n")
                for line in f if line.strip()}


def lm_resume():
    """Phase 35: uninterrupted vs killed-and-resumed, three processes."""
    import shutil
    phase(f"35 resume on the card (full width, {RESUME['layers']} of 28 "
          f"layers, float32, batch {RESUME['batch']} x {RESUME['seq']}, "
          f"{RESUME['steps']} steps)")
    work = ROOT / "runs" / "chip_smoke_resume"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    ckpt = work / "ckpt"
    t = time.perf_counter()
    golden = work / "golden.jsonl"
    # the uninterrupted run and the one to be killed share the card (each
    # process's kernels are deterministic whatever runs beside it)
    p1 = subprocess.Popen(_resume_cmd(golden), env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    victim = work / "victim.jsonl"
    p2 = subprocess.Popen(_resume_cmd(victim, "--ckpt-dir", str(ckpt),
                                      "--step-delay-s", "2"), env=env,
                          stdout=subprocess.DEVNULL,
                          stderr=subprocess.DEVNULL)
    t0 = time.time()
    published = ckpt / "step_2" / "MANIFEST.json"
    while not published.exists() and p2.poll() is None and \
            time.time() - t0 < 400:
        time.sleep(0.05)
    p2.kill()
    p2.wait()
    out1, _ = p1.communicate(timeout=400)
    check(p1.returncode == 0, f"uninterrupted run failed:\n{out1}")
    check(published.exists(), "the second process published no step-2 "
                              "checkpoint")
    resumed = work / "resumed.jsonl"
    proc = subprocess.run(_resume_cmd(resumed, "--ckpt-dir", str(ckpt),
                                      "--resume"), env=env,
                          capture_output=True, text=True, timeout=400)
    check(proc.returncode == 0 and "resumed from step 2" in proc.stdout,
          f"resume failed:\n{proc.stdout}\n{proc.stderr}")
    want, got = _metric_lines(golden), _metric_lines(resumed)
    check(sorted(got) == [2, 3], f"resumed steps {sorted(got)}")
    for step in got:
        check(got[step] == want[step],
              f"step {step}: resumed {got[step]} != uninterrupted "
              f"{want[step]}")
    print(f"resumed steps {sorted(got)} bitwise equal to the uninterrupted "
          f"run ({time.perf_counter() - t:.1f} s, three processes):")
    for step in sorted(got):
        print(f"  {got[step]}")
    return ckpt


def lm_train_to_serve(ckpt):
    """Phase 36: the serve CLI boots from phase 35's checkpoint."""
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import synthetic_lm_batch
    from repro_torch.launch import serve
    from repro_torch.runtime import Checkpointer
    from repro_torch.train import TrainConfig, init_train_state, \
        make_prefill_step
    phase("36 train -> serve (launch.serve lm --ckpt-dir)")
    out = serve.main(["lm", "--arch", "qwen3-0.6b", "--ckpt-dir", str(ckpt),
                      "--batch", "2", "--prompt-len", "64", "--gen-len", "4",
                      "--device", "cuda", "--layers", str(RESUME["layers"])])
    check(out["logits_finite"], "serve from checkpoint: non-finite logits")
    arch = get_arch("qwen3-0.6b").with_(n_layers=RESUME["layers"])
    like = init_train_state(arch, TrainConfig(), seed=1, device="cuda")
    state, step = Checkpointer(str(ckpt)).restore(like)
    toks = torch.as_tensor(synthetic_lm_batch(0, 2, 65, arch.vocab)[
        "tokens"], dtype=torch.long, device="cuda")
    want, _ = make_prefill_step(arch, 2, 68)(state.params, {"tokens": toks})
    check(torch.equal(out["prefill_logits"], want),
          "serve from checkpoint: logits differ from the checkpoint's "
          "params")
    print(f"serve booted from step {step}: prefill logits bitwise equal to "
          f"the checkpoint params' ({tuple(want.shape)}); tokens "
          f"{out['tokens'][0].tolist()}")
    del state, like
    torch.cuda.empty_cache()
    # the checkpoints hold ~7 GB each: leave no disk behind
    import shutil
    shutil.rmtree(pathlib.Path(ckpt).parent, ignore_errors=True)


# ---------------------------------------------------------------------------
# the mesh: phases 37-40, each in a process of its own (``MESH_CHILD``), so
# that no process group touches the earlier phases
# ---------------------------------------------------------------------------

MESH_CNF_B = 256                 # phase 14's lanes
MESH_GLOO_B = 256                # phase 38: 128 lanes on each of 2 ranks


def _free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _world(backend, world=1, rank=0, port=None):
    """Join a process group on localhost and make the lane mesh over it."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_lane_mesh
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port or _free_port()}",
        world_size=world, rank=rank)
    torch.cuda.set_device(0)
    return make_lane_mesh((world,), device_type="cuda")


_CHILDREN = []                   # started by _child_start, not yet joined


def _descendants(pid):
    """The processes below ``pid`` (its rank processes), from /proc."""
    out = []
    try:
        for task in os.listdir(f"/proc/{pid}/task"):
            with open(f"/proc/{pid}/task/{task}/children") as f:
                out += [int(c) for c in f.read().split()]
    except OSError:
        return []
    return out + [d for c in out for d in _descendants(c)]


def _kill_children():
    """At exit (a failed check included): kill every child not joined,
    with the processes it started."""
    import signal
    for proc in _CHILDREN:
        if proc.poll() is None:
            for pid in [*_descendants(proc.pid), proc.pid]:
                try:
                    os.kill(pid, signal.SIGKILL)
                except OSError:
                    pass
            proc.wait()


#: set for a child started ahead of its phase: the file it waits for
GO_ENV = "CHIP_SMOKE_GO"


def _child_start(argv, timeout=600, go=None):
    """Start ``chip_smoke.py argv`` in its own process, its output to
    temporary files; ``_child_finish`` joins it.  With ``go`` (a path) the
    child imports torch and then waits for that file (``_child_go``)
    before it touches the card, so its start-up overlaps the phases before
    its own."""
    import atexit
    import tempfile
    if not _CHILDREN:
        atexit.register(_kill_children)
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    env = dict(os.environ)
    if go is not None:
        env[GO_ENV] = go
    proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                             *argv], stdout=out, stderr=err, text=True,
                            env=env)
    _CHILDREN.append(proc)
    return proc, out, err, time.perf_counter() + timeout


def _child_finish(child, which):
    """Wait for a ``_child_start`` child (phase ``which``) until its
    deadline; returns its last line's JSON (the lines before it are
    printed)."""
    proc, out, err, deadline = child
    try:
        proc.wait(timeout=max(deadline - time.perf_counter(), 0))
    except subprocess.TimeoutExpired:
        fail(f"phase {which} process still running at its time limit")
    _CHILDREN.remove(proc)
    out.seek(0)
    err.seek(0)
    stdout, stderr = out.read(), err.read()
    lines = stdout.rstrip("\n").splitlines()
    print("\n".join(lines[:-1]), flush=True)
    check(proc.returncode == 0 and lines,
          f"phase {which} process failed (rc {proc.returncode}):\n"
          f"{stdout[-4000:]}\n{stderr[-4000:]}")
    return json.loads(lines[-1])


def _child_go(child, go, which):
    """Let a child started with ``go`` run its phase, and join it."""
    _publish(go, lambda tmp: open(tmp, "w").close())
    return _child_finish(child, which)


def _child_phase(argv, which, timeout=600):
    """Run ``chip_smoke.py argv`` (phase ``which``) in its own process;
    returns its last line's JSON (the lines before it are printed)."""
    torch.cuda.empty_cache()
    return _child_finish(_child_start(argv, timeout), which)


def _rank_children(argvs, timeout=900):
    """Start a phase's rank processes (``chip_smoke.py argv`` each) before
    its single-process reference runs, so their start-up (~8 s each, in
    parallel) overlaps it: each joins its process group and waits for the
    reference's file (``_await_file``) before it touches the card."""
    return [_child_start(a, timeout) for a in argvs]


def _rank_results(children, which):
    """Each rank child's last line as JSON (``_child_finish``), rank 0
    first."""
    return [_child_finish(c, f"{which} rank {r}")
            for r, c in enumerate(children)]


def _publish(path, save):
    """``save(tmp)`` then a rename to ``path``: a rank waiting for ``path``
    never reads it half written."""
    save(path + ".tmp")
    os.replace(path + ".tmp", path)


def _await_file(path, timeout=900):
    """Block until ``path`` exists (the single-process reference's results,
    published by ``_publish``)."""
    deadline = time.perf_counter() + timeout
    while not os.path.exists(path):
        check(time.perf_counter() < deadline, f"{path} never appeared")
        time.sleep(0.1)


def _mesh_phase(which, *args, timeout=600):
    return _child_phase([MESH_CHILD, str(which), *args], which, timeout)


def _cnf_lanes(B, dtype):
    """Phase 14's per-sample CNF solve problem at B lanes: the field, the
    first component's weights, the lane state (u, 0, eps) and the
    controller (rtol 1e-4, atol 1e-6, max_steps 48)."""
    from repro_torch.core import AdaptiveConfig
    from repro_torch.models.cnf import cnf_field, component
    cfg, params, u, eps = _per_sample_inputs(B, dtype)
    # per-sample lanes hold a singleton batch (models/per_sample.py)
    state = (u[:, None], torch.zeros((B, 1), dtype=dtype, device=u.device),
             eps[:, None])
    acfg = AdaptiveConfig(rtol=cfg.rtol, atol=cfg.atol,
                          max_steps=cfg.max_steps)
    return cfg, cnf_field(cfg), component(params, 0), state, acfg


def _cnf_lane_run(cfg, field, p0, state, B, mesh=None, **kw):
    """One loss+gradient of the per-sample solve through ``solve``: the
    nll of the solve's final (z, dlp) summed over this rank's lanes and
    divided by the global lane count B (so the ranks' losses sum to the
    full batch's).  Returns (loss, ys, stats, success, grads, forward
    collectives, backward collectives), ys/stats/success as this rank's
    blocks."""
    from torch.distributed.tensor import DTensor
    from torch.utils import _pytree as pytree
    from repro_torch.core import solve
    from repro_torch.parallel import comm
    leaves, spec = pytree.tree_flatten(p0)
    live = [l.detach().clone().requires_grad_() for l in leaves]

    def own(x):
        return x.to_local() if isinstance(x, DTensor) else x

    comm.reset_counts()
    sol = solve(field, state, pytree.tree_unflatten(live, spec),
                batch_axis=0, mesh=mesh, **kw)
    fwd = comm.counts()
    ys = pytree.tree_map(own, sol.ys)
    z, dlp, _ = pytree.tree_map(lambda l: l[-1], ys) \
        if "saveat" in kw and kw["saveat"].kind == "ts" else ys
    z, dlp = z[:, 0], dlp[:, 0]
    logpz = -0.5 * torch.sum(z ** 2, -1) - 0.5 * cfg.dim * math.log(
        2 * math.pi)
    loss = -torch.sum(logpz - dlp) / B
    grads = torch.autograd.grad(loss, live)
    return (loss.detach(), pytree.tree_map(lambda l: l.detach(), ys),
            {k: own(sol.stats[k]) for k in ("n_steps", "n_fevals",
                                             "n_attempts")},
            own(sol.success), grads, fwd, comm.counts())


def _mesh_cells(acfg):
    from repro_torch.core import ContinuousAdjoint, SaveAt, SymplecticAdjoint
    ts = SaveAt(ts=[0.5, 1.0])
    for gname, grad in (("symplectic", SymplecticAdjoint()),
                        ("adjoint", ContinuousAdjoint())):
        for sname, stepping in (("adaptive", acfg), ("fixed", 8)):
            for oname, saveat in (("t1", None), ("ts", ts)):
                kw = {"gradient": grad, "stepping": stepping}
                if saveat is not None:
                    kw["saveat"] = saveat
                yield f"{gname}/{sname}/{oname}", kw


def _mesh_solve_child():
    """Phase 37's process: a world of 1 over NCCL."""
    from torch.utils import _pytree as pytree
    mesh = _world("nccl")
    B = MESH_CNF_B
    cfg, field, p0, state, acfg = _cnf_lanes(B, torch.float32)
    n_leaves = len(pytree.tree_leaves(p0))
    out = {}
    for name, kw in _mesh_cells(acfg):
        plain = _cnf_lane_run(cfg, field, p0, state, B, **kw)
        if name == "symplectic/adaptive/t1":
            torch.cuda.synchronize()
            _zero_all_counts()
        meshed = _cnf_lane_run(cfg, field, p0, state, B, mesh=mesh, **kw)
        if name == "symplectic/adaptive/t1":
            torch.cuda.synchronize()
            out["launches"] = _all_counts()
        loss, ys, stats, ok, grads, fwd, bwd = meshed
        same = (torch.equal(loss, plain[0])
                and all(torch.equal(a, b) for a, b in zip(
                    pytree.tree_leaves(ys), pytree.tree_leaves(plain[1])))
                and all(torch.equal(stats[k], plain[2][k]) for k in stats)
                and torch.equal(ok, plain[3])
                and all(torch.equal(a, b) for a, b in zip(grads, plain[4])))
        check(same, f"phase 37 {name}: solve(mesh=) differs from solve()")
        check(fwd == {} and bwd == {"all_reduce": n_leaves},
              f"phase 37 {name}: collectives forward {fwd} backward {bwd} "
              f"(want none, then {n_leaves} all_reduce)")
        print(f"  {name}: bitwise equal to solve() (loss {float(loss):.6f}, "
              f"accepted steps max {int(stats['n_steps'].max())}); "
              f"collectives forward {fwd}, backward {bwd}")
    kw = {"gradient": "symplectic", "stepping": acfg}
    for label, m in (("solve()", None), ("solve(mesh=)", mesh)):
        def run():
            return _cnf_lane_run(cfg, field, p0, state, B, mesh=m, **kw)
        peak = _peak_bytes(run)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        out[label] = {"peak_bytes": peak, "ms": sorted(times)[1]}
        print(f"  one loss+gradient (symplectic, adaptive, t1, B {B}): "
              f"{label} peak {peak} B, {sorted(times)[1]:.3f} ms (median "
              f"of 3: {[round(x, 3) for x in times]})")
    print(json.dumps(out), flush=True)


def mesh_solve_phase():
    phase(f"37 mesh solve, world of 1 over NCCL: per-sample MiniBooNE CNF, "
          f"{MESH_CNF_B} lanes, dopri5, symplectic and continuous adjoint, "
          f"fixed and adaptive, t1 and SaveAt(ts); float32")
    return _mesh_phase(37)


def _mesh_gloo_rank(rank, port):
    """Phase 38's rank: half of the lanes of a world of 2 over gloo, both
    ranks on the one card (CUDA tensors through gloo's collectives)."""
    from repro_torch.core import SymplecticAdjoint
    from repro_torch.parallel import gather
    mesh = _world("gloo", world=2, rank=rank, port=port)
    B, per = MESH_GLOO_B, MESH_GLOO_B // 2
    cfg, field, p0, state, acfg = _cnf_lanes(B, torch.float64)
    block = tuple(l[rank * per:(rank + 1) * per] for l in state)
    out = {}
    for name, stepping in (("adaptive", acfg), ("fixed", 8)):
        kw = {"gradient": SymplecticAdjoint(), "stepping": stepping}
        full = _cnf_lane_run(cfg, field, p0, state, B, **kw)
        alone = _cnf_lane_run(cfg, field, p0, block, B, **kw)
        torch.cuda.synchronize()
        _zero_combine_counts()
        meshed = _cnf_lane_run(cfg, field, p0, state, B, mesh=mesh, **kw)
        torch.cuda.synchronize()
        launches = _combine_counts()
        _, ys, stats, ok, grads, fwd, bwd = meshed
        check(all(torch.equal(a, b) for a, b in zip(ys, alone[1]))
              and all(torch.equal(stats[k], alone[2][k]) for k in stats),
              f"phase 38 rank {rank} {name}: the block differs from the "
              f"single-process solve of that block")
        for k in stats:
            whole = gather(_lanes_dtensor(stats[k], mesh))
            check(torch.equal(whole, full[2][k]),
                  f"phase 38 rank {rank} {name}: {k} differs from the "
                  f"full-width solve")
        err = max(_rel_err(a, b) for a, b in zip(grads, full[4]))
        check(err <= 1e-12, f"phase 38 rank {rank} {name}: gradient rel "
                            f"err {err:.3e} > 1e-12")
        check(fwd == {} and bwd == {"all_reduce": len(grads)},
              f"phase 38 rank {rank} {name}: collectives {fwd} / {bwd}")
        print(f"  rank {rank} {name}: block bitwise the single-process "
              f"solve of lanes [{rank * per}, {(rank + 1) * per}); stats "
              f"equal the full width's; gradient rel err {err:.3e}; "
              f"collectives backward {bwd}; launches butcher_combine "
              f"{launches[0]} butcher_combine_rows {launches[1]}",
              flush=True)
        out[name] = {"launches": launches, "grad_rel_err": err}
    import torch.distributed as dist
    dist.destroy_process_group()
    print(json.dumps(out), flush=True)


def _lanes_dtensor(local, mesh):
    from repro_torch.parallel.layout import from_local, lane_spec
    return from_local(local, mesh, lane_spec(mesh, ("data",)))


def _mesh_gloo_child():
    """Phase 38's process: starts the 2 ranks and collects them."""
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                               MESH_CHILD, "38", str(r), port],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=500))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    res = {}
    for r, (p, (o, e)) in enumerate(zip(procs, outs)):
        lines = o.rstrip("\n").splitlines()
        print("\n".join(lines[:-1]), flush=True)
        check(p.returncode == 0 and lines,
              f"phase 38 rank {r} failed (rc {p.returncode}):\n{o[-3000:]}"
              f"\n{e[-3000:]}")
        res[f"rank{r}"] = json.loads(lines[-1])
    print(json.dumps(res), flush=True)


MESH_GLOO_TITLE = (f"38 mesh solve, world of 2 over gloo on the one card: "
                   f"{MESH_GLOO_B // 2} lanes each, float64, symplectic "
                   f"adjoint")


def mesh_gloo_phase():
    phase(MESH_GLOO_TITLE)
    return _mesh_phase(38)


def _mesh_engine_child():
    """Phase 39's process: the ODE server at phase 28's configuration,
    without and with a lane mesh of one rank (NCCL)."""
    from repro_torch.core import get_tableau
    from repro_torch.launch.serve import ode_field
    from repro_torch.parallel import comm
    from repro_torch.serve import EngineConfig, SolveEngine, synthetic_stream
    from torch.distributed.tensor import Shard
    mesh = _world("nccl")
    c = SERVE_ODE
    make_plain, _, cfg, params = _serve_engine(
        c["dim"], c["hidden"], c["max_steps"], c["buckets"])

    def make_mesh():
        return SolveEngine(ode_field, get_tableau("dopri5"), cfg, params,
                           torch.zeros(c["dim"], device="cuda"),
                           EngineConfig(buckets=tuple(c["buckets"]),
                                        mesh=mesh))
    n = c["requests"]
    reqs = synthetic_stream(n, c["dim"], seed=c["seed"],
                            t1_range=c["t1_range"],
                            tol_choices=c["tol_choices"], device="cuda")
    out, results = {}, {}
    for label, make in (("no mesh", make_plain), ("mesh", make_mesh)):
        make().run(reqs)                     # throwaway run
        engine, init_s = _timed_engine(make)
        comm.reset_counts()
        box = {}
        out[label] = _serve_run(
            f"drain ({label})", engine, init_s,
            lambda: box.setdefault("r", engine.run(reqs)), n)
        results[label] = box["r"]
        steps = engine.stats["steps_total"]
        colls = comm.counts()
        out[label]["collectives"] = colls
        print(f"  {label}: collectives {colls} in {steps} engine steps "
              f"({sum(colls.values()) / steps:.3f} per step)")
        if label == "mesh":
            check(steps <= colls.get("all_gather", 0) <= steps + n,
                  f"phase 39: {colls} collectives in {steps} steps and {n} "
                  f"harvests (one per sweep, one more per harvesting sweep)")
            st = engine.resident_state
            check(all(isinstance(p, Shard) and p.dim == 0
                      for p in st.t.placements) and
                  all(isinstance(p, Shard) and p.dim == 1
                      for p in st.ts.placements + st.hs.placements),
                  f"phase 39: resident state placements {st.t.placements} "
                  f"/ {st.ts.placements}")
    for rid, want in results["no mesh"].items():
        check(_same_result(results["mesh"][rid], want, None),
              f"phase 39: request {rid} differs from the no-mesh engine")
    print(f"  mesh: {n} results bitwise the no-mesh engine's; req/s "
          f"{out['mesh']['rps']:.3f} beside {out['no mesh']['rps']:.3f} "
          f"without the mesh; resident state DTensors (t on axis 0, ts/hs "
          f"on axis 1)")
    print(json.dumps(out), flush=True)


def mesh_engine_phase(serve_ode=None):
    c = SERVE_ODE
    phase(f"39 serve ode on a lane mesh (world of 1, NCCL): dim {c['dim']}, "
          f"{c['requests']} requests, buckets {c['buckets']}, float32")
    out = _mesh_phase(39)
    if serve_ode is not None:
        d = serve_ode["drain"]
        print(f"  phase 28's drain in the main process: {d['rps']:.3f} req/s"
              f", {d['syncs'] / d['stats']['steps_total']:.3f} syncs and no "
              f"collective per engine step")
    return out


def _mesh_train_child(want_json):
    """Phase 40's process: 3 discrete steps through ``launch.train.main
    --mesh debug`` (ZeRO-1 over a world of 1, NCCL), with phase 32's
    cuBLAS workspace set before CUDA starts."""
    from repro_torch.launch import train
    from repro_torch.parallel import comm
    from repro_torch.train.data_parallel import step_collectives
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    want = json.loads(want_json) if want_json != "none" else None
    if want is None:          # run alone: phase 32's discrete run first
        plain = train.main(_train_argv())
        want = {"rows": plain["rows"], "step_seconds": plain["step_seconds"]}
        del plain
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_all_counts()
    comm.reset_counts()
    res = train.main(_train_argv("--mesh", "debug"))
    torch.cuda.synchronize()
    counts, colls = _all_counts(), comm.counts()
    peak = torch.cuda.max_memory_allocated()
    rows = res["rows"]
    keys = ("loss", "grad_norm", "lr")
    check([[r[k] for k in keys] for r in rows]
          == [[r[k] for k in keys] for r in want["rows"]],
          f"phase 40: metrics {rows} differ from phase 32's "
          f"{want['rows']}")
    steps = len(rows)
    for name in ("rms_norm", "flash_attention", "rms_norm_bwd",
                 "flash_attention_bwd"):
        check(counts[name] > 0, f"phase 40: {name} never launched")
    from torch.utils import _pytree as pytree
    n_leaves = len(pytree.tree_leaves(res["state"].params))
    grad = sum(colls.get(k, 0) for k in ("reduce_scatter", "reduce"))
    print(f"  ZeRO-1 discrete: metrics bitwise phase 32's ({rows}); s/step "
          f"{[round(x, 4) for x in res['step_seconds']]}; collectives per "
          f"step { {k: v / steps for k, v in colls.items()} } ({n_leaves} "
          f"gradient leaves: {grad / steps:.0f} reduce_scatter/reduce, "
          f"the loss and the norm as all_reduce, the new params gathered); "
          f"peak allocated {peak} B over the run; phase 32's discrete "
          f"s/step {[round(x, 4) for x in want['step_seconds']]}")
    check(grad + colls.get("all_reduce", 0) == steps * (n_leaves + 2),
          f"phase 40: {colls} in {steps} steps of {n_leaves} leaves")
    kinds = _zero1_kinds(res["state"])
    del res
    torch.cuda.empty_cache()
    # microbatches and int8 compression: the meshless run, then the meshed
    # one (ZeRO-1 over a world of 1): bitwise
    extra = ("--microbatches", "2", "--compression", "int8")
    plain = train.main(_train_argv(*extra))
    want_mc, plain_secs = plain["rows"], plain["step_seconds"]
    del plain
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_all_counts()
    comm.reset_counts()
    res = train.main(_train_argv("--mesh", "debug", *extra))
    torch.cuda.synchronize()
    counts_mc, colls_mc = _all_counts(), comm.counts()
    bytes_mc = dict(comm.BYTES)
    peak_mc = torch.cuda.max_memory_allocated()
    rows = res["rows"]
    check([[r[k] for k in keys] for r in rows]
          == [[r[k] for k in keys] for r in want_mc],
          f"phase 40: microbatches 2 + int8 metrics {rows} differ from the "
          f"meshless run's {want_mc}")
    # per step: every leaf reduced whole (compression), the loss and the
    # norm, then ZeRO-1's gathers of the new params
    want_c = step_collectives(res["arch"], _SpecMesh(1, 1), n_leaves,
                              seq_len=TRAIN_SEQ, kinds=kinds,
                              microbatches=2, compression="int8")
    check(colls_mc == {k: v * steps for k, v in want_c.items()},
          f"phase 40: microbatches 2 + int8 collectives {colls_mc}, want "
          f"{want_c} per step")
    print(f"  ZeRO-1 microbatches 2 + int8: metrics bitwise the meshless "
          f"run's ({rows}); s/step "
          f"{[round(x, 4) for x in res['step_seconds']]} (meshless "
          f"{[round(x, 4) for x in plain_secs]}); collectives per "
          f"step { {k: v / steps for k, v in colls_mc.items()} }, bytes per "
          f"step { {k: v / steps for k, v in bytes_mc.items()} }; peak "
          f"allocated {peak_mc} B; launches per step "
          f"{ {k: v / steps for k, v in counts_mc.items()} }")
    print(json.dumps({"counts": counts, "collectives": colls,
                      "step_seconds": res["step_seconds"], "peak": peak,
                      "steps": steps,
                      "mb2_int8": {"counts": counts_mc,
                                   "collectives": colls_mc,
                                   "bytes": bytes_mc, "peak": peak_mc,
                                   "step_seconds": res["step_seconds"],
                                   "meshless_step_seconds": plain_secs,
                                   "rows": rows}}), flush=True)


class _SpecMesh:
    """The spec rules' duck-typed mesh (sizes and names only)."""

    def __init__(self, data, model):
        self.shape = {"data": data, "model": model}
        self.axis_names = ("data", "model")


def _zero1_kinds(state, data=1, model=1):
    """ZeRO-1's kind of each param leaf (split / owned / whole) on a
    (data, model) mesh, from ``parallel.state_specs`` (no process group)."""
    from repro_torch.train.data_parallel import zero1_layout
    return zero1_layout(state, _SpecMesh(data, model))[0]


def mesh_train_phase(train=None, peaks=None):
    phase(f"40 LM train data-parallel (launch.train --mesh debug, ZeRO-1, "
          f"world of 1, NCCL): qwen3-0.6b, batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, float32, 3 discrete steps")
    want = "none" if train is None else json.dumps(
        {k: train["discrete"][k] for k in ("rows", "step_seconds")})
    out = _mesh_phase(40, want)
    if peaks is not None:
        print(f"  peak allocated over the ZeRO-1 run {out['peak']} B (params,"
              f" AdamW state, activations) beside phase 34's one "
              f"loss+gradient above the params: discrete_remat "
              f"{peaks['discrete_remat']} B")
    return out



# ---------------------------------------------------------------------------
# phase 52: tensor parallelism, 2 gloo ranks sharing the card on a
# ("data" 1, "model" 2) mesh
# ---------------------------------------------------------------------------

# relative distance of phase 52's loss and grad_norm from the single-
# process run's: at 28 layers against phase 32 the card's readings were 0
# (loss, every step) and at most 2.505e-7 (grad_norm) in four whole runs;
# 1e-5 is 40x the largest (PERF.md §6).
# Leaving the partial leaves unsummed over "model" moves them by more
# (tools/tp_rounding.py at smoke width with tensor.sum_partial a no-op)
TP_LOSS_RTOL = 1e-5
TP_GNORM_RTOL = 1e-5
TP_KERNELS = ("rms_norm", "flash_attention", "rms_norm_bwd",
              "flash_attention_bwd", "butcher_combine")


TP_LAYERS = 4                    # phase 52's depth cut (whole layers, as --layers)
# phase 52's runs, each from the seed-0 state: (mode, steps)
TP_RUNS = (("discrete", 2), ("node_symplectic", 1))


def _tp_arch(mode):
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import NodeConfig
    arch = get_arch("qwen3-0.6b").with_(n_layers=TP_LAYERS)
    if mode != "discrete":
        arch = arch.with_(node=NodeConfig(mode="node", method="euler",
                                          grad_mode="symplectic"))
    return arch


def _tp_reference():
    """Phase 52's single-process runs, in this process: each mode's steps
    (``TP_RUNS``) from the seed-0 state on the ranks' batches and schedule;
    per mode the metrics, launches and steps, the card's memory given
    back."""
    import gc

    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.optim import cosine_schedule
    from repro_torch.train import TrainConfig, init_train_state, \
        make_train_step
    tcfg = TrainConfig()
    state0 = init_train_state(_tp_arch("discrete"), tcfg, device="cuda")
    out = {}
    for mode, steps in TP_RUNS:
        arch = _tp_arch(mode)
        state = state0
        step = make_train_step(arch, tcfg, lr_fn=cosine_schedule(3e-4, 5, 3))
        pipe = iter(TokenPipeline(TRAIN_BATCH, TRAIN_SEQ, arch.vocab,
                                  device="cuda"))
        torch.cuda.synchronize()
        _zero_all_counts()
        rows, secs = [], []
        for _ in range(steps):
            t = time.perf_counter()
            state, m = step(state, next(pipe))
            rows.append({k: float(m[k]) for k in ("loss", "grad_norm",
                                                  "lr")})
            secs.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        out[mode] = {"rows": rows, "counts": _all_counts(), "steps": steps}
        print(f"  {mode} (one process): {rows}, s/step "
              f"{[round(x, 4) for x in secs]}", flush=True)
        del state, step, m
    del state0
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _tp_rank(rank, port, want_path):
    """Phase 52's rank: qwen3-0.6b at full width, cut to ``TP_LAYERS``
    layers, on its "model" block (8 of 16 heads, 4 of 8 kv heads, 1536 of
    3072 ffn columns, 75968 of 151936 vocab rows; the residual stream's 512
    of 1024 positions), ZeRO-1 over a "data" axis of 1: 2 discrete steps
    (remat) and 1 node-symplectic step, each from the seed-0 state on the
    single-process run's batches and schedule."""
    import gc

    import torch.distributed as dist
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.optim import cosine_schedule
    from repro_torch.parallel import comm, make_sharder, state_specs
    from repro_torch.runtime import reshard_state
    from repro_torch.train import TrainConfig, init_train_state, \
        make_train_step
    from repro_torch.train.data_parallel import Zero1, step_collectives
    from torch.utils import _pytree as pytree
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    torch.cuda.set_device(0)
    mesh = make_debug_mesh(1, 2, device_type="cuda")
    _await_file(want_path)
    with open(want_path) as f:
        want = json.load(f)
    out = {}
    tcfg = TrainConfig()
    # the seed-0 state, laid out once: both modes start from it (a step
    # leaves its input state valid)
    state0 = init_train_state(_tp_arch("discrete"), tcfg, device="cuda")
    kinds = _zero1_kinds(state0, 1, 2)
    n_leaves = len(pytree.tree_leaves(state0.params))
    state0 = reshard_state(state0, mesh, state_specs(state0, mesh))
    gc.collect()
    torch.cuda.empty_cache()
    for mode, steps in TP_RUNS:
        arch = _tp_arch(mode)
        state = state0
        step = make_train_step(arch, tcfg, lr_fn=cosine_schedule(3e-4, 5, 3),
                               shard=make_sharder(mesh),
                               grad_constraint=Zero1(mesh, state))
        pipe = iter(TokenPipeline(TRAIN_BATCH, TRAIN_SEQ, arch.vocab,
                                  device="cuda"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_all_counts()
        rows, secs, colls, nbytes = [], [], [], []
        for _ in range(steps):
            batch = next(pipe)
            comm.reset_counts()
            t = time.perf_counter()
            state, m = step(state, batch)
            rows.append({k: float(m[k]) for k in ("loss", "grad_norm",
                                                  "lr")})
            secs.append(time.perf_counter() - t)
            colls.append(comm.counts())
            nbytes.append(dict(comm.BYTES))
        torch.cuda.synchronize()
        counts, peak = _all_counts(), torch.cuda.max_memory_allocated()
        need = TP_KERNELS[:4] + (TP_KERNELS[4:] if mode != "discrete"
                                 else ())
        for name in need:
            check(counts[name] > 0,
                  f"phase 52 rank {rank} {mode}: {name} never launched")
        ref = want.get(mode)
        check(ref is not None and len(ref["rows"]) >= steps,
              f"phase 52 rank {rank} {mode}: the single-process run ran no "
              f"such {steps} steps to compare with ({sorted(want)})")
        per_ref = {k: v / ref["steps"] for k, v in ref["counts"].items()}
        per = {k: v / steps for k, v in counts.items()}
        check(all(per[k] == per_ref[k] for k in need),
              f"phase 52 rank {rank} {mode}: launches per step {per}, the "
              f"single-process run's {per_ref}")
        errs = []
        for i, (got, w) in enumerate(zip(rows, ref["rows"])):
            e = {k: abs(got[k] - w[k]) / abs(w[k])
                 for k in ("loss", "grad_norm")}
            errs.append(e)
            check(e["loss"] <= TP_LOSS_RTOL
                  and e["grad_norm"] <= TP_GNORM_RTOL
                  and got["lr"] == w["lr"],
                  f"phase 52 rank {rank} {mode} step {i}: {got} vs the "
                  f"single-process {w} (rel {e}; bounds {TP_LOSS_RTOL}, "
                  f"{TP_GNORM_RTOL})")
        want_c = step_collectives(arch, mesh, n_leaves, seq_len=TRAIN_SEQ,
                                  kinds=kinds, loss_chunk=tcfg.loss_chunk)
        for i, c in enumerate(colls):
            check(c == want_c, f"phase 52 rank {rank} {mode} step {i}: "
                               f"collectives {c}, want {want_c}")
        print(f"  rank {rank} {mode}: losses {[r['loss'] for r in rows]}, "
              f"grad_norm {[r['grad_norm'] for r in rows]} (rel to the "
              f"single-process run: {errs}); s/step {[round(x, 4) for x in secs]}; "
              f"collectives per step {colls[-1]}; bytes per step "
              f"{nbytes[-1]}; launches per step "
              f"{ {k: v / steps for k, v in counts.items()} }; peak "
              f"allocated {peak} B", flush=True)
        out[mode] = {"counts": counts, "steps": steps, "rows": rows,
                     "errs": errs, "step_seconds": secs,
                     "collectives": colls, "bytes": nbytes, "peak": peak,
                     "replicated": _replicated_digest(state, mesh)}
        del state, step, batch, m
        gc.collect()
        torch.cuda.empty_cache()
    out["collective_ms"] = _tp_collective_ms(mesh)
    print(f"  rank {rank}: one gloo collective of the residual stream "
          f"(ms, host clock, mean of 5): {out['collective_ms']}", flush=True)
    dist.destroy_process_group()
    print(json.dumps(out), flush=True)


def _replicated_digest(state, mesh):
    """sha256 of the param leaves "model" does not split, as this rank
    holds them: the ranks of "model" agree bit for bit unless a partial
    gradient (``parallel.tensor.partial_leaves``) went unsummed, whatever
    that does to grad_norm."""
    import hashlib

    from repro_torch.parallel import tensor as tp_rules
    from repro_torch.train.data_parallel import local_tensor
    from torch.utils import _pytree as pytree
    digest = hashlib.sha256()
    for leaf, split in zip(pytree.tree_leaves(state.params),
                           tp_rules.model_split(state.params, mesh)):
        if not split:
            digest.update(local_tensor(leaf).detach().cpu().numpy()
                          .tobytes())
    return digest.hexdigest()


def _tp_collective_ms(mesh, calls=5):
    """ms per call (host clock around synchronised calls: gloo blocks the
    host) of phase 52's two activation collectives: the all_gather of a
    rank's (8, 512, 1024) float32 block and the reduce_scatter of a whole
    (8, 1024, 1024)."""
    from repro_torch.parallel import comm
    from repro_torch.parallel.layout import axes_group
    g = axes_group(mesh, ["model"])
    block = torch.randn(TRAIN_BATCH, TRAIN_SEQ // 2, 1024, device="cuda")
    whole = torch.randn(TRAIN_BATCH, TRAIN_SEQ, 1024, device="cuda")
    out = {}
    for name, fn in (("all_gather",
                      lambda: comm.gather_from_sequence(block, g, 1)),
                     ("reduce_scatter",
                      lambda: comm.scatter_to_sequence(whole, g, 1))):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t) / calls * 1e3
    return out


def _tp_ranks(results):
    """Phase 52's ranks' results, rank by rank: their replicated params
    must agree after each mode."""
    res = {f"rank{r}": out for r, out in enumerate(results)}
    for mode in ("discrete", "node_symplectic"):
        check(res["rank0"][mode]["replicated"]
              == res["rank1"][mode]["replicated"],
              f"phase 52 {mode}: the ranks' replicated params differ")
    print(f"  the ranks' replicated params agree bit for bit after each mode",
          flush=True)
    return res


def _tp_child():
    """``chip_smoke.py --mesh 52``: phase 52 alone (the kernels built
    lazily)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps(mesh_tp_phase()), flush=True)


def mesh_tp_phase():
    phase(f"52 LM train tensor-parallel (2 gloo ranks sharing the card, "
          f"(data 1, model 2), ZeRO-1): qwen3-0.6b full width, "
          f"{TP_LAYERS} of 28 layers, batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
          f"float32, 2 discrete steps (remat) and 1 node-symplectic step, "
          f"against their single-process run")
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "want.json")
        port = str(_free_port())
        ranks = _rank_children([[MESH_CHILD, "52", str(r), port, path]
                                for r in range(2)])
        want = _tp_reference()

        def save(tmp):
            with open(tmp, "w") as f:
                json.dump(want, f)
        _publish(path, save)
        torch.cuda.empty_cache()
        return _tp_ranks(_rank_results(ranks, "52"))


# ---------------------------------------------------------------------------
# phase 53: tensor parallelism of the MoE, MLA and patch-frontend archs, 2
# gloo ranks sharing the card on ("data" 1, "model" 2)
# ---------------------------------------------------------------------------

ZOO_TP_CHILD = "--zoo-tp"
# the depth cuts (whole units at full width, as --layers): deepseek-v2-lite-
# 16b to its dense prefix layer and 2 MoE units (1.67 B params; whole it is
# 15.7 B, which no card trains in float32; with 3 units, 2.25 B, each rank
# ran out of the shared card's memory in AdamW's out-of-place update at
# 35.94 GiB: PERF.md §6); internvl2-1b to 4 of its 24 layers
ZOO_TP_LAYERS = {"deepseek-v2-lite-16b": 3, "internvl2-1b": 4}
ZOO_TP_PATCHES = 256             # internvl2: one tile before 768 tokens
# each arch's runs, each from the seed-0 state: (name, mode, steps, ep; ep
# lays the ranks' state out expert-parallel, the single process's alike)
ZOO_TP_RUNS = {
    "deepseek-v2-lite-16b": (("discrete", "discrete", 2, False),
                             ("node_symplectic", "node", 1, False),
                             ("ep", "discrete", 1, True)),
    "internvl2-1b": (("discrete", "discrete", 1, False),)}
# relative distance of each rank's loss and grad_norm from the single-
# process run's (the MoE's expert choices replayed from it), fixed before
# the first card run (PERF.md §6): tools/tp_rounding.py at smoke
# width reads at most 1.6e-7 (loss) and 2.1e-7 (grad_norm); the faults it
# plants move grad_norm by 6.3e-3 (the router's and MLA's partial leaves
# unsummed), 1.7e-4 (the aux loss's gradient counted per rank) and 2.1e-3
# (the frontend gather's other backward)
ZOO_TP_LOSS_RTOL = 1e-5
ZOO_TP_GNORM_RTOL = 1e-5
ZOO_TP_KERNELS = {
    "deepseek-v2-lite-16b": ("rms_norm", "rms_norm_bwd"),
    "internvl2-1b": ("rms_norm", "flash_attention", "rms_norm_bwd",
                     "flash_attention_bwd")}


def _zoo_tp_arch(arch_id, mode):
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import NodeConfig
    arch = get_arch(arch_id).with_(n_layers=ZOO_TP_LAYERS[arch_id])
    if mode == "node":
        arch = arch.with_(node=NodeConfig(mode="node", method="euler",
                                          grad_mode="symplectic"))
    return arch


def _zoo_tp_state(arch, tcfg, mesh, ep, extra=frozenset(), together=False):
    """The seed-0 train state, laid out on ``mesh`` (``ep``: expert
    parallel; ``extra``: leaf names laid out whole) when given; on a mesh
    the ranks make it one after the other (each makes the whole state, ~20
    GB for deepseek, before it keeps its blocks), or all at once
    (``together``: a state small enough for two on the card)."""
    import gc

    from repro_torch.train import init_train_state
    if mesh is None:
        return init_train_state(arch, tcfg, device="cuda")
    import torch.distributed as dist
    from repro_torch.parallel import state_specs
    from repro_torch.runtime import reshard_state
    state = None
    for r in range(dist.get_world_size()):
        if together or r == dist.get_rank():
            whole = init_train_state(arch, tcfg, device="cuda")
            state = reshard_state(whole, mesh, state_specs(
                whole, mesh, ep=ep, extra_replicated=extra))
            del whole
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
        if together:
            break
    return state


def _route_digest(idx) -> str:
    import hashlib
    return hashlib.sha256(idx.cpu().numpy().tobytes()).hexdigest()


def _zoo_tp_runs(arch_id, mesh=None, forced=None):
    """The arch's runs (``ZOO_TP_RUNS``) on the card: in one process
    (``mesh`` None), or this rank's on ``mesh`` replaying ``forced``
    ({run: [each step's expert choices, per MoE call]}).  Per run: the
    metrics, s/step, launches, collectives and their bytes per step, peak
    bytes, and each step's own expert choices per MoE call (on a mesh: as
    digests, with the rows whose choices differ from the replayed ones
    counted, and a digest of the unsplit params)."""
    import gc

    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.optim import cosine_schedule
    from repro_torch.parallel import comm, make_sharder
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train.data_parallel import Zero1, step_collectives
    from torch.utils import _pytree as pytree
    tcfg = TrainConfig()
    out = {}
    for run, mode, steps, ep in ZOO_TP_RUNS[arch_id]:
        arch = _zoo_tp_arch(arch_id, mode)
        P = ZOO_TP_PATCHES if arch.frontend == "patch" else 0
        state = _zoo_tp_state(arch, tcfg, mesh, ep)
        n_leaves = len(pytree.tree_leaves(state.params))
        z = None if mesh is None else Zero1(mesh, state)
        step = make_train_step(arch, tcfg, lr_fn=cosine_schedule(3e-4, 5, 3),
                               shard=None if mesh is None
                               else make_sharder(mesh), grad_constraint=z)
        pipe = iter(TokenPipeline(TRAIN_BATCH, TRAIN_SEQ - P, arch.vocab,
                                  device="cuda"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_all_counts()
        rows, secs, colls, nbytes, own, rerouted = [], [], [], [], [], []
        for i in range(steps):
            batch = next(pipe)
            if P:
                batch["patch_embeds"] = torch.randn(
                    (TRAIN_BATCH, P, arch.d_frontend), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(i))
            comm.reset_counts()
            with _Gates(None if forced is None else forced[run][i]) as g:
                t = time.perf_counter()
                state, m = step(state, batch)
                rows.append({k: float(m[k]) for k in ("loss", "grad_norm",
                                                      "lr")})
                secs.append(time.perf_counter() - t)
            colls.append(comm.counts())
            nbytes.append(dict(comm.BYTES))
            if forced is None:
                own.append([c.cpu() for c in g.own])
                continue
            own.append([_route_digest(c) for c in g.own])
            moved = torch.zeros(TRAIN_BATCH, dtype=torch.bool, device="cuda")
            for mine, theirs in zip(g.own, g.calls):
                moved |= (mine != theirs).flatten(1).any(1)
            rerouted.append(int(moved.sum()))
            want = step_collectives(arch, mesh, n_leaves,
                                    seq_len=TRAIN_SEQ - P, kinds=z.kinds,
                                    loss_chunk=tcfg.loss_chunk, patches=P)
            check(colls[-1] == want,
                  f"phase 53 {arch_id} {run} step {i}: collectives "
                  f"{colls[-1]}, want {want}")
        torch.cuda.synchronize()
        res = {"rows": rows, "step_seconds": secs, "counts": _all_counts(),
               "collectives": colls, "bytes": nbytes,
               "peak": torch.cuda.max_memory_allocated(), "own": own}
        if mesh is not None:
            res["rerouted_rows"] = rerouted
            res["replicated"] = _replicated_digest(state, mesh)
        who = "one process" if mesh is None else \
            f"rank {torch.distributed.get_rank()}"
        print(f"  {arch_id} {run} ({who}): {rows}, s/step "
              f"{[round(x, 4) for x in secs]}, peak {res['peak']} B",
              flush=True)
        out[run] = res
        del state, step, batch, m
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _zoo_tp_reference(d):
    """Phase 53's single-process runs, in this process (TF32 off, as
    ``main`` sets it); saves each step's expert choices to DIR/routes.pt
    for the ranks and returns the rest, the card's memory given back."""
    import gc
    routes, out = {}, {}
    for arch_id in ZOO_TP_RUNS:
        runs = _zoo_tp_runs(arch_id)
        routes[arch_id] = {run: r.pop("own") for run, r in runs.items()}
        out[arch_id] = runs
    _publish(os.path.join(d, "routes.pt"),
             lambda tmp: torch.save(routes, tmp))
    del routes
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _zoo_tp_rank(rank, port, d):
    """``chip_smoke.py --zoo-tp rank R PORT DIR``: phase 53's rank R of 2
    on ("data" 1, "model" 2), replaying DIR/routes.pt; prints its results
    as its last line."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    torch.cuda.set_device(0)
    mesh = make_debug_mesh(1, 2, device_type="cuda")
    _await_file(os.path.join(d, "routes.pt"))
    routes = torch.load(os.path.join(d, "routes.pt"), map_location="cuda")
    out = {arch_id: _zoo_tp_runs(arch_id, mesh, routes[arch_id])
           for arch_id in ZOO_TP_RUNS}
    dist.destroy_process_group()
    print(json.dumps(out), flush=True)


def zoo_tp_phase():
    import tempfile
    phase(f"53 LM train tensor-parallel, the zoo (2 gloo ranks sharing the "
          f"card, (data 1, model 2), ZeRO-1, float32): deepseek-v2-lite-16b "
          f"(3 of 27 layers) 2 discrete steps TP-in-expert, 1 node-"
          f"symplectic, 1 discrete expert-parallel; internvl2-1b (4 of 24 "
          f"layers, {ZOO_TP_PATCHES} patches + "
          f"{TRAIN_SEQ - ZOO_TP_PATCHES} tokens) 1 discrete step; batch "
          f"{TRAIN_BATCH}, each against its single-process run")
    torch.cuda.empty_cache()
    print(f"  this process holds {torch.cuda.memory_allocated()} B of the "
          f"card", flush=True)
    with tempfile.TemporaryDirectory() as d:
        port = str(_free_port())
        children = _rank_children([[ZOO_TP_CHILD, "rank", str(r), port, d]
                                   for r in range(2)])
        ref = _zoo_tp_reference(d)
        ranks = _rank_results(children, "53")
    for arch_id, runs in ZOO_TP_RUNS.items():
        for run, mode, steps, ep in runs:
            want = ref[arch_id].get(run)
            check(want is not None and len(want["rows"]) >= steps,
                  f"phase 53 {arch_id} {run}: the single-process run ran "
                  f"no such {steps} steps to compare with")
            got = [r[arch_id][run] for r in ranks]
            need = ZOO_TP_KERNELS[arch_id] + (
                ("butcher_combine",) if mode == "node" else ())
            for rank, res in enumerate(got):
                for name in need:
                    check(res["counts"][name] > 0,
                          f"phase 53 rank {rank} {arch_id} {run}: {name} "
                          f"never launched")
                errs = []
                for i, (g, w) in enumerate(zip(res["rows"], want["rows"])):
                    e = {k: abs(g[k] - w[k]) / abs(w[k])
                         for k in ("loss", "grad_norm")}
                    errs.append(e)
                    check(e["loss"] <= ZOO_TP_LOSS_RTOL
                          and e["grad_norm"] <= ZOO_TP_GNORM_RTOL
                          and g["lr"] == w["lr"],
                          f"phase 53 rank {rank} {arch_id} {run} step {i}: "
                          f"{g} vs the single-process {w} (rel {e}; "
                          f"bounds {ZOO_TP_LOSS_RTOL}, {ZOO_TP_GNORM_RTOL})")
                res["errs"] = errs
                print(f"  rank {rank} {arch_id} {run}: losses "
                      f"{[r['loss'] for r in res['rows']]}, grad_norm "
                      f"{[r['grad_norm'] for r in res['rows']]} (rel to the "
                      f"single-process run: {errs}); s/step "
                      f"{[round(x, 4) for x in res['step_seconds']]} (single "
                      f"process {[round(x, 4) for x in want['step_seconds']]}"
                      f"); collectives per step {res['collectives'][-1]}; "
                      f"bytes per step {res['bytes'][-1]}; launches "
                      f"{res['counts']}; peak allocated {res['peak']} B "
                      f"(single process {want['peak']} B)", flush=True)
            check(got[0]["replicated"] == got[1]["replicated"],
                  f"phase 53 {arch_id} {run}: the ranks' unsplit params "
                  f"differ")
            check(got[0]["own"] == got[1]["own"],
                  f"phase 53 {arch_id} {run}: the ranks' own expert choices "
                  f"differ")
            calls = sum(len(s) for s in got[0]["own"])
            if calls:
                print(f"  {arch_id} {run}: both ranks' own top-k choices "
                      f"bitwise equal at all {calls} MoE calls; replayed "
                      f"from the single-process run, whose choices they "
                      f"differ from on their own in "
                      f"{got[0]['rerouted_rows']} of {TRAIN_BATCH} rows per "
                      f"step (unforced share "
                      f"{[n / TRAIN_BATCH for n in got[0]['rerouted_rows']]}"
                      f")", flush=True)
    print("  the ranks' unsplit params agree bit for bit after every run",
          flush=True)
    return {"ref": ref, "ranks": ranks}


def _zoo_tp_child(*rest):
    """``chip_smoke.py --zoo-tp``: phase 53 alone (the kernels built
    lazily); with ``rank R PORT DIR``: one of its rank processes."""
    if rest[:1] == ("rank",):
        _zoo_tp_rank(int(rest[1]), rest[2], rest[3])
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(json.dumps(zoo_tp_phase()), flush=True)


# ---------------------------------------------------------------------------
# phase 54: tensor parallelism of Mamba, xLSTM and the enc-dec model, 2 gloo
# ranks sharing the card on ("data" 1, "model" 2), in a process of its own
# (``python3 chip_smoke.py --rec-tp``)
# ---------------------------------------------------------------------------

REC_TP_CHILD = "--rec-tp"
# each arch's depth cut (the widths whole) and runs, each from the seed-0
# state: (run, mode, layout: "whole" lays Mamba out with
# extra_replicated=MAMBA_PARAM_NAMES); jamba-v0.1-52b to its layer 0
# (Mamba with a dense FFN: the MoE layers hold 2.8 B params each),
# xlstm-1.3b to 8 of 48 layers (7 mLSTM, 1 sLSTM), seamless-m4t-medium to
# 2 of 12 layers on each side
REC_TP_ARCHS = {
    "jamba-v0.1-52b": ({"n_layers": 1}, (("split", "discrete", "split"),
                                         ("whole", "discrete", "whole"))),
    "xlstm-1.3b": ({"n_layers": 8}, (("discrete", "discrete", "split"),
                                     ("node_symplectic", "node", "split"))),
    "seamless-m4t-medium": ({"n_layers": 2, "enc_layers": 2},
                            (("discrete", "discrete", "split"),))}
# (target tokens, source frames) per row: seamless's decoder 256 tokens
# against 1024 frames (its cross-attention Sq 256 != Sk 1024, as phase 47)
REC_TP_SEQ = {"seamless-m4t-medium": (256, 1024)}
# xlstm-1.3b's labels past the first REC_TP_KEEP positions of each row are
# IGNORE: at full width the random sLSTM's backward grows ~e^0.5 a step,
# so a float32 gradient through more than ~100 steps overflows
# (tools/slstm_rounding.py: one full-width sLSTM layer's input gradient is
# inf from 128 positions back); the forward and backward still run over
# all 1024 positions
REC_TP_KEEP = 32
# relative distance of each rank's loss and grad_norm from the single-
# process run's, fixed before the first card run (PERF.md §6): the CPU's
# float32 rounding at smoke width (tools/tp_rounding.py --arch ...) and, for
# xlstm's replayed full-width sLSTM, tools/slstm_rounding.py (float32
# against float64: grad norm 2.3e-7 over 32 kept positions)
REC_TP_LOSS_RTOL = 1e-5
REC_TP_GNORM_RTOL = 1e-5
REC_TP_KERNELS = {
    "jamba-v0.1-52b": ("rms_norm", "rms_norm_bwd"),
    "xlstm-1.3b": ("rms_norm", "rms_norm_bwd"),
    "seamless-m4t-medium": ("rms_norm", "flash_attention", "rms_norm_bwd",
                            "flash_attention_bwd")}
# flash's backward at seamless's per-rank training shapes on "model" 2 (8
# of 16 heads): the encoder, the cross-attention, the decoder's causal
# self-attention: (name, B, H, Sq, Sk, D, causal)
REC_TP_BWD = [("encoder", 8, 8, 1024, 1024, 64, False),
              ("cross", 8, 8, 256, 1024, 64, False),
              ("decoder_self", 8, 8, 256, 256, 64, True)]


def _rec_tp_arch(arch_id, mode):
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import NodeConfig
    cut, _ = REC_TP_ARCHS[arch_id]
    arch = get_arch(arch_id).with_(**cut)
    if arch_id == "jamba-v0.1-52b":
        arch = arch.with_(pattern=arch.pattern[:1])
    if mode == "node":
        arch = arch.with_(node=NodeConfig(mode="node", method="euler",
                                          grad_mode="symplectic"))
    return arch


def _rec_tp_batch(arch):
    """The run's one batch, alike in every process: 8 rows from the token
    pipeline (xlstm's labels past ``REC_TP_KEEP`` IGNORE; seamless's 1024
    source frames from a seeded generator on the card)."""
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.train import IGNORE
    S, S_enc = REC_TP_SEQ.get(arch.name, (TRAIN_SEQ, 0))
    batch = next(iter(TokenPipeline(TRAIN_BATCH, S, arch.vocab,
                                    device="cuda")))
    if arch.name == "xlstm-1.3b":
        labels = batch["labels"].clone()
        labels[:, REC_TP_KEEP:] = IGNORE
        batch["labels"] = labels
    if arch.encdec:
        batch["frames"] = torch.randn(
            (TRAIN_BATCH, S_enc, arch.d_frontend), device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(54))
    return batch, S, S_enc


class _TrainReplay:
    """A training step's replay of another run's forward (xlstm-1.3b is
    chaotic under rounding at full width: ``_Trajectory``).  Without
    ``forced`` it records each layer's input (the first call per layer:
    the forward pass; a layer is keyed by its mixer norm's storage) and the
    state each sLSTM cell step starts from (by sLSTM layer and position,
    read from the step input's offset in the layer's (B, S, 4 d) input
    projection).  With ``forced`` (those records) every call of a layer, in
    the forward, the recomputes and the symplectic adjoint, takes the
    recorded input (the rank's rows under ``seq_carry``) and every cell
    step the recorded state (the rank's heads: its block ``block`` of
    them), as x + (recorded - x).detach(): the values are the
    recorded run's and the gradient passes through as the identity, so
    the two runs differ by one layer's or one step's rounding alone."""

    def __init__(self, forced=None, block=0):
        self.forced, self.block = forced, block

    def __enter__(self):
        import repro_torch.models.lm as lm
        import repro_torch.nn.xlstm as xl
        self.layers, self.cells = {}, {}
        self._keys, self._cell_keys = {}, {}
        self.used = {"layers": 0, "cells": 0}
        self._layer, self._cell = lm.layer_forward, xl._slstm_cell

        def pin(x, want):
            return x + (want.to(x.dtype) - x).detach()

        def layer(p, x, *a, **kw):
            key = self._keys.setdefault(p["mixer_norm"]["w"].data_ptr(),
                                        len(self._keys))
            if self.forced is None:
                if key not in self.layers:
                    self.layers[key] = x.detach().clone()
            else:
                tp = kw.get("tp")
                want = self.forced["layers"][key]
                x = pin(x, want if tp is None else tp.rows(want))
                self.used["layers"] += 1
            return self._layer(p, x, *a, **kw)

        def cell(p, xt, st, H, dh):
            layer_key = self._cell_keys.setdefault(
                p["r"].untyped_storage().data_ptr(), len(self._cell_keys))
            key = (layer_key, xt.storage_offset() // xt.shape[-1])
            if self.forced is None:
                if key not in self.cells:
                    self.cells[key] = {k: v.detach().clone()
                                       for k, v in st.items()}
            else:
                want = self.forced["cells"][key]
                h0 = self.block * H
                st = {k: pin(v, want[k][:, h0:h0 + H])
                      for k, v in st.items()}
                self.used["cells"] += 1
            return self._cell(p, xt, st, H, dh)
        lm.layer_forward, xl._slstm_cell = layer, cell
        return self

    def __exit__(self, *exc):
        import repro_torch.models.lm as lm
        import repro_torch.nn.xlstm as xl
        lm.layer_forward, xl._slstm_cell = self._layer, self._cell

    def records(self):
        return {"layers": self.layers, "cells": self.cells}


def _rec_tp_runs(arch_id, mesh=None, d=None):
    """The arch's runs (``REC_TP_ARCHS``) on the card: in one process
    (``mesh`` None; xlstm's forward recorded to DIR/replay_RUN.pt), or this
    rank's on ``mesh`` (xlstm replaying those records).  Per run: the
    metrics, s/step, launches, collectives and their bytes, peak bytes,
    and on a mesh a digest of the unsplit params."""
    import gc

    from repro_torch.parallel import comm, make_sharder
    from repro_torch.parallel.shardings import MAMBA_PARAM_NAMES
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train.data_parallel import Zero1, step_collectives
    from torch.utils import _pytree as pytree
    tcfg = TrainConfig()
    out = {}
    replay = arch_id == "xlstm-1.3b"
    for run, mode, layout in REC_TP_ARCHS[arch_id][1]:
        if mesh is None and layout == "whole":
            continue            # one process has no layout: "split"'s run
        arch = _rec_tp_arch(arch_id, mode)
        extra = MAMBA_PARAM_NAMES if layout == "whole" else frozenset()
        t_state = time.perf_counter()
        state = _zoo_tp_state(arch, tcfg, mesh, False, extra, together=True)
        t_state = time.perf_counter() - t_state
        n_leaves = len(pytree.tree_leaves(state.params))
        z = None if mesh is None else Zero1(mesh, state)
        # the constant lr (3e-4): the one step moves the params, so the
        # ranks' unsplit params are held after an update
        step = make_train_step(arch, tcfg, shard=None if mesh is None
                               else make_sharder(mesh), grad_constraint=z)
        batch, S, S_enc = _rec_tp_batch(arch)
        forced, block = None, 0
        if replay and mesh is not None:
            forced = torch.load(os.path.join(d, f"replay_{run}.pt"),
                                map_location="cuda")
            block = torch.distributed.get_rank()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_all_counts()
        comm.reset_counts()
        with _TrainReplay(forced, block) as rp:
            t = time.perf_counter()
            state, m = step(state, batch)
            row = {k: float(m[k]) for k in ("loss", "grad_norm", "lr")}
            secs = time.perf_counter() - t
        res = {"rows": [row], "step_seconds": [secs],
               "state_seconds": t_state,
               "counts": _all_counts(), "collectives": [comm.counts()],
               "bytes": [dict(comm.BYTES)],
               "peak": torch.cuda.max_memory_allocated()}
        if replay and mesh is None:
            torch.save(rp.records(), os.path.join(d, f"replay_{run}.pt"))
            res["recorded"] = [len(rp.layers), len(rp.cells)]
        elif replay:
            res["replayed"] = dict(rp.used)
        if mesh is not None:
            want = step_collectives(arch, mesh, n_leaves, seq_len=S,
                                    kinds=z.kinds,
                                    loss_chunk=tcfg.loss_chunk,
                                    source_len=S_enc,
                                    whole_mamba=layout == "whole")
            check(res["collectives"][0] == want,
                  f"phase 54 {arch_id} {run}: collectives "
                  f"{res['collectives'][0]}, want {want}")
            res["replicated"] = _replicated_digest(state, mesh)
        who = "one process" if mesh is None else \
            f"rank {torch.distributed.get_rank()}"
        print(f"  {arch_id} {run} ({who}): {row}, s/step {secs:.4f} (state "
              f"made in {t_state:.2f} s), peak {res['peak']} B", flush=True)
        out[run] = res
        del state, step, batch, m, forced
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _rec_tp_rank(rank, port, d):
    """``chip_smoke.py --rec-tp rank R PORT DIR``: phase 54's rank R of 2
    on ("data" 1, "model" 2); prints its results as its last line."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    torch.cuda.set_device(0)
    mesh = make_debug_mesh(1, 2, device_type="cuda")
    _await_file(os.path.join(d, "go"))
    out = {arch_id: _rec_tp_runs(arch_id, mesh, d)
           for arch_id in REC_TP_ARCHS}
    dist.destroy_process_group()
    print(json.dumps(out), flush=True)


def zoo2_flash_bwd():
    """Phase 47's backward: flash's backward at seamless's per-rank
    training shapes on "model" 2 (phase 54's) against its plain version
    (``BWD_TOL``) and bitwise against itself; then ms per call beside the
    plain version, SDPA's backward and the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    print("  flash's backward at seamless-m4t-medium's per-rank training "
          "shapes (8 of 16 heads, D 64), vs plain", flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(54)
    rows, err = {}, 0.0
    for name, B, H, Sq, Sk, D, causal in REC_TP_BWD:
        q, do = (torch.randn(B, H, Sq, D, generator=g, device=dev)
                 for _ in range(2))
        k, v = (torch.randn(B, H, Sk, D, generator=g, device=dev)
                for _ in range(2))
        o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        want = ref.attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
        errs = [_rel_err(a, b) for a, b in zip(got, want)]
        check(max(errs) <= BWD_TOL[torch.float32],
              f"flash_attention_bwd {name}: rel errs {errs}")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"flash_attention_bwd {name}: two calls differ")
        err = max(err, max(float((a - b).abs().max())
                           for a, b in zip(got, want)))
        del got, again, want
        t_k = _time_ms(lambda: fa.flash_attention_bwd(
            q, k, v, o, lse, do, causal=causal), 10, 2)
        t_p = _time_ms(lambda: ref.attention_bwd_ref(
            q, k, v, o, lse, do, causal=causal), 3, 1)
        qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
        o_lib = F.scaled_dot_product_attention(qr, kr, vr, is_causal=causal)
        t_l = _time_ms(lambda: torch.autograd.grad(
            o_lib, (qr, kr, vr), do, retain_graph=True), 10, 2)
        d_k = _device_ms(lambda: fa.flash_attention_bwd(
            q, k, v, o, lse, do, causal=causal), "attn_bwd", 10, 3)
        h_k = _host_ms(lambda: fa.flash_attention_bwd(
            q, k, v, o, lse, do, causal=causal), 20)
        # five products (S, dP, dV, dK, dQ) over the pairs attended
        pairs = Sq * (Sq + 1) // 2 if causal else Sq * Sk
        t_ops = 3 * 2.5 * 4 * B * H * D * pairs / TF32_FLOP_PER_S
        nbytes = (4 * B * H * Sq * D + 4 * B * H * Sk * D + B * H * Sq) * 4
        t_bytes = nbytes / HBM_BYTES_PER_S
        bound = max(t_ops, t_bytes) * 1e3
        rows[name] = dict(ms=t_k, device_ms=d_k, host_ms=h_k, plain_ms=t_p,
                          library_ms=t_l, bound_ms=bound,
                          bound_by="operations" if t_ops >= t_bytes
                          else "bytes", max_rel_err=max(errs),
                          shape=f"float32 B{B} H{H} Sq{Sq} Sk{Sk} D{D} "
                                f"{'causal' if causal else 'non-causal'}")
        print(f"  flash_attention_bwd {name} B{B} H{H} Sq{Sq} Sk{Sk} D{D} "
              f"{'causal' if causal else 'non-causal'}: rel errs "
              f"{[f'{e:.2e}' for e in errs]}; kernel {t_k:.6f} ms (device, "
              f"3 kernels {d_k if d_k is None else f'{d_k:.6f}'}, host "
              f"{h_k:.6f}) plain {t_p:.6f} sdpa backward {t_l:.6f} "
              f"kernel/library {t_k / t_l:.3f} bound {bound:.6f} "
              f"({rows[name]['bound_by']}"
              f"{'' if d_k is None else f'; {bound / d_k * 100:.1f}% of it alone'})",
              flush=True)
        del q, k, v, o, lse, do, qr, kr, vr, o_lib
    torch.cuda.empty_cache()
    return {"rows": rows, "max_abs_err": err}


def _rec_tp_child(*rest):
    """``chip_smoke.py --rec-tp``: phase 54 alone (the kernels built
    lazily); with ``rank R PORT DIR``: one of its rank processes."""
    if rest[:1] == ("rank",):
        _rec_tp_rank(int(rest[1]), rest[2], rest[3])
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps(rec_tp_phase()), flush=True)


def rec_tp_phase():
    """Phase 54: the single-process runs in this process while the 2 rank
    processes start, then the ranks (they wait for DIR/go); each rank held
    against its single-process run."""
    import tempfile
    phase("54 LM train tensor-parallel, Mamba, xLSTM and the enc-dec model "
          "(2 gloo ranks sharing the card, (data 1, model 2), ZeRO-1, "
          "float32): jamba-v0.1-52b layer 0 (Mamba by channel and Mamba "
          "laid out whole), xlstm-1.3b 8 of 48 layers (discrete and node-"
          "symplectic, its forward replayed), seamless-m4t-medium 2 + 2 of "
          "12 + 12 layers; each 1 step against its single-process run")
    t = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        port = str(_free_port())
        children = _rank_children([[REC_TP_CHILD, "rank", str(r), port, d]
                                   for r in range(2)])
        ref = {arch_id: _rec_tp_runs(arch_id, None, d)
               for arch_id in REC_TP_ARCHS}
        torch.cuda.empty_cache()
        _publish(os.path.join(d, "go"), lambda tmp: open(tmp, "w").close())
        ranks = _rank_results(children, "54")
    for arch_id, (_, runs) in REC_TP_ARCHS.items():
        for run, mode, layout in runs:
            want = ref[arch_id]["split" if layout == "whole" else run]
            got = [r[arch_id][run] for r in ranks]
            need = REC_TP_KERNELS[arch_id] + (
                ("butcher_combine",) if mode == "node" else ())
            for rank, res in enumerate(got):
                for name in need:
                    check(res["counts"][name] > 0,
                          f"phase 54 rank {rank} {arch_id} {run}: {name} "
                          f"never launched")
                g, w = res["rows"][0], want["rows"][0]
                e = {k: abs(g[k] - w[k]) / abs(w[k])
                     for k in ("loss", "grad_norm")}
                res["errs"] = [e]
                check(e["loss"] <= REC_TP_LOSS_RTOL
                      and e["grad_norm"] <= REC_TP_GNORM_RTOL
                      and g["lr"] == w["lr"],
                      f"phase 54 rank {rank} {arch_id} {run}: {g} vs the "
                      f"single-process {w} (rel {e}; bounds "
                      f"{REC_TP_LOSS_RTOL}, {REC_TP_GNORM_RTOL})")
                if "replayed" in res:
                    check(res["replayed"]["layers"] > 0
                          and res["replayed"]["cells"] > 0,
                          f"phase 54 rank {rank} {arch_id} {run}: nothing "
                          f"replayed ({res['replayed']})")
                print(f"  rank {rank} {arch_id} {run}: loss {g['loss']}, "
                      f"grad_norm {g['grad_norm']} (rel to the single-"
                      f"process run: {e}); s/step "
                      f"{[round(x, 4) for x in res['step_seconds']]} (single "
                      f"process {[round(x, 4) for x in want['step_seconds']]}"
                      f"); collectives per step {res['collectives'][0]}; "
                      f"bytes per step {res['bytes'][0]}; launches "
                      f"{res['counts']}; peak allocated {res['peak']} B "
                      f"(single process {want['peak']} B)"
                      + (f"; replayed {res['replayed']} (recorded "
                         f"{want['recorded']})" if "replayed" in res
                         else ""), flush=True)
            check(got[0]["replicated"] == got[1]["replicated"],
                  f"phase 54 {arch_id} {run}: the ranks' unsplit params "
                  f"differ")
    print("  the ranks' unsplit params agree bit for bit after every run",
          flush=True)
    print(f"phase 54 seconds {time.perf_counter() - t:.1f}", flush=True)
    return {"ref": ref, "ranks": ranks}


# ---------------------------------------------------------------------------
# phase 41: the auditor (repro_torch.analysis) on the card
# ---------------------------------------------------------------------------

# the allocator comparison's probe (float64): the caching allocator rounds
# every block up to 512 B, so the rule's own dim-4 probe (32-byte states,
# 2 KiB hidden vectors) would make each step's checkpoints (x, t: 2 x 512 B)
# weigh against a flat strategy's ~70-120 KiB; hidden 1024 makes its fixed
# part ~0.5 MB, and dim 8 keeps backprop's per-step activations above its
# parameter-sized part (growth 5.4x / 4.4x on the CPU)
ALLOC_DIM, ALLOC_HIDDEN = 8, 1024
# cases also run on the card with the plain combines, to hold the
# recorder's counts there against the CPU's committed "torch" budgets
PLAIN_CASES = ("symplectic/dopri5/fixed/t1/single",
               "symplectic/dopri5/adaptive/t1/single",
               "backprop/dopri5/fixed/t1/single",
               "adjoint/dopri5/adaptive/t1/single",
               "remat_step/dopri5/fixed/t1/single",
               "symplectic/dopri5/adaptive/t1/batched")
CARD_ONLY_OPS = {"aten._to_copy", "aten.select"}
CPU_ONLY_OPS = {"aten.lift_fresh"}


def _alloc_peak(fn, args):
    """Allocated bytes above the inputs at the peak of ``fn(*args)``.  The
    earlier calls' autograd graphs (reference cycles through the
    strategies' ``ctx``) are collected first: freed during the call, they
    would lower the peak below the call's own."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = fn(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    del out
    return peak


def _analysis_child():
    """Phase 41's process: ``run_analysis`` on the cuda backend (the
    sharded cells on an in-process gloo world of 1 with CUDA tensors),
    then the allocator beside the recorder."""
    from repro_torch.analysis import (case_records, count_ops,
                                      enumerate_cases, load_budgets, record,
                                      render_report, run_analysis)
    from repro_torch.analysis.memory import (MEMORY_METHODS, N_BIG, N_SMALL,
                                             MemoryRow, grad_loss,
                                             growth_class, memory_findings)
    from repro_torch.core.api import GRADIENT_REGISTRY
    torch.cuda.set_device(0)
    budgets = load_budgets()
    have_cuda = any(k.endswith(":cuda") for k in budgets)
    # warm-up: kernels loaded, cuBLAS workspace made, before any baseline
    for method in MEMORY_METHODS:
        for name in sorted(GRADIENT_REGISTRY):
            fn, args = grad_loss(name, method, 2, dim=ALLOC_DIM,
                                 hidden=ALLOC_HIDDEN, device="cuda")
            fn(*args)
    torch.cuda.synchronize()
    _zero_combine_counts()
    t = time.perf_counter()
    report = run_analysis(budgets, device="cuda", run_memory=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = dict(zip(("butcher_combine", "butcher_combine_rows"),
                        _combine_counts()))
    print(render_report(report))
    print(f"  run_analysis(device='cuda') {seconds:.1f} s; combine launches "
          f"under it {launches}; budgets have cuda keys: {have_cuda}")
    errors = report.errors
    if not have_cuda:
        # the first card run of a tree: its cuda counts are what a commit
        # takes as the cuda budgets (the missing keys are its only errors)
        errors = [f for f in errors if "no committed budget" not in f.message]
        pathlib.Path("chiprun_out").mkdir(exist_ok=True)
        pathlib.Path("chiprun_out/analysis_counts_cuda.json").write_text(
            json.dumps(dict(sorted(report.counts.items())), indent=2))
        print("  no cuda budgets committed: counts written to "
              "chiprun_out/analysis_counts_cuda.json")
    check(not errors, "phase 41: ERROR findings on the cuda backend:\n"
          + "\n".join(str(f) for f in errors))
    check(not report.failed_probes,
          f"phase 41: probes did not succeed: {report.failed_probes}")
    check(all(v > 0 for v in launches.values()),
          f"phase 41: a combine kernel never launched: {launches}")
    # the recorder on the card's backward (autograd's device thread): every
    # grad run records more ops than its value run, and with the plain
    # combines a case counts what the CPU's committed torch budget says
    # (unless the torch versions differ: printed)
    grads = {k: v for k, v in report.counts.items() if ":grad:" in k}
    for k, n in grads.items():
        value = report.counts.get(k.replace(":grad:", ":value:"))
        check(value is not None and n > value,
              f"phase 41: {k} records {n} ops, value {value}: the backward "
              "was not recorded")
    # the same cases with the plain combines on the card and on the CPU, in
    # this process (one torch version): the ops the card adds or drops
    cases = {c.key: c for c in enumerate_cases()}
    plain = {}
    for key in PLAIN_CASES:
        recs = {dev: case_records(cases[key], device=dev, backend="torch")
                for dev in ("cuda", "cpu")}
        for kind in ("value", "grad"):
            if recs["cpu"][kind] is None:
                continue
            names = {dev: collections.Counter(
                r.name for r in recs[dev][kind].records) for dev in recs}
            plain[f"{key}:{kind}"] = (
                count_ops(recs["cuda"][kind]), count_ops(recs["cpu"][kind]),
                dict(names["cuda"] - names["cpu"]),
                dict(names["cpu"] - names["cuda"]),
                budgets.get(f"{key}:{kind}:torch"))
    same = sum(v[0] == v[1] for v in plain.values())
    print(f"  plain combines, card vs CPU in this process: {same} of "
          f"{len(plain)} calls count alike")
    for k, (n_card, n_cpu, more, fewer, committed) in plain.items():
        print(f"    {k}: card {n_card}, CPU {n_cpu} (committed CPU budget, "
              f"torch 2.13: {committed}); card adds {more}, drops {fewer}")
        # the card's only extra ops are the adaptive controller's one
        # device-to-host read per attempt (tolist: a copy to the host, a
        # select per element); a literal the CPU lifts may be made on it
        check(set(more) <= CARD_ONLY_OPS and set(fewer) <= CPU_ONLY_OPS,
              f"phase 41: {k} on the card adds {more}, drops {fewer}")
    # the allocator beside the recorder: Table 1 at the wider probe
    lines, rows_rec, rows_alloc = [], [], []
    for method in MEMORY_METHODS:
        for name in sorted(GRADIENT_REGISTRY):
            rec_peaks, alloc_peaks = [], []
            for n in (N_SMALL, N_BIG):
                fn, args = grad_loss(name, method, n, dim=ALLOC_DIM,
                                     hidden=ALLOC_HIDDEN, device="cuda")
                rec_peaks.append(record(fn, *args, records=False)[1]
                                 .peak_bytes)
                alloc_peaks.append(_alloc_peak(fn, args))
            r = MemoryRow(name, method, N_SMALL, rec_peaks[0], N_BIG,
                          rec_peaks[1])
            a = MemoryRow(name, method, N_SMALL, alloc_peaks[0], N_BIG,
                          alloc_peaks[1])
            rows_rec.append(r)
            rows_alloc.append(a)
            cr, ca = growth_class(r.growth, method), \
                growth_class(a.growth, method)
            lines.append(f"  {name:11s} {method:6s} recorder {rec_peaks[0]} "
                         f"-> {rec_peaks[1]} B ({r.growth:.3f}x, {cr}); "
                         f"allocator {alloc_peaks[0]} -> {alloc_peaks[1]} B "
                         f"({a.growth:.3f}x, {ca})")
            check(cr == ca and cr != "between",
                  f"phase 41: {name}/{method} recorder {cr} vs allocator "
                  f"{ca}")
    print(f"Table 1 on the card (float64, dim {ALLOC_DIM}, hidden "
          f"{ALLOC_HIDDEN}, one fixed-grid loss+gradient, N {N_SMALL} and "
          f"{N_BIG}; allocator = max_memory_allocated above the inputs):")
    print("\n".join(lines))
    for label, rows in (("recorder", rows_rec), ("allocator", rows_alloc)):
        fs = memory_findings(rows)
        check(not fs, f"phase 41: {label} memory findings: "
              + "; ".join(map(str, fs)))
    print(json.dumps({"launches": launches, "seconds": seconds,
                      "errors": len(report.errors),
                      "findings": len(report.findings),
                      "plain_equal": [same, len(plain)],
                      "table1_recorder": [_row(r) for r in rows_rec],
                      "table1_allocator": [_row(r) for r in rows_alloc]}),
          flush=True)


def _row(r):
    return [r.strategy, r.method, r.peak_small, r.peak_big]


ANALYSIS_TITLE = ("41 analysis: repro_torch.analysis on the cuda backend "
                  "(every case, the sharded cells on a gloo world of 1, the "
                  "engine's attempt, Table 1), recorder vs allocator")


def analysis_phase():
    phase(ANALYSIS_TITLE)
    return _mesh_phase(41)


def side_phases_start():
    """Phases 38 and 41 hold bits, counts and byte classes, and time
    nothing that other work on the card would disturb: ``main`` starts
    them beside phases 33-35 (float64 exactness, peak bytes, resume, which
    time nothing either) and joins them after."""
    torch.cuda.empty_cache()
    t = time.perf_counter() - _T0
    return t, {38: _child_start([MESH_CHILD, "38"]),
               41: _child_start([MESH_CHILD, "41"])}


def side_phases_finish(started):
    t, children = started
    out = {}
    for which, title in ((38, MESH_GLOO_TITLE), (41, ANALYSIS_TITLE)):
        phase(f"{title} (started at t {t:.1f} s, beside phases 33-35)")
        t_wait = time.perf_counter()
        out[which] = _child_finish(children[which], which)
        print(f"phase seconds {time.perf_counter() - t_wait:.1f} (waited "
              f"here)")
    return out



# ---------------------------------------------------------------------------
# The LM zoo's attention-and-expert half (phases 42-46), in a process of
# its own (``python3 chip_smoke.py --zoo``): deepseek-v2-lite-16b's 62.8 GB
# of float32 weights need a card that no earlier phase has filled

ZOO_CHILD = "--zoo"
ZOO_ARCH = "deepseek-v2-lite-16b"
ZOO_SERVE = dict(batch=8, prompt=1024, gen=32)
ZOO_STEPS = 4                    # decode steps of the kernels-vs-plain runs
# the share of sequence rows (batch > 1) or of prefill positions (batch 1)
# that an MoE layer routed differently on the two sides, fixed in PERF.md
# before the first card run; that run found every row of deepseek's
# routed differently (rounding grows through the random experts), so the
# share is reported beside this bound and the comparison itself replays
# one side's expert choices on the other (``_Gates(forced=...)``)
SET_ASIDE_BOUND = 0.5
# the other five at full width: (arch, batch, prompt, layers or None for
# all, patch embeddings before the prompt)
ZOO_OTHERS = [("stablelm-12b", 8, 1024, None, 0),
              ("qwen3-1.7b", 8, 1024, None, 0),
              ("minicpm-2b", 8, 1024, None, 0),
              ("internvl2-1b", 8, 768, None, 256),
              ("mixtral-8x7b", 1, 8192, 8, 0)]
# flash at the zoo's new shapes: D 160 (stablelm-12b's prefill, long keys
# with an offset, a window), internvl2-1b's GQA group of 7, and mixtral's
# window at 8192 (held against the blocked plain version, its plain route)
ZOO_ATTN_CASES = [
    (8, 32, 8, 1024, 1024, 160, True, None, 0),
    (1, 8, 2, 65, 4096, 160, True, None, 4031),
    (1, 8, 2, 300, 300, 160, True, 100, 0),
    (2, 14, 2, 200, 200, 64, True, None, 0),
    (8, 14, 2, 1024, 1024, 64, True, None, 0),
    (1, 32, 8, 8192, 8192, 128, True, 4096, 0),
]
# rms_norm at the zoo's widths: kv_lora 512 (MLA's kv_norm), internvl2's
# 896, deepseek's and qwen3-1.7b's 2048, minicpm's 2304, mixtral's 4096,
# stablelm's 5120 (rows of the batch-8 prefill)
ZOO_RMS = [(8192, 512), (10240, 896), (8192, 2048), (8192, 2304),
           (8192, 4096), (8192, 5120)]
# the timed flash shapes: stablelm-12b's prefill at D 160, mixtral's
# window (name, B, H, Hkv, S, D, window)
ZOO_TIMED = [("flash_attention_d160", 8, 32, 8, 1024, 160, None),
             ("flash_attention_window", 1, 32, 8, 8192, 128, 4096)]
# the blocked plain attention against the full one, at shapes both hold
BLOCKED_CASES = [(2, 8, 2, 2048, 4096, 64, True, None, 0),
                 (1, 4, 4, 1024, 8448, 128, True, 1000, 7424)]
BLOCKED_TOL = 1e-5               # the same float32 arithmetic, blocked


def _rms_per_forward(cfg, decode=False) -> int:
    """rms_norm launches of one forward: each layer's mixer norm and FFN
    norm (xLSTM's blocks have no FFN), q and k norms with qk_norm, MLA's
    kv_norm, and the final norm; the enc-dec model's decoder has three
    norms a layer, and its prefill (not a decode step) runs the encoder
    too: two a layer and its final norm."""
    if cfg.encdec:
        return 3 * cfg.n_layers + 1 + \
            (0 if decode else 2 * cfg.enc_layers + 1)
    n = 1
    for spec in list(cfg.prefix) + list(cfg.pattern) * cfg.n_repeats:
        n += 1 + (spec.ffn != "none") + (spec.mixer == "mla") \
            + 2 * cfg.qk_norm * (spec.mixer == "attn")
    return n


def _flash_per_prefill(cfg) -> int:
    """flash launches of one prefill (a decode step has none): one per GQA
    layer (MLA attends with the plain version); the enc-dec model's
    encoder layers and its decoder's self- and cross-attention."""
    if cfg.encdec:
        return cfg.enc_layers + 2 * cfg.n_layers
    return sum(spec.mixer == "attn"
               for spec in list(cfg.prefix)
               + list(cfg.pattern) * cfg.n_repeats)


class _Gates:
    """Records each MoE layer's routing (its top-k expert ids, in call
    order) while active, by wrapping ``repro_torch.nn.moe.route``.  With
    ``forced`` (another run's records, in the same call order) each call
    takes those expert ids instead of its own top-k, with gate weights from
    its own probabilities (renormalised as ``route`` does): the two runs
    then differ by their rounding alone, never by a routing decision.
    ``calls`` holds the ids taken, ``own`` each call's own top-k."""

    def __init__(self, forced=None):
        self.forced = forced

    def __enter__(self):
        import repro_torch.nn.moe as moe
        self.calls, self.own, self._route = [], [], moe.route

        def route(p, x, cfg):
            probs, w, idx = self._route(p, x, cfg)
            self.own.append(idx)
            if self.forced is not None:
                idx = self.forced[len(self.calls)].to(idx.device)
                w = torch.gather(probs, -1, idx)
                w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
            self.calls.append(idx)
            return probs, w, idx
        moe.route = route
        return self

    def __exit__(self, *exc):
        import repro_torch.nn.moe as moe
        moe.route = self._route


def _zoo_prefill(params, cfg, toks, patches, frames, max_len, cache_dtype,
                 cross_from=None):
    """``make_prefill_step``'s arithmetic, returning every position's final
    hidden state: {"hidden", "head", "caches"}.  The enc-dec model's
    decoder reads its cross K/V from the cache it just wrote (rounded to
    the cache dtype); with ``cross_from`` (another run's cross caches) it
    reads those instead, and the K/V it computed come back as
    "own_cross"."""
    if not cfg.encdec:
        from repro_torch.models.lm import init_caches, lm_forward
        caches = init_caches(cfg, toks.shape[0], max_len, cache_dtype,
                             device=toks.device)
        return lm_forward(params, cfg, toks, caches=caches,
                          extra_embeds=patches, mode="prefill",
                          return_hidden=True)
    from repro_torch.models import encdec
    memory = encdec.encode(params, frames, cfg)
    caches = encdec.init_encdec_caches(cfg, toks.shape[0], max_len,
                                       frames.shape[1], cache_dtype,
                                       device=toks.device)
    cross = encdec.precompute_cross_kv(params, memory, cfg)
    own = None
    for name in ("k", "v"):
        caches["cross"][name].copy_(cross[name])
    if cross_from is not None:
        own = {k: v.clone() for k, v in caches["cross"].items()}
        for name in ("k", "v"):
            caches["cross"][name].copy_(cross_from[name])
    out = encdec.decode_forward(params, cfg, toks, memory=memory,
                                caches=caches, mode="prefill",
                                return_hidden=True)
    out["own_cross"] = own
    return out


class _Trajectory:
    """Records, while active, each layer's input and output (in call order,
    by wrapping ``repro_torch.models.lm.layer_forward``) and the state each
    sLSTM cell step starts from and the one it makes (wrapping
    ``repro_torch.nn.xlstm._slstm_cell``).  With ``forced`` (another run's
    records, in the same call order) each layer and each cell step starts
    from that run's input instead of its own, and its own output is held
    against that run's: ``errors`` gathers, per layer call and per cell
    step, max|own - forced| / max|own| (each tensor of a cell's state
    apart; the replaying side is the reference), and ``used`` how many
    records of each kind were taken.  The two runs then differ by one
    layer's or one step's rounding, never by its growth through the stack
    and the recurrence.  xlstm-1.3b at full width (the JAX init: sLSTM
    recurrent weights of fan-in H, std 1/2, over dh 512) takes a 1e-7
    difference to O(1) within ~32 sLSTM steps, and its 48 layers take
    rms_norm's rounding to ~2e-4 at the first position (PERF.md), as a
    router reroutes under rounding.  ``record`` False keeps no records (a
    run only compared on its own)."""

    def __init__(self, forced=None, record=True):
        self.forced, self.record = forced, record

    def __enter__(self):
        import repro_torch.models.lm as lm
        import repro_torch.nn.xlstm as xl
        kinds = ("layers", "cells")
        self.ins = {k: [] for k in kinds}
        self.outs = {k: [] for k in kinds}
        self.errors = {k: [] for k in kinds}
        self.used = {k: 0 for k in kinds}
        self._layer, self._cell = lm.layer_forward, xl._slstm_cell

        def run(kind, step, own, out_of):
            i = self.used[kind]
            self.used[kind] += 1
            x = own if self.forced is None else self.forced[kind][i]
            res = step(x)
            y = out_of(res)
            if self.forced is not None:
                self.errors[kind].append(_replay_err(
                    y, self.forced[kind + "_out"][i]))
            if self.record:
                self.ins[kind].append(x)
                self.outs[kind].append(y)
            return res

        def layer(p, x, *a, **kw):
            return run("layers", lambda xx: self._layer(p, xx, *a, **kw), x,
                       lambda r: r[0])

        def cell(p, xt, st, H, dh):
            return run("cells", lambda s0: self._cell(p, xt, s0, H, dh), st,
                       lambda r: r)
        lm.layer_forward, xl._slstm_cell = layer, cell
        return self

    def __exit__(self, *exc):
        import repro_torch.models.lm as lm
        import repro_torch.nn.xlstm as xl
        lm.layer_forward, xl._slstm_cell = self._layer, self._cell

    def records(self):
        return {"layers": self.ins["layers"], "cells": self.ins["cells"],
                "layers_out": self.outs["layers"],
                "cells_out": self.outs["cells"]}

    def worst(self):
        """Per kind: (the largest error, the number of outputs held)."""
        return {k: (float(torch.stack(e).max()) if e else 0.0, len(e))
                for k, e in self.errors.items()}


def _replay_err(own, forced):
    """max|own - forced| / max|own| of a tensor, or the largest over a
    dict's tensors, as a 0-dim tensor on their device."""
    pairs = [(own[k], forced[k]) for k in own] if isinstance(own, dict) \
        else [(own, forced)]
    return torch.stack([(a - b).abs().max() / a.abs().max().clamp_min(
        1e-30) for a, b in pairs]).max()


def _zoo_serve(params, cfg, toks, patches, steps, feed=None, forced=None,
               cache_dtype=torch.bfloat16, caches_from=None,
               keep_caches=False, frames=None, replay=None):
    """The serving path's prefill (``make_prefill_step``'s arithmetic,
    keeping every position's final hidden state) and ``steps`` decode
    steps on the tokens' device, greedy or fed ``feed``, routed by
    ``forced`` when given (see ``_Gates``); counters zeroed before each,
    host clock around each (synchronised).  ``keep_caches`` keeps a copy
    of the caches after the prefill and after each decode step
    ("caches": what this run wrote); with ``caches_from`` (another run's
    copies) each decode step starts from those instead of its own, so
    that cache entries whose float32 values straddle a bfloat16 boundary
    on the two sides (and round apart) stay out of the logits' comparison
    (the caches are compared apart; the enc-dec model's prefill reads the
    other run's cross K/V, its own kept as "own_cross").  Returns the
    logits per step, the prefill hidden states, the tokens fed, the
    routing records, the launches and the times.  The enc-dec model takes
    its source ``frames``.  ``replay`` (another run's "trajectory", or
    True to record this run's) starts each layer and sLSTM step from the
    recorded inputs and holds their outputs against the recorded ones
    ("trajectory_err": ``_Trajectory.worst``)."""
    from torch.utils import _pytree as pytree
    from repro_torch.train import make_decode_step
    B, S = toks.shape
    P = 0 if patches is None else patches.shape[1]
    decode = make_decode_step(cfg)
    out = {"logits": [], "tokens": [], "counts": [], "ms": [], "caches": []}

    def timed(fn):
        _zero_lm_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t) * 1e3)
        out["counts"].append(_lm_counts())
        return res

    forced_traj = replay if isinstance(replay, dict) else None
    with torch.no_grad(), _Gates(forced) as gates, \
            _Trajectory(forced_traj, record=replay is True) as traj:
        cross_from = None if caches_from is None or not cfg.encdec else \
            caches_from[0]["cross"]
        res = timed(lambda: _zoo_prefill(params, cfg, toks, patches, frames,
                                         P + S + steps, cache_dtype,
                                         cross_from))
        logits = (res["hidden"][:, -1:] @ res["head"]).to(torch.float32)
        out["hidden"], caches = res["hidden"], res["caches"]
        out["own_cross"] = res.get("own_cross")
        n_prefill = len(gates.calls)
        for i in range(steps):
            out["logits"].append(logits)
            if keep_caches:
                out["caches"].append(pytree.tree_map(torch.clone, caches))
            if caches_from is not None:
                pytree.tree_map(lambda c, f: c.copy_(f), caches,
                                caches_from[i])
            tok = _greedy(logits) if feed is None else \
                feed[i].to(toks.device)
            out["tokens"].append(tok)
            logits, caches = timed(lambda: decode(params, caches, tok,
                                                  P + S + i))
        out["logits"].append(logits)
        if keep_caches:
            out["caches"].append(pytree.tree_map(torch.clone, caches))
    out["gates_prefill"] = gates.calls[:n_prefill]
    out["gates_decode"] = gates.calls[n_prefill:]
    if replay is True:
        out["trajectory"] = traj.records()
    if forced_traj is not None:
        check(all(traj.used[k] == len(forced_traj[k]) for k in traj.used),
              f"the replay took {traj.used} records of "
              f"{ {k: len(forced_traj[k]) for k in traj.used} }")
        out["trajectory_err"] = traj.worst()
    return out


def _routing_kept(k_run, p_run, B, S):
    """Which rows and prefill positions the two runs routed alike: a row is
    kept when every MoE decision of it agrees, in the prefill and in every
    decode step; a position of the prefill is kept when it lies before the
    row's first differing decision (routing and attention are causal, and a
    capacity rank depends only on earlier tokens)."""
    dev = k_run["hidden"].device
    first = torch.full((B,), S, dtype=torch.long, device=dev)
    row_ok = torch.ones(B, dtype=torch.bool, device=dev)
    pos = torch.arange(S, device=dev)
    for a, b in zip(k_run["gates_prefill"], p_run["gates_prefill"]):
        diff = (a != b).any(-1)                                   # (B, S)
        row_ok &= ~diff.any(-1)
        first = torch.minimum(first, torch.where(
            diff, pos, torch.full_like(pos, S)).min(-1).values)
    for a, b in zip(k_run["gates_decode"], p_run["gates_decode"]):
        row_ok &= ~(a != b).any(-1).any(-1)
    return row_ok, first


def _routing_share(name, k_run, p_run, B, S, tol=LOGITS_RTOL):
    """How much of the batch the two runs routed alike, on their own: the
    rows set aside, and the prefill positions from each row's first
    differing decision on; the share (of rows for batch > 1, of positions
    for batch 1) beside ``SET_ASIDE_BOUND`` (reported, not held: see
    there).  Held: on every row with a position before its first differing
    decision, the final hidden states of those positions within ``tol`` of
    the row's largest plain one, so that the two sides agree until routing
    parts them."""
    row_ok, first = _routing_kept(k_run, p_run, B, S)
    n_rows, kept_pos = int(row_ok.sum()), int(first.sum())
    share = 1 - (n_rows / B if B > 1 else kept_pos / S)
    hk, hp = k_run["hidden"], p_run["hidden"]
    row_errs = [float((hk[r, :f] - hp[r, :f]).abs().max()
                      / hp[r, :f].abs().max())
                for r, f in enumerate(first.tolist()) if f]
    h_err = max(row_errs) if row_errs else None
    print(f"{name}: routed on its own, set aside {B - n_rows}/{B} rows, "
          f"{B * S - kept_pos}/{B * S} prefill positions (share "
          f"{share:.4f}; bound fixed before the first card run "
          f"{SET_ASIDE_BOUND}: {'within' if share <= SET_ASIDE_BOUND else 'EXCEEDED'}"
          f"); final hidden before each row's first differing decision, "
          f"worst row's max|diff| / max|plain| "
          f"{h_err if h_err is None else f'{h_err:.3e}'} over "
          f"{len(row_errs)} rows (tolerance {tol})")
    check(all(e <= tol for e in row_errs),
          f"{name}: the two sides differ beyond {tol} before routing parts "
          f"them")
    return {"rows_set_aside": B - n_rows, "rows": B,
            "positions_set_aside": B * S - kept_pos, "positions": B * S,
            "share": share, "bound": SET_ASIDE_BOUND,
            "hidden_err_kept": h_err}


def _divergence(name, k_run, p_run, tol=LOGITS_RTOL):
    """Two runs of a recurrent model on their own (no replayed state): the
    first prefill position of each row whose final hidden state differs
    by more than ``tol`` of the row's largest plain one, and the share of
    positions from there on (reported, not held: the recurrence grows a
    rounding difference, ``_Trajectory``)."""
    hk, hp = k_run["hidden"], p_run["hidden"]
    B, S = hk.shape[:2]
    err = ((hk - hp).abs().amax(-1)
           / hp.abs().amax(dim=(1, 2))[:, None])            # (B, S)
    over = err > tol
    first = torch.where(over.any(-1), over.int().argmax(-1),
                        torch.full((B,), S, device=hk.device)).tolist()
    share = 1 - sum(first) / (B * S)
    print(f"{name}: on their own, each row's first prefill position past "
          f"{tol} of its largest final hidden entry {first} (of {S}; share "
          f"of positions from there on {share:.4f}); error at positions 0, "
          f"8, 32, 128: {[f'{float(err[:, i].max()):.1e}' for i in (0, 8, 32, 128) if i < S]}")
    return {"first_divergent_position": first, "share": share,
            "positions": B * S}


def _replay_held(name, worst, tol=LOGITS_RTOL):
    """A replayed run's outputs (``_Trajectory.worst``): every layer's and
    every sLSTM step's within ``tol`` of its own largest entry."""
    (e_layer, n_layer), (e_cell, n_cell) = worst["layers"], worst["cells"]
    print(f"{name}: each output from the other side's input, max|diff| / "
          f"max|own|: every layer's ({n_layer} calls, prefill and decode) "
          f"worst {e_layer:.3e}; every sLSTM step's new state ({n_cell} "
          f"steps) worst {e_cell:.3e} (tolerance {tol})")
    check(n_layer > 0 and e_layer <= tol and e_cell <= tol,
          f"{name}: a replayed layer or sLSTM step beyond {tol}")
    return {"layer_err": e_layer, "layers": n_layer, "cell_err": e_cell,
            "cells": n_cell}


def _zoo_compare(name, k_run, p_run, tol=LOGITS_RTOL, hidden_tol=None):
    """Two runs of one model (the second routed by the first's expert
    choices): the logits of every step and the final hidden states of
    every prefill position within ``tol`` (the hidden states within
    ``hidden_tol`` when given) of the second's largest."""
    hidden_tol = tol if hidden_tol is None else hidden_tol
    errs = []
    for lk, lp in zip(k_run["logits"], p_run["logits"]):
        check(bool(torch.isfinite(lk).all()), f"{name}: non-finite logits")
        errs.append(float((lk - lp).abs().max() / lp.abs().max()))
    hk, hp = k_run["hidden"], p_run["hidden"]
    h_err = float((hk - hp).abs().max() / hp.abs().max())
    print(f"{name}: logits max|diff| / max|ref| per step "
          f"{[f'{e:.3e}' for e in errs]} (tolerance {tol:.3e}); final "
          f"hidden, every position, {h_err:.3e} (tolerance "
          f"{hidden_tol:.3e})")
    check(all(e <= tol for e in errs) and h_err <= hidden_tol,
          f"{name}: beyond the tolerance")
    return {"logits_err": max(errs), "hidden_err": h_err}


def zoo_kernels_vs_plain():
    """Phase 42: flash at the zoo's shapes, the blocked plain attention and
    rms_norm at the zoo's widths against their plain versions; then ms per
    call of the new shapes beside the plain version, the library call and
    the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn
    phase("42 zoo kernels vs plain: flash at D 160, GQA 7 and mixtral's "
          "window; the blocked plain attention; rms_norm at the zoo's widths")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(42)
    err = {"rms_norm": 0.0, "flash_attention": 0.0,
           "flash_attention_d160": 0.0, "attention_blocked_ref": 0.0}
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for case in ZOO_ATTN_CASES:
            B, H, Hkv, Sq, Sk, D, causal, window, off = case
            q = torch.randn(B, H, Sq, D, generator=g, device=dev).to(dtype)
            k = torch.randn(B, Hkv, Sk, D, generator=g, device=dev).to(dtype)
            v = torch.randn(B, Hkv, Sk, D, generator=g, device=dev).to(dtype)
            kw = dict(causal=causal, window=window, q_offset=off)
            plain = ref.attention_blocked_ref if Sq * Sk > 2048 * 4096 \
                else ref.attention_ref
            ok, e = _allclose(fa.flash_attention(q, k, v, **kw),
                              plain(q, k, v, **kw), ATTN_TOL[dtype])
            check(ok, f"flash_attention {dtype} {case}: max err {e}")
            key = "flash_attention_d160" if D == 160 else "flash_attention"
            if dtype == torch.float32:
                err[key] = max(err[key], e)
                print(f"  flash_attention float32 {case}: max abs err "
                      f"{e:.3e}")
            n += 1
        for rows, d in ZOO_RMS:
            x = torch.randn(rows, d, generator=g, device=dev).to(dtype)
            r = torch.randn(rows, d, generator=g, device=dev).to(dtype)
            w = torch.randn(d, generator=g, device=dev)
            for res in (None, r):
                ok, e = _allclose(rn.rms_norm(x, w, res),
                                  ref.rms_norm_ref(x, w, res), RMS_TOL[dtype])
                check(ok, f"rms_norm {dtype} {rows}x{d}: max err {e}")
                if dtype == torch.float32:
                    err["rms_norm"] = max(err["rms_norm"], e)
                n += 1
    for case in BLOCKED_CASES:
        B, H, Hkv, Sq, Sk, D, causal, window, off = case
        q = torch.randn(B, H, Sq, D, generator=g, device=dev)
        k = torch.randn(B, Hkv, Sk, D, generator=g, device=dev)
        v = torch.randn(B, Hkv, Sk, D, generator=g, device=dev)
        kw = dict(causal=causal, window=window, q_offset=off)
        ok, e = _allclose(ref.attention_blocked_ref(q, k, v, **kw),
                          ref.attention_ref(q, k, v, **kw),
                          (BLOCKED_TOL, BLOCKED_TOL))
        check(ok, f"attention_blocked_ref {case}: max err {e}")
        err["attention_blocked_ref"] = max(err["attention_blocked_ref"], e)
        n += 1
    torch.cuda.synchronize()
    print(f"zoo cases {n} all within tolerance; float32 max abs err {err}")

    lines, rows = [], {}
    for r_, d in ZOO_RMS:
        x = torch.randn(r_, d, generator=g, device=dev)
        w = torch.randn(d, generator=g, device=dev)
        t_k = _time_ms(lambda: rn.rms_norm(x, w), 100)
        t_p = _time_ms(lambda: ref.rms_norm_ref(x, w), 100)
        t_l = _time_ms(lambda: F.rms_norm(x, (d,), w, 1e-6), 100)
        bound = (2 * r_ * d + d) * 4 / HBM_BYTES_PER_S * 1e3
        lines.append(f"rms_norm {r_}x{d}: kernel {t_k:.6f} ms plain "
                     f"{t_p:.6f} F.rms_norm {t_l:.6f} kernel/F.rms_norm "
                     f"{t_k / t_l:.3f} bound {bound:.6f} ({bound / t_k * 100:.1f}"
                     f" % of it per call)")
        rows[f"rms_norm_{d}"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                                     bound_ms=bound)

    def attn_row(name, B, H, Hkv, S, D, window, plain):
        q = torch.randn(B, H, S, D, generator=g, device=dev)
        k = torch.randn(B, Hkv, S, D, generator=g, device=dev)
        v = torch.randn(B, Hkv, S, D, generator=g, device=dev)
        kw = dict(causal=True, window=window)
        t_k = _time_ms(lambda: fa.flash_attention(q, k, v, **kw), 20, 3)
        t_p = _time_ms(lambda: plain(q, k, v, **kw), 3, 1)
        if window is None:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=True, enable_gqa=True)
        else:
            i = torch.arange(S, device=dev)
            m = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=m, enable_gqa=True)
        t_l = _time_ms(lib, 10, 2)
        d_k = _device_ms(lambda: fa.flash_attention(q, k, v, **kw),
                         "flash_attention_kernel", 10, kernels=1)
        h_k = _host_ms(lambda: fa.flash_attention(q, k, v, **kw), 100)
        # the pairs the masks allow: query i sees min(i + 1, window) keys
        pairs = sum(min(i + 1, window or S) for i in range(S))
        flops = 4 * B * H * D * pairs
        t_ops = 3 * flops / TF32_FLOP_PER_S
        t_bytes = (2 * B * H * S * D + 2 * B * Hkv * S * D) * 4 \
            / HBM_BYTES_PER_S
        bound = max(t_ops, t_bytes) * 1e3
        alone = d_k if d_k is not None else t_k
        lines.append(f"{name} B{B} H{H}/{Hkv} S{S} D{D} window {window}: "
                     f"kernel {t_k:.6f} ms (device "
                     f"{d_k if d_k is None else f'{d_k:.6f}'}, host "
                     f"{h_k:.6f}) plain {t_p:.6f} sdpa {t_l:.6f} kernel/sdpa "
                     f"{t_k / t_l:.3f} bound {bound:.6f} (operations, "
                     f"3xTF32; {bound / alone * 100:.1f} % of it alone)")
        rows[name] = dict(ms=t_k, device_ms=d_k, host_ms=h_k, plain_ms=t_p,
                          library_ms=t_l, bound_ms=bound,
                          bound_by="operations" if t_ops >= t_bytes
                          else "bytes",
                          shape=f"float32 B{B} H{H} Hkv{Hkv} S{S} D{D} causal"
                                + (f" window {window}" if window else ""))

    for name, B, H, Hkv, S, D, window in ZOO_TIMED:
        attn_row(name, B, H, Hkv, S, D, window,
                 ref.attention_ref if window is None
                 else ref.attention_blocked_ref)
    print("float32 ms per call (CUDA events over back-to-back calls; device "
          "= torch.profiler; host = host clock per call, no synchronise):")
    for line in lines:
        print("  " + line)
    return {"err": err, "rows": rows}


def zoo_main_path():
    """Phase 43: the zoo's main path, ``launch.serve lm --arch
    deepseek-v2-lite-16b`` at full width and depth."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    phase(f"43 serve (zoo main path): {ZOO_ARCH}, full width and depth")
    cfg = get_arch(ZOO_ARCH)
    c = ZOO_SERVE
    argv = ["lm", "--arch", ZOO_ARCH, "--batch", str(c["batch"]),
            "--prompt-len", str(c["prompt"]), "--device", "cuda"]
    serve.main(argv + ["--gen-len", "2"])       # warm-up: first-call set-up
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_lm_counts()
    torch.cuda.synchronize()
    out = serve.main(argv + ["--gen-len", str(c["gen"])])
    rms, flash = _lm_counts()
    peak = torch.cuda.max_memory_allocated()
    per_forward = _rms_per_forward(cfg)
    check(out["logits_finite"], f"{ZOO_ARCH}: non-finite logits")
    check(tuple(out["tokens"].shape) == (c["batch"], c["gen"]),
          f"{ZOO_ARCH}: tokens of shape {tuple(out['tokens'].shape)}")
    print(f"{ZOO_ARCH}: prefill {out['prefill_ms']:.3f} ms ({c['batch']} x "
          f"{c['prompt']} tokens), decode {out['decode_ms_per_token']:.3f} "
          f"ms/token ({c['gen'] - 1} steps of batch {c['batch']}); peak "
          f"max_memory_allocated {peak} B ({peak / 1e9:.3f} GB); launches "
          f"rms_norm {rms} (expected {per_forward} x {c['gen']} forwards), "
          f"flash_attention {flash} (expected 0: MLA attends with the plain "
          f"attention_ref, q.k 192 wide and v 128, as the JAX package does)")
    check(rms == per_forward * c["gen"] and flash == 0,
          f"{ZOO_ARCH}: launches rms_norm {rms}, flash_attention {flash}")
    return {"rms_norm": rms, "flash_attention": flash, "peak_bytes": peak,
            "prefill_ms": out["prefill_ms"],
            "decode_ms_per_token": out["decode_ms_per_token"]}


def _zoo_tokens(cfg, B, S, patches):
    """The prompt tokens, and the launcher's random inputs: ``patches``
    patch embeddings (seed 2), or the enc-dec model's S source frames
    (seed 1)."""
    from repro_torch.data.tokens import synthetic_lm_batch
    toks = torch.as_tensor(synthetic_lm_batch(0, B, S + 1, cfg.vocab)[
        "tokens"], dtype=torch.long, device="cuda")
    pe = None
    if patches or cfg.encdec:
        shape = (B, patches, cfg.d_frontend) if patches else \
            (B, S, cfg.d_frontend)
        pe = torch.randn(shape, device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(2 if patches else 1))
    return toks, pe


def _init_params(cfg, device="cuda"):
    from repro_torch.models.encdec import init_encdec
    from repro_torch.models.lm import init_lm
    return (init_encdec if cfg.encdec else init_lm)(cfg, seed=0,
                                                    device=device)


def _zoo_arch_vs_plain(arch_id, B, S, layers, patches):
    """One arch at full width (depth cut to ``layers`` when given): prefill
    and ZOO_STEPS decode steps with the kernels, then with the plain
    versions fed the same tokens; launches per prefill and decode step."""
    from repro_torch.configs import get_arch
    cfg = get_arch(arch_id)
    if layers is not None:
        cfg = cfg.with_(n_layers=layers)
    params = _init_params(cfg)
    n_params = sum(t.numel() for t in
                   torch.utils._pytree.tree_leaves(params))
    toks, pe = _zoo_tokens(cfg, B, S, patches)
    src = dict(patches=None, frames=pe) if cfg.encdec else \
        dict(patches=pe)
    plain = cfg.with_(use_kernels=False)
    # a model with sLSTM layers is compared layer by layer and step by
    # step (_Trajectory, _replay_held)
    replay = any(s.mixer == "slstm" for s in cfg.pattern) or None
    k_run = _zoo_serve(params, cfg, toks, steps=ZOO_STEPS, replay=replay,
                       **src)
    p_run = _zoo_serve(params, plain, toks, steps=ZOO_STEPS,
                       feed=k_run["tokens"],
                       forced=k_run["gates_prefill"] + k_run["gates_decode"],
                       replay=k_run.pop("trajectory", None), **src)
    share = {}
    if k_run["gates_prefill"] or replay:
        own = _zoo_serve(params, plain, toks, steps=ZOO_STEPS,
                         feed=k_run["tokens"], **src)
        if k_run["gates_prefill"]:
            share = _routing_share(f"{arch_id} kernels vs plain", k_run,
                                   own, B, patches + S)
        else:
            share = _divergence(f"{arch_id} kernels vs plain", k_run, own)
        del own
    n_rms, n_rms_dec = _rms_per_forward(cfg), _rms_per_forward(cfg, True)
    n_flash = _flash_per_prefill(cfg)
    check(k_run["counts"][0] == (n_rms, n_flash),
          f"{arch_id}: launches per prefill {k_run['counts'][0]}, expected "
          f"{(n_rms, n_flash)}")
    check(all(c == (n_rms_dec, 0) for c in k_run["counts"][1:]),
          f"{arch_id}: launches per decode step {k_run['counts'][1:]}")
    check(all(c == (0, 0) for c in p_run["counts"]),
          f"{arch_id}: the plain side launched {p_run['counts']}")
    how = "each layer and sLSTM step started from the kernels' inputs" \
        if replay else "routed by the kernels' choices"
    cmp = _zoo_compare(f"{arch_id} kernels vs plain (the plain side {how})",
                       k_run, p_run)
    if replay:
        cmp["replayed"] = _replay_held(f"{arch_id} kernels vs plain",
                                       p_run["trajectory_err"])
    print(f"{arch_id}{'' if layers is None else f' ({layers} layers)'}: "
          f"{n_params} params ({n_params * 4 / 1e9:.2f} GB), batch {B} x "
          f"{patches + S} positions: prefill {k_run['ms'][0]:.3f} ms "
          f"(plain {p_run['ms'][0]:.3f}), decode "
          f"{sum(k_run['ms'][1:]) / ZOO_STEPS:.3f} ms/step (plain "
          f"{sum(p_run['ms'][1:]) / ZOO_STEPS:.3f}); launches per prefill "
          f"rms_norm {n_rms} flash_attention {n_flash}, per decode step "
          f"rms_norm {n_rms_dec}")
    return params, cfg, toks, pe, {
        "prefill_ms": k_run["ms"][0], "plain_prefill_ms": p_run["ms"][0],
        "decode_ms": sum(k_run["ms"][1:]) / ZOO_STEPS,
        "launches_prefill": {"rms_norm": n_rms, "flash_attention": n_flash},
        "launches_decode": {"rms_norm": n_rms_dec, "flash_attention": 0},
        "launches": {"rms_norm": sum(c[0] for c in k_run["counts"]),
                     "flash_attention": sum(c[1] for c in k_run["counts"])},
        "n_params": n_params, "routing": share, **cmp}


def zoo_deepseek_vs_plain():
    """Phase 44: deepseek-v2-lite-16b's kernels vs plain at full width,
    and one prefill and one decode step under the profiler."""
    from repro_torch.train import make_decode_step
    phase(f"44 {ZOO_ARCH}: kernels vs plain versions on the card (full "
          f"width, batch {ZOO_SERVE['batch']} x {ZOO_SERVE['prompt']}, "
          f"{ZOO_STEPS} decode steps; the plain side routed by the kernels' "
          f"expert choices)")
    params, cfg, toks, _, res = _zoo_arch_vs_plain(
        ZOO_ARCH, ZOO_SERVE["batch"], ZOO_SERVE["prompt"], None, 0)
    from repro_torch.train import make_prefill_step
    prefill = make_prefill_step(cfg, toks.shape[0], toks.shape[1] + 2)
    logits, caches = prefill(params, {"tokens": toks})
    decode = make_decode_step(cfg)
    decode(params, caches, _greedy(logits), toks.shape[1])
    _profile_once("prefill:", lambda: prefill(params, {"tokens": toks}))
    _profile_once("decode step:", lambda: decode(
        params, caches, _greedy(logits), toks.shape[1]))
    del params, caches
    torch.cuda.empty_cache()
    return res


def zoo_other_archs():
    """Phase 45: the other five configs at full width, each against its
    plain versions."""
    phase("45 the other five at full width: stablelm-12b, qwen3-1.7b, "
          "minicpm-2b, internvl2-1b (256 patches + 768 tokens), "
          "mixtral-8x7b (8 of 32 layers, 1 x 8192, window 4096)")
    out = {}
    for arch_id, B, S, layers, patches in ZOO_OTHERS:
        t = time.perf_counter()
        params, *_, res = _zoo_arch_vs_plain(arch_id, B, S, layers, patches)
        del params
        torch.cuda.empty_cache()
        print(f"  {arch_id} seconds {time.perf_counter() - t:.1f}")
        out[arch_id] = res
    return out


def _arch_card_vs_cpu(arch_id, B, S, tcfg, node=False, exact=False):
    """One arch at smoke width, card vs CPU from the same CPU-made weights:
    prefill and ZOO_STEPS decode logits (float32 and bfloat16 caches, phase
    11's tolerances, the card routed by the CPU's expert choices, rows
    routed differently on their own set aside), then one training step
    (the backward kernels at the smoke head dims) and, with ``node``, one
    node-mode step (euler, symplectic), loss and params at 1e-5.  With
    ``exact``, float64 CPU runs (``repro_torch.float64.lifted``, routed by
    the CPU's choices) measure the CPU's float32 rounding, and a
    comparison whose CPU float32 result is itself more than half the
    tolerance from the float64 one is held to twice that distance (two
    float32 results each that far from exact): the float32-cache serving
    run's logits, final hidden states and cache tensors
    (``_float64_witness``), and each leaf of a step; the bfloat16 caches
    are then held to one ulp beyond the float32 caches' held card-vs-CPU
    difference per cache tensor (``_caches_within_ulp``'s slack)."""
    from torch.utils import _pytree as pytree
    from repro_torch.configs import get_smoke_arch
    from repro_torch.configs.base import NodeConfig
    from repro_torch.data.tokens import synthetic_lm_batch
    from repro_torch.float64 import lifted
    from repro_torch.train import init_train_state, make_train_step
    cfg = get_smoke_arch(arch_id)
    patches = 4 if cfg.frontend == "patch" else 0
    cpu = _init_params(cfg, device="cpu")
    gpu = pytree.tree_map(lambda t: t.to("cuda"), cpu)
    toks, pe = _zoo_tokens(cfg, B, S, patches)

    def src(dev, dtype=torch.float32):
        x = None if pe is None else pe.to(dev, dtype)
        return dict(patches=None, frames=x) if cfg.encdec else \
            dict(patches=x)

    res, gaps = {}, None
    for cache_dtype, rtol in SMOKE_RTOL.items():
        name = f"{arch_id} smoke, {cache_dtype} cache, card vs CPU"
        cpu_run = _zoo_serve(cpu, cfg, toks.cpu(), steps=ZOO_STEPS,
                             cache_dtype=cache_dtype, keep_caches=True,
                             **src("cpu"))
        gates = cpu_run["gates_prefill"] + cpu_run["gates_decode"]
        # the bfloat16 cache: the card decodes from the CPU's cache
        # contents, held to one ulp of it apart
        shared = None if cache_dtype != torch.bfloat16 else \
            _to_cuda(cpu_run["caches"])
        runs = {}
        for tag, forced in (("own", None), ("forced", gates or None)):
            if tag == "forced" and forced is None:
                runs[tag] = runs["own"]
                continue
            runs[tag] = _zoo_serve(
                gpu, cfg, toks, steps=ZOO_STEPS, feed=cpu_run["tokens"],
                forced=forced, cache_dtype=cache_dtype, caches_from=shared,
                keep_caches=True, **src("cuda"))
        ref_run = _to_cuda(cpu_run)
        tols = {}
        if exact and shared is None:     # the float32 caches
            with lifted():
                f64 = _zoo_serve(
                    pytree.tree_map(lambda t: t.double(), cpu), cfg,
                    toks.cpu(), steps=ZOO_STEPS, feed=cpu_run["tokens"],
                    forced=gates or None, cache_dtype=torch.float64,
                    keep_caches=True, **src("cpu", torch.float64))
            tols, gaps, res["float64"] = _float64_witness(
                name, runs["forced"], cpu_run, f64, rtol)
            del f64
        if shared is not None:     # after the prefill and each decode
            if cfg.encdec:         # the cross K/V the card computed
                _caches_within_ulp(f"{name}, the card's cross K/V",
                                   runs["forced"]["own_cross"],
                                   ref_run["caches"][0]["cross"], gaps)
            for i, (got, want) in enumerate(zip(runs["forced"]["caches"],
                                                ref_run["caches"])):
                _caches_within_ulp(f"{name}, cache {i}", got, want, gaps)
        res[str(cache_dtype)] = _zoo_compare(
            name, runs["forced"], ref_run, tols.get("logits", rtol),
            tols.get("hidden"))
        if gates:
            res[str(cache_dtype)]["routing"] = _routing_share(
                name, runs["own"], ref_run, B, patches + S, rtol)
    b = synthetic_lm_batch(0, B, S + 1, cfg.vocab)
    batch = {k: torch.as_tensor(v, dtype=torch.long) for k, v in b.items()}
    if pe is not None:
        batch["frames" if cfg.encdec else "patch_embeds"] = pe.cpu()
    modes = {"train": cfg}
    if node:
        modes["node_symplectic"] = cfg.with_(node=NodeConfig(
            mode="node", method="euler", grad_mode="symplectic"))
    for mode, mcfg in modes.items():
        steps = {}
        old = init_train_state(mcfg, tcfg, device="cpu").params
        for dev in ("cpu", "cuda"):
            state = init_train_state(mcfg, tcfg, device="cpu")
            if dev == "cuda":      # the generator's state stays on the CPU
                state = pytree.tree_map(
                    lambda t: t.to("cuda") if isinstance(t, torch.Tensor)
                    and t.dtype != torch.uint8 else t, state)
            forced = None if dev == "cpu" else steps["cpu"][2]
            with _Gates(forced) as gates:
                new, m = make_train_step(mcfg, tcfg)(
                    state, {k: v.to(dev) for k, v in batch.items()})
            steps[dev] = (new, m, [g.cpu() for g in gates.calls])
        l_err = abs(float(steps["cuda"][1]["loss"])
                    - float(steps["cpu"][1]["loss"])) \
            / abs(float(steps["cpu"][1]["loss"]))
        leaves = [pytree.tree_leaves(t) for t in (
            steps["cuda"][0].params, steps["cpu"][0].params, old,
            steps["cpu"][0].opt["m"])]
        errs = [_step_leaf_err(a.cpu(), b, o, m, tcfg)
                for a, b, o, m in zip(*leaves)]
        bounds = [1e-5] * len(errs)
        if exact:
            # the same weights (drawn outside: the float64 casts change
            # the draws), in float64
            state = pytree.tree_map(
                lambda t: t.double() if isinstance(t, torch.Tensor)
                and t.is_floating_point() else t,
                init_train_state(mcfg, tcfg, device="cpu"))
            with lifted(), _Gates(steps["cpu"][2]):
                ref, _ = make_train_step(mcfg, tcfg)(state, {
                    k: v.double() if v.is_floating_point() else v
                    for k, v in batch.items()})
            f32 = [_step_leaf_err(b, e, o, m, tcfg) for b, e, o, m in zip(
                leaves[1], pytree.tree_leaves(ref.params), leaves[2],
                leaves[3])]
            bounds = [max(1e-5, 2 * e) for e in f32]
            res.setdefault("float32_rounding", {})[mode] = max(f32)
        p_err = max(errs)
        worst = max(e / b for e, b in zip(errs, bounds))
        print(f"{arch_id} smoke {mode} step, card vs CPU (the card routed "
              f"by the CPU's choices): loss rel err {l_err:.3e}, params max "
              f"rel err {p_err:.3e} (tolerance 1e-5; AdamW eps 1e-3; a leaf "
              f"that starts at zero against lr max|g| / eps"
              + ("" if not exact else
                 f"; the CPU's float32 step from the float64 one, max "
                 f"{res['float32_rounding'][mode]:.3e}; leaves held past "
                 f"1e-5 by twice theirs: {sum(b > 1e-5 for b in bounds)} of "
                 f"{len(bounds)}; worst share of its bound {worst:.3f}")
              + ")")
        check(l_err <= 1e-5 and worst <= 1.0,
              f"{arch_id} smoke {mode} step: card vs CPU beyond the bound")
        res[mode] = {"loss_err": l_err, "params_err": p_err,
                     "share_of_bound": worst}
    return res


def _step_leaf_err(got, want, old, m_want, tcfg) -> float:
    """One leaf after a training step: max |got - want| over the largest
    entry of ``want``; for a leaf that was zero before the step (``old``:
    a bias of Mamba, the mLSTM, the sLSTM or a LayerNorm), whose new value
    is its first update alone, lr g / (|g| + eps) with |du/dg| <= lr / eps,
    over lr max|g| / eps (g = m / (1 - b1)): what a gradient within the
    tolerance of its largest entry can move it by (the float32 gradient's
    rounding, 1 / eps up, is otherwise the whole leaf's scale;
    ``tests/test_torch_zoo_rec_train.py``)."""
    scale = want.double().abs().max()
    if not bool(old.abs().max()):
        adamw = tcfg.adamw
        scale = tcfg.lr * m_want.double().abs().max() / (1 - adamw.b1) \
            / adamw.eps
    return float((got.double() - want.double()).abs().max()
                 / scale.clamp_min(1e-300))


def zoo_card_vs_cpu():
    """Phase 46: the six new archs at smoke width, card vs CPU from the
    same weights (``_arch_card_vs_cpu``)."""
    import dataclasses
    from repro_torch.train import TrainConfig
    phase("46 zoo card vs CPU (smoke width): serving and one training step "
          "per arch")
    tcfg = TrainConfig(adamw=dataclasses.replace(TrainConfig().adamw,
                                                 eps=1e-3))
    return {arch_id: _arch_card_vs_cpu(arch_id, 4, 32, tcfg)
            for arch_id in (ZOO_ARCH,) + tuple(a for a, *_ in ZOO_OTHERS)}


def _to_cuda(run):
    from torch.utils import _pytree as pytree
    return pytree.tree_map(lambda t: t.to("cuda")
                           if isinstance(t, torch.Tensor) else t, run)


def _caches_within_ulp(name, got, want, slack=None):
    """Every cache entry of ``got`` within one of its dtype's ulps of
    ``want``'s, beyond the float32 rounding of the values rounded: |a - b|
    <= eps |b| + 1e-5 max|b| per cache tensor (1e-5: the float32 cache's
    tolerance; an entry near 0 from a cancellation, RoPE's, carries the
    float32 difference of its larger terms, which is many of its own
    ulps).  ``slack`` (per cache tensor, of its largest entry) raises the
    1e-5 to the float32 caches' own card-vs-CPU difference where that is
    larger (measured by the caller on a float32-cache run)."""
    from torch.utils import _pytree as pytree
    worst = 0.0
    leaves = list(zip(pytree.tree_leaves(got), pytree.tree_leaves(want)))
    slack = slack or [1e-5] * len(leaves)
    for (a, b), r in zip(leaves, slack):
        a, b, eps = a.float(), b.float(), torch.finfo(a.dtype).eps
        bound = eps * b.abs() + max(r, 1e-5) * b.abs().max() + 1e-30
        worst = max(worst, float(((a - b).abs() / bound).max()))
    print(f"{name}: within {worst:.3f} of the "
          f"bound (one ulp + 1e-5 of the largest entry"
          + ("" if max(slack) <= 1e-5 else
             f", or the float32 caches' difference, up to "
             f"{max(slack):.3e}") + ")")
    check(worst <= 1.0, f"{name}: a cache entry {worst:.3f} of the bound "
                        f"apart")


def _float64_witness(name, card, cpu, f64, tol):
    """The float32 CPU serving run's rounding, from a float64 CPU run of the
    same weights and inputs (``repro_torch.float64.lifted``, fed the same
    tokens, routed by the same choices): the tolerances of the card-vs-CPU
    comparison, ``tol`` or twice the CPU's own distance from the float64
    run where that is larger (relative to the largest entry), for the
    logits (over the steps), the final hidden states and each cache tensor
    (over the steps); the float32 caches' card-vs-CPU differences are held
    to theirs here, and returned as the bfloat16 run's slack."""
    from torch.utils import _pytree as pytree

    def worst(a, b):
        return max(_rel_err(x.cpu(), y.cpu()) for x, y in zip(a, b))

    def per_tensor(run):       # each cache tensor's values over the steps
        return list(zip(*[pytree.tree_leaves(c) for c in run["caches"]]))
    rounding = {"logits": worst(cpu["logits"], f64["logits"]),
                "hidden": _rel_err(cpu["hidden"], f64["hidden"])}
    card_exact = {"logits": worst(card["logits"], f64["logits"]),
                  "hidden": _rel_err(card["hidden"].cpu(), f64["hidden"])}
    tols = {k: max(tol, 2 * e) for k, e in rounding.items()}
    c_round = [worst(a, b) for a, b in zip(per_tensor(cpu), per_tensor(f64))]
    gaps = [worst(a, b) for a, b in zip(per_tensor(card), per_tensor(cpu))]
    c_tols = [max(1e-5, 2 * e) for e in c_round]
    share = max(g / t for g, t in zip(gaps, c_tols))
    print(f"{name}: the CPU's float32 run from a float64 one (max|diff| / "
          f"max|float64|): logits {rounding['logits']:.3e}, final hidden "
          f"{rounding['hidden']:.3e}, cache tensors up to "
          f"{max(c_round):.3e}; the card's: logits "
          f"{card_exact['logits']:.3e}, final hidden "
          f"{card_exact['hidden']:.3e}; card vs CPU held to "
          f"{tols['logits']:.3e} (logits), {tols['hidden']:.3e} (hidden); "
          f"cache tensors card vs CPU up to {max(gaps):.3e}, worst share "
          f"of its bound (1e-5, or twice the CPU's rounding) {share:.3f}")
    check(share <= 1.0, f"{name}: a float32 cache tensor beyond its bound")
    return tols, gaps, {"cpu_rounding": rounding, "card_rounding":
                        card_exact, "cache_rounding": max(c_round),
                        "cache_gap": max(gaps), "cache_share": share}


def _zoo_child():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"kernels": _timed(zoo_kernels_vs_plain),
           "main": _timed(zoo_main_path),
           "deepseek": _timed(zoo_deepseek_vs_plain),
           "others": _timed(zoo_other_archs),
           "smoke": _timed(zoo_card_vs_cpu)}
    print(json.dumps(out, default=str))


def zoo_phase(ahead=None):
    """Phases 42-46 in their own process: started here, or ``ahead``
    (``(child, go)``: started earlier with ``_child_start(..., go=)``)."""
    t = time.perf_counter()
    out = _child_phase([ZOO_CHILD], "42-46", timeout=900) if ahead is None \
        else _child_go(*ahead, "42-46")
    print(f"phases 42-46 seconds {time.perf_counter() - t:.1f}")
    return out


def zoo_rows(zoo, rows):
    """The zoo's launches (phases 43 and 45) added to the ``rows`` of
    rms_norm and flash, each arch's path apart (deepseek's main path runs
    no flash: MLA attends with the plain version); returns the new row of
    flash at D 160 (stablelm-12b's prefill)."""
    paths = {f"serve_{ZOO_ARCH}": {"rms_norm": zoo["main"]["rms_norm"],
                                   "flash_attention": 0},
             **{f"serve_{a}": r["launches"]
                for a, r in zoo["others"].items()}}
    for row in rows:
        if row["name"] in ("rms_norm", "flash_attention"):
            for path, counts in paths.items():
                if row["name"] == "flash_attention" and \
                        path == "serve_stablelm-12b":
                    continue          # D 160: flash_attention_d160's row
                row["launches_by_path"][path] = counts[row["name"]]
            row["launches"] = sum(row["launches_by_path"].values())
    r = zoo["kernels"]["rows"]["flash_attention_d160"]
    launches = zoo["others"]["stablelm-12b"]["launches"]["flash_attention"]
    return [{"name": "flash_attention_d160", "route": "cuda",
             "source": "src/repro_torch/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention.py:94",
             "launches": launches,
             "launches_by_path": {"serve_stablelm-12b": launches},
             "max_abs_err": zoo["kernels"]["err"]["flash_attention_d160"],
             **r}]


# ---------------------------------------------------------------------------
# The LM zoo's recurrent and enc-dec half (phases 47-51), in a process of
# its own (``python3 chip_smoke.py --zoo2``): jamba's one 8-layer block
# holds 53.2 GB of float32 weights

ZOO2_CHILD = "--zoo2"
# (arch, layers or None for all): jamba cut to one 8-layer block of 32
# xlstm-1.3b to one 8-layer block of its 6, to keep the whole script
# inside its limit (its prefill is host-bound: ~136k launches whole; the
# script took 1121.4 s with 24 layers and phase 53 on one card: PERF.md
# §6)
ZOO2_ARCHS = [("jamba-v0.1-52b", 8), ("xlstm-1.3b", 8),
              ("seamless-m4t-medium", None)]
# flash at the enc-dec model's shapes (the encoder; cross-attention with
# Sq != Sk) and jamba's attention layer (GQA 4 at D 128)
ZOO2_ATTN_CASES = [
    (8, 16, 16, 1024, 1024, 64, False, None, 0),
    (8, 16, 16, 256, 1024, 64, False, None, 0),
    (8, 32, 8, 1024, 1024, 128, True, None, 0),
]
# the timed enc-dec shapes: (name, B, H, Sq, Sk, D), non-causal MHA
ZOO2_TIMED = [("flash_attention_encoder", 8, 16, 1024, 1024, 64),
              ("flash_attention_cross", 8, 16, 256, 1024, 64)]


def zoo2_flash():
    """Phase 47: flash at the enc-dec model's shapes and jamba's, against
    the plain version, the float32 error printed per case; then ms per call
    of the two enc-dec shapes beside the plain version, SDPA and the
    bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    phase("47 flash at the enc-dec shapes (non-causal, D 64, Sq 1024 and "
          "256 against Sk 1024) and jamba's (GQA 32/8, D 128), vs plain")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(47)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in ZOO2_ATTN_CASES:
            B, H, Hkv, Sq, Sk, D, causal, window, off = case
            q = torch.randn(B, H, Sq, D, generator=g, device=dev).to(dtype)
            k = torch.randn(B, Hkv, Sk, D, generator=g, device=dev).to(dtype)
            v = torch.randn(B, Hkv, Sk, D, generator=g, device=dev).to(dtype)
            kw = dict(causal=causal, window=window, q_offset=off)
            ok, e = _allclose(fa.flash_attention(q, k, v, **kw),
                              ref.attention_ref(q, k, v, **kw),
                              ATTN_TOL[dtype])
            check(ok, f"flash_attention {dtype} {case}: max err {e}")
            if dtype == torch.float32:
                errs[str(case)] = e
    torch.cuda.synchronize()
    for case, e in errs.items():
        print(f"  float32 max abs err {e:.3e} at (B, H, Hkv, Sq, Sk, D, "
              f"causal, window, q_offset) = {case} (ATTN_TOL "
              f"{ATTN_TOL[torch.float32]})")
    rows = {}
    for name, B, H, Sq, Sk, D in ZOO2_TIMED:
        q = torch.randn(B, H, Sq, D, generator=g, device=dev)
        k = torch.randn(B, H, Sk, D, generator=g, device=dev)
        v = torch.randn(B, H, Sk, D, generator=g, device=dev)
        kw = dict(causal=False)
        t_k = _time_ms(lambda: fa.flash_attention(q, k, v, **kw), 50, 5)
        t_p = _time_ms(lambda: ref.attention_ref(q, k, v, **kw), 10, 2)
        t_l = _time_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                       20, 3)
        d_k = _device_ms(lambda: fa.flash_attention(q, k, v, **kw),
                         "flash_attention_kernel", 20, kernels=1)
        h_k = _host_ms(lambda: fa.flash_attention(q, k, v, **kw), 200)
        flops = 4 * B * H * D * Sq * Sk
        t_ops = 3 * flops / TF32_FLOP_PER_S
        t_bytes = (2 * B * H * Sq * D + 2 * B * H * Sk * D) * 4 \
            / HBM_BYTES_PER_S
        bound = max(t_ops, t_bytes) * 1e3
        alone = d_k if d_k is not None else t_k
        print(f"  {name} B{B} H{H} Sq{Sq} Sk{Sk} D{D} non-causal: kernel "
              f"{t_k:.6f} ms (device "
              f"{d_k if d_k is None else f'{d_k:.6f}'}, host {h_k:.6f}) "
              f"plain {t_p:.6f} sdpa {t_l:.6f} kernel/sdpa {t_k / t_l:.3f} "
              f"bound {bound:.6f} ({'operations, 3xTF32' if t_ops >= t_bytes else 'bytes'}; "
              f"{bound / alone * 100:.1f} % of it alone)")
        rows[name] = dict(ms=t_k, device_ms=d_k, host_ms=h_k, plain_ms=t_p,
                          library_ms=t_l, bound_ms=bound,
                          bound_by="operations" if t_ops >= t_bytes
                          else "bytes",
                          shape=f"float32 B{B} H{H} Sq{Sq} Sk{Sk} D{D} "
                                f"non-causal")
    return {"err": errs, "rows": rows}


def _zoo2_arch(number, arch_id, layers):
    """Phases 48-50: one arch served at full width through ``launch.serve
    lm`` (depth cut to ``layers`` when given), batch 8 x 1024, 32 tokens:
    prefill ms, decode ms/token, ``max_memory_allocated``, the kernels'
    launches; then kernels vs plain (``_zoo_arch_vs_plain``, routing
    replayed), and one prefill and one decode step under the profiler
    (every launch counted)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.train import make_decode_step, make_prefill_step
    c = ZOO_SERVE
    cut = "" if layers is None else f", {layers} of its layers"
    phase(f"{number} {arch_id}: serve at full width{cut}, batch "
          f"{c['batch']} x {c['prompt']}, {c['gen']} tokens; kernels vs "
          f"plain; profile")
    cfg = get_arch(arch_id)
    argv = ["lm", "--arch", arch_id, "--batch", str(c["batch"]),
            "--prompt-len", str(c["prompt"]), "--device", "cuda"]
    if layers is not None:
        cfg = cfg.with_(n_layers=layers)
        argv += ["--layers", str(layers)]
    t = time.perf_counter()
    serve.main(argv + ["--gen-len", "2"])       # warm-up: first-call set-up
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_lm_counts()
    torch.cuda.synchronize()
    out = serve.main(argv + ["--gen-len", str(c["gen"])])
    rms, flash = _lm_counts()
    peak = torch.cuda.max_memory_allocated()
    want = (_rms_per_forward(cfg)
            + (c["gen"] - 1) * _rms_per_forward(cfg, decode=True),
            _flash_per_prefill(cfg))
    check(out["logits_finite"], f"{arch_id}: non-finite logits")
    check(tuple(out["tokens"].shape) == (c["batch"], c["gen"]),
          f"{arch_id}: tokens of shape {tuple(out['tokens'].shape)}")
    print(f"{arch_id}: prefill {out['prefill_ms']:.3f} ms ({c['batch']} x "
          f"{c['prompt']} tokens), decode {out['decode_ms_per_token']:.3f} "
          f"ms/token ({c['gen'] - 1} steps of batch {c['batch']}); peak "
          f"max_memory_allocated {peak} B ({peak / 1e9:.3f} GB); launches "
          f"rms_norm {rms} flash_attention {flash} (expected {want})")
    check((rms, flash) == want,
          f"{arch_id}: launches rms_norm {rms}, flash_attention {flash}")
    main = {"rms_norm": rms, "flash_attention": flash, "peak_bytes": peak,
            "prefill_ms": out["prefill_ms"],
            "decode_ms_per_token": out["decode_ms_per_token"]}
    del out
    torch.cuda.empty_cache()
    params, cfg, toks, src, res = _zoo_arch_vs_plain(
        arch_id, c["batch"], c["prompt"], layers, 0)
    batch = {"tokens": toks}
    if cfg.encdec:
        batch["frames"] = src
    prefill = make_prefill_step(cfg, toks.shape[0], toks.shape[1] + 2)
    decode = make_decode_step(cfg)
    logits, caches = prefill(params, batch)
    decode(params, caches, _greedy(logits), toks.shape[1])
    t_prof = time.perf_counter()
    prof = {"prefill": _profile_once("prefill:",
                                     lambda: prefill(params, batch), False),
            "decode": _profile_once("decode step:", lambda: decode(
                params, caches, _greedy(logits), toks.shape[1]), False)}
    print(f"  profiles seconds {time.perf_counter() - t_prof:.1f}")
    del params, caches, logits
    torch.cuda.empty_cache()
    print(f"  {arch_id} seconds {time.perf_counter() - t:.1f}")
    return {"main": main, "vs_plain": res, "profile": prof}


def zoo2_card_vs_cpu():
    """Phase 51: the three archs at smoke width, card vs CPU
    (``_arch_card_vs_cpu``), and xlstm-1.3b's node-mode step."""
    import dataclasses
    from repro_torch.train import TrainConfig
    phase("51 card vs CPU (smoke width): jamba, xlstm, seamless serving and "
          "one training step each; xlstm-1.3b's node-mode step (euler, "
          "symplectic)")
    tcfg = TrainConfig(adamw=dataclasses.replace(TrainConfig().adamw,
                                                 eps=1e-3))
    return {arch_id: _arch_card_vs_cpu(arch_id, 4, 32, tcfg,
                                  node=arch_id == "xlstm-1.3b", exact=True)
            for arch_id, _ in ZOO2_ARCHS}


def _zoo2_child():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"flash": _timed(zoo2_flash), "flash_bwd": _timed(zoo2_flash_bwd)}
    for number, (arch_id, layers) in zip((48, 49, 50), ZOO2_ARCHS):
        out[arch_id] = _timed(_zoo2_arch, number, arch_id, layers)
    out["smoke"] = _timed(zoo2_card_vs_cpu)
    print(json.dumps(out, default=str))


def zoo2_phase(ahead=None):
    """Phases 47-51 in their own process, as ``zoo_phase``."""
    t = time.perf_counter()
    out = _child_phase([ZOO2_CHILD], "47-51", timeout=600) if ahead is None \
        else _child_go(*ahead, "47-51")
    print(f"phases 47-51 seconds {time.perf_counter() - t:.1f}")
    return out


def zoo2_rows(zoo2, rows):
    """The launches of phases 48-50's serving runs added to the ``rows`` of
    rms_norm and flash, each arch's path apart, and the enc-dec shapes'
    times (phase 47) beside flash's row."""
    for row in rows:
        if row["name"] in ("rms_norm", "flash_attention"):
            for arch_id, _ in ZOO2_ARCHS:
                row["launches_by_path"][f"serve_{arch_id}"] = \
                    zoo2[arch_id]["main"][row["name"]]
            row["launches"] = sum(row["launches_by_path"].values())
        if row["name"] == "flash_attention":
            row["encdec_shapes"] = zoo2["flash"]["rows"]
            row["encdec_max_abs_err"] = zoo2["flash"]["err"]
        if row["name"] == "flash_attention_bwd":
            row["encdec_shapes"] = zoo2["flash_bwd"]["rows"]
            row["encdec_max_abs_err"] = zoo2["flash_bwd"]["max_abs_err"]


# ---------------------------------------------------------------------------
# Phase 55: bfloat16 training (TrainConfig(param_dtype="bfloat16"), the JAX
# package's dry-run setting) and training at head dim 160, in a process of
# its own (``python3 chip_smoke.py --train55``): stablelm-12b at full width
# holds ~30 GB of state at 4 of its 40 layers, and a step makes a new one

TRAIN55_CHILD = "--train55"
# (arch, layers or None for all, param dtype, modes); stablelm-12b cut to 4
# of 40 layers (the whole model's 12.1 B parameters do not fit one card)
TRAIN55_RUNS = (
    ("stablelm-12b", 4, "bfloat16", ("discrete", "node_symplectic")),
    ("stablelm-12b", 4, "float32", ("discrete", "node_symplectic")),
    ("qwen3-0.6b", None, "bfloat16", ("discrete",)),
)
# kernel route vs plain route on the card: (loss, grad_norm) relative
TRAIN55_RTOL = {"bfloat16": (4e-3, 1e-2), "float32": (1e-5, 1e-5)}
# what kernels/ops.py routes to on the plain route: none of it may run on
# the kernel route
TRAIN55_PLAIN = ("rms_norm_ref", "attention_ref", "attention_blocked_ref",
                 "butcher_combine_ref", "butcher_combine_rows_ref")
TRAIN55_TITLE = (
    "55 LM train in bfloat16 and at head dim 160 (batch 8 x 1024): "
    "stablelm-12b full width, 4 of 40 layers, bfloat16 and float32, one "
    "discrete and one node-symplectic (euler) step each; qwen3-0.6b whole "
    "in bfloat16, one discrete step; each against the plain route on the "
    "card")


class _PlainGuard:
    """Counts the calls of the plain versions in ``TRAIN55_PLAIN`` while
    it is entered (``kernels/ops.py`` reaches them through the module)."""

    def __enter__(self):
        from repro_torch.kernels import ref
        self.calls = dict.fromkeys(TRAIN55_PLAIN, 0)
        self.saved = {n: getattr(ref, n) for n in TRAIN55_PLAIN}
        for name, fn in self.saved.items():
            def counted(*args, _name=name, _fn=fn, **kw):
                self.calls[_name] += 1
                return _fn(*args, **kw)
            setattr(ref, name, counted)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ref
        for name, fn in self.saved.items():
            setattr(ref, name, fn)


def _train55_child():
    """Phase 55's runs (``TRAIN55_RUNS``): per run, the plain route's loss
    and gradient norm on the card (``use_kernels=False``; it also warms
    cuBLAS up for the step's shapes), then one train step on the kernel
    route from the same state, each kernel's counter zeroed just before it
    and read just after, the plain versions guarded; prints s/step, peak
    bytes and launches, and the runs as JSON on its last line."""
    import gc

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import NodeConfig
    from repro_torch.data.tokens import synthetic_lm_batch
    from repro_torch.optim.clip import global_norm
    from repro_torch.train import (TrainConfig, init_train_state,
                                   loss_and_grads, make_train_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for arch_id, layers, dt, modes in TRAIN55_RUNS:
        base = get_arch(arch_id)
        if layers is not None:
            base = base.with_(n_layers=layers)
        tcfg = TrainConfig(param_dtype=dt)
        state = init_train_state(base, tcfg, device="cuda")
        b = synthetic_lm_batch(55, TRAIN_BATCH, TRAIN_SEQ + 1, base.vocab)
        batch = {k: torch.as_tensor(v, dtype=torch.long, device="cuda")
                 for k, v in b.items()}
        for mode in modes:
            arch = base if mode == "discrete" else base.with_(
                node=NodeConfig(mode="node", method="euler",
                                grad_mode="symplectic"))
            run = f"{arch_id}_{dt}_{mode}"
            t = time.perf_counter()
            loss_p, grads = loss_and_grads(state.params, batch,
                                           arch.with_(use_kernels=False))
            gn_p, loss_p = float(global_norm(grads)), float(loss_p)
            plain_s = time.perf_counter() - t
            del grads
            gc.collect()
            torch.cuda.empty_cache()
            step = make_train_step(arch, tcfg)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero_all_counts()
            with _PlainGuard() as guard:
                t = time.perf_counter()
                new, m = step(state, batch)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t
            counts = _all_counts()
            peak = torch.cuda.max_memory_allocated()
            loss, gn = float(m["loss"]), float(m["grad_norm"])
            del new, m, step
            gc.collect()
            torch.cuda.empty_cache()
            e_loss = abs(loss - loss_p) / abs(loss_p)
            e_gn = abs(gn - gn_p) / abs(gn_p)
            print(f"  {run}: s/step {secs:.4f} (plain route's loss+gradient "
                  f"{plain_s:.4f} s), peak {peak} B ({peak / 2**30:.2f} "
                  f"GiB), loss {loss} (plain {loss_p}, rel {e_loss:.3e}), "
                  f"grad_norm {gn} (plain {gn_p}, rel {e_gn:.3e}), launches "
                  f"{counts}", flush=True)
            need = ["rms_norm", "flash_attention", "rms_norm_bwd",
                    "flash_attention_bwd"] + (
                        ["butcher_combine"] if mode != "discrete" else [])
            for name in need:
                check(counts[name] > 0, f"phase 55 {run}: {name} never "
                                        f"launched")
            check(not any(guard.calls.values()),
                  f"phase 55 {run}: the kernel route ran plain versions "
                  f"{guard.calls}")
            check(math.isfinite(loss) and math.isfinite(gn),
                  f"phase 55 {run}: loss {loss}, grad_norm {gn}")
            r_loss, r_gn = TRAIN55_RTOL[dt]
            check(e_loss <= r_loss and e_gn <= r_gn,
                  f"phase 55 {run}: kernel vs plain route, loss rel "
                  f"{e_loss} (bound {r_loss}), grad_norm rel {e_gn} (bound "
                  f"{r_gn})")
            out[run] = {"counts": counts, "step_seconds": secs,
                        "plain_seconds": plain_s, "peak": peak,
                        "loss": loss, "grad_norm": gn, "plain_loss": loss_p,
                        "plain_grad_norm": gn_p, "loss_rel": e_loss,
                        "grad_norm_rel": e_gn}
        del state, batch
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def train55_phase(ahead=None):
    """Phase 55 in its own process: started here, or ``ahead`` (``(child,
    go)``, as ``zoo_phase``)."""
    phase(TRAIN55_TITLE)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    out = _child_phase([TRAIN55_CHILD], 55, timeout=600) if ahead is None \
        else _child_go(*ahead, 55)
    print(f"phase 55 seconds {time.perf_counter() - t:.1f}")
    return out


def train55_rows(t55, bwd_err, bwd_main, rows):
    """Phase 55's launches: added to the ``rows`` of the kernels each run
    reaches in the variant the row stands for (forward rms_norm in every
    run, flash at D 128 in qwen3's and at D 160 in stablelm's, the float32
    rms_norm_bwd in stablelm's float32 runs, the combine in the node
    runs); returns the new rows of the backward variants, with phase 31's
    errors and times."""
    def paths(kernel, keep):
        return {f"lm_train_{run}": r["counts"][kernel]
                for run, r in t55.items() if keep(run)}

    def qwen(run):
        return run.startswith("qwen3")

    def stablelm(dt):
        return lambda run: run.startswith("stablelm") and dt in run

    add = {"rms_norm": paths("rms_norm", lambda run: True),
           "flash_attention": paths("flash_attention", qwen),
           "flash_attention_d160": paths(
               "flash_attention", lambda run: not qwen(run)),
           "rms_norm_bwd": paths("rms_norm_bwd",
                                 lambda run: "float32" in run),
           "butcher_combine": paths("butcher_combine",
                                    lambda run: "node" in run)}
    for row in rows:
        if row["name"] in add:
            row["launches_by_path"].update(add[row["name"]])
            row["launches"] = sum(row["launches_by_path"].values())
    flash = ("src/repro_torch/csrc/flash_attention_bwd.cu",
             "src/repro/kernels/flash_attention.py:94")
    new = {"flash_attention_bwd_bf16": (
               flash, paths("flash_attention_bwd", qwen)),
           "flash_attention_bwd_bf16_d160": (
               flash, paths("flash_attention_bwd", stablelm("bfloat16"))),
           "flash_attention_bwd_d160": (
               flash, paths("flash_attention_bwd", stablelm("float32"))),
           "rms_norm_bwd_bf16": (
               ("src/repro_torch/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:39"),
               paths("rms_norm_bwd", lambda run: "bfloat16" in run))}
    out = []
    for name, ((source, replaces), by_path) in new.items():
        check(sum(by_path.values()) > 0, f"{name}: never launched on phase "
                                         f"55's path")
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": sum(by_path.values()),
                    "launches_by_path": by_path,
                    "max_abs_err": bwd_err[name], **bwd_main[name]})
    return out


def lm_train_rows(train, bwd_err, bwd_main):
    """The kernels line's rows of the backward kernels: launches from
    phase 32 (both modes), the rest from phase 31."""
    rows = []
    srcs = {"rms_norm_bwd": ("src/repro_torch/csrc/rmsnorm.cu",
                             "src/repro/kernels/rmsnorm.py:39"),
            "flash_attention_bwd": (
                "src/repro_torch/csrc/flash_attention_bwd.cu",
                "src/repro/kernels/flash_attention.py:94")}
    for name in ("rms_norm_bwd", "flash_attention_bwd"):
        by_path = {mode: r["counts"][name] for mode, r in train.items()}
        rows.append({"name": name, "route": "cuda", "source": srcs[name][0],
                     "replaces": srcs[name][1],
                     "launches": sum(by_path.values()),
                     "launches_by_path": by_path,
                     "max_abs_err": bwd_err[name], **bwd_main[name]})
    return rows


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
    lm_err = lm_kernels_vs_plain()
    lm_launches = serve_main_path()
    params = serve_vs_plain()
    serve_card_vs_cpu()
    rows += lm_report(lm_err, lm_launches)
    profile_serve(params)
    del params
    ps = per_sample_main_path()
    per_sample_exactness()
    ps_mem = per_sample_memory()
    rows += lane_report(max_err, ps)
    per_sample_profile()
    table1()
    baselines_exactness()
    base_launches = baselines_main_path()
    per_sample_adjoint_memory(ps_mem)
    phys = physics_main_path()
    cells = saveat_cells()
    saveat_exactness()
    saveat_memory()
    path = cnf_flow_path_phase()
    serve_ode = serve_ode_main_path()
    serve_exactness()
    serve_shape = serve_report(serve_ode["drain"])
    t_train = time.perf_counter()
    bwd_err, bwd_main = _timed(backward_kernels_vs_plain)
    train = _timed(lm_train_main_path)
    side = side_phases_start()
    _timed(lm_exactness)
    peaks = _timed(lm_memory)
    ckpt = _timed(lm_resume)
    side = side_phases_finish(side)
    mesh_gloo, audit = side[38], side[41]
    _timed(lm_train_to_serve, ckpt)
    print(f"phases 31-36 (38 and 41 beside 33-35) seconds "
          f"{time.perf_counter() - t_train:.1f}")
    t_mesh = time.perf_counter()
    mesh_solve = _timed(mesh_solve_phase)
    mesh_engine = _timed(mesh_engine_phase, serve_ode)
    mesh_train = _timed(mesh_train_phase, train, peaks)
    mesh_tp = _timed(mesh_tp_phase)
    zoo_tp = _timed(zoo_tp_phase)
    # the processes of phases 42-46 and 47-51 start now and wait for their
    # turn: their start-up overlaps phase 54's single-process runs
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        ahead = [(_child_start([argv], limit + 600, go), go)
                 for argv, limit, go in (
                     (ZOO_CHILD, 900, os.path.join(d, "go_zoo")),
                     (ZOO2_CHILD, 600, os.path.join(d, "go_zoo2")),
                     (TRAIN55_CHILD, 600, os.path.join(d, "go_55")))]
        rec_tp = rec_tp_phase()
        print(f"phases 37, 39, 40, 52, 53, 54 seconds "
              f"{time.perf_counter() - t_mesh:.1f}")
        torch.cuda.empty_cache()
        zoo = zoo_phase(ahead[0])
        torch.cuda.empty_cache()
        zoo2 = zoo2_phase(ahead[1])
        print(f"main process: {torch.cuda.memory_allocated()} B allocated "
              f"before phase 55")
        t55 = _timed(train55_phase, ahead[2])

    def summed(results, kinds, name):
        return sum(r[name] for (mode, kind), r in results.items()
                   if kind in kinds)

    # the combines' launches, each path counted from 0 around its run: the
    # CNF main path (phase 3), the baselines trainers (phase 21), the
    # physics trainer (phase 23), the SaveAt cells (phase 24) and the CNF
    # flow path (phase 27), and the ODE server (phase 28, the lane forms
    # only); single-trajectory and lane forms apart
    for row in rows[:2]:
        name = row["name"]
        by_path = {"train": row["launches"],
                   "baselines_train": base_launches[name],
                   "physics_train": phys[name],
                   "saveat_cells": summed(cells, ("fixed", "adaptive"),
                                          name),
                   "cnf_flow_path": path["fixed"][name]}
        row["launches_by_path"] = by_path
        row["launches"] = sum(by_path.values())
    for row in rows[4:6]:
        name = row["name"][:-len("_lanes")]
        by_path = {"per_sample_train": row["launches"],
                   "saveat_cells_per_sample": summed(cells, ("per_sample",),
                                                     name),
                   "cnf_flow_path_per_sample": path["per_sample"][name],
                   "serve_ode": serve_ode["drain"][name]}
        row["launches_by_path"] = by_path
        row["launches"] = sum(by_path.values())
    for row, at_serve in zip(rows[4:6], serve_shape):
        row["serve_shape"] = at_serve
    # the LM kernels' forward launches: the serving path (phase 9) and the
    # training path (phase 32, both modes); the backward kernels' rows
    for row in rows[2:4]:
        name = row["name"]
        by_path = {"serve": row["launches"],
                   **{f"lm_train_{mode}": r["counts"][name]
                      for mode, r in train.items()}}
        row["launches_by_path"] = by_path
        row["launches"] = sum(by_path.values())
    for row in rows[:2]:
        row["launches_by_path"]["lm_train_node_symplectic"] = \
            train["node_symplectic"]["counts"][row["name"]]
        row["launches"] = sum(row["launches_by_path"].values())
    rows += lm_train_rows(train, bwd_err, bwd_main)
    # the mesh phases: the lane forms of the sharded solve (37, and 38's two
    # ranks) and of the meshed engine (39); the LM kernels of the
    # data-parallel run (40)
    for row in rows[4:6]:
        name = row["name"][:-len("_lanes")]
        k = 0 if name == "butcher_combine" else 1
        row["launches_by_path"].update({
            "mesh_solve": mesh_solve["launches"][name],
            "mesh_gloo": sum(r[c]["launches"][k]
                             for r in mesh_gloo.values()
                             for c in ("adaptive", "fixed")),
            "serve_ode_mesh": mesh_engine["mesh"][name]})
        row["launches"] = sum(row["launches_by_path"].values())
    for row in rows:
        if row["name"] in ("rms_norm", "flash_attention", "rms_norm_bwd",
                           "flash_attention_bwd"):
            row["launches_by_path"]["lm_train_dp"] = \
                mesh_train["counts"][row["name"]]
            row["launches_by_path"]["lm_train_dp_mb2_int8"] = \
                mesh_train["mb2_int8"]["counts"][row["name"]]
            row["launches"] = sum(row["launches_by_path"].values())
    # phase 52: both ranks' launches, both modes
    for row in rows:
        if row["name"] in TP_KERNELS:
            row["launches_by_path"]["lm_train_tp"] = sum(
                r[m]["counts"][row["name"]] for r in mesh_tp.values()
                for m in ("discrete", "node_symplectic"))
            row["launches"] = sum(row["launches_by_path"].values())
    # phase 53: both ranks' launches, every run of both archs
    for row in rows:
        if row["name"] in TP_KERNELS:
            row["launches_by_path"]["lm_train_tp_zoo"] = sum(
                res["counts"][row["name"]] for r in zoo_tp["ranks"]
                for runs in r.values() for res in runs.values())
            row["launches"] = sum(row["launches_by_path"].values())
    # phase 54: both ranks' launches, every run of the three archs
    for row in rows:
        if row["name"] in TP_KERNELS:
            row["launches_by_path"]["lm_train_tp_rec"] = sum(
                res["counts"][row["name"]] for r in rec_tp["ranks"]
                for runs in r.values() for res in runs.values())
            row["launches"] = sum(row["launches_by_path"].values())
    # the auditor (phase 41): both combines, single-trajectory and lane
    # forms together (one counter per kernel)
    for row in rows[:2]:
        row["launches_by_path"]["analysis"] = audit["launches"][row["name"]]
        row["launches"] = sum(row["launches_by_path"].values())
    rows += zoo_rows(zoo, rows)
    zoo2_rows(zoo2, rows)
    rows += train55_rows(t55, bwd_err, bwd_main, rows)
    print(f"total_seconds {time.perf_counter() - t0:.1f}")
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    os.chdir(ROOT)
    if os.environ.get(GO_ENV):      # started ahead of its phase: torch
        _await_file(os.environ.pop(GO_ENV), timeout=1200)   # is imported
    if sys.argv[1:] == [LM_TRAIN_CHILD]:
        _lm_train_child()
    elif sys.argv[1:] == [BWD_TIMES_CHILD]:
        _bwd_device_times_child()
    elif sys.argv[1:] == [ZOO_CHILD]:
        _zoo_child()
    elif sys.argv[1:] == [ZOO2_CHILD]:
        _zoo2_child()
    elif sys.argv[1:] == [TRAIN55_CHILD]:
        _train55_child()
    elif sys.argv[1:2] == [ZOO_TP_CHILD]:
        _zoo_tp_child(*sys.argv[2:])
    elif sys.argv[1:2] == [REC_TP_CHILD]:
        _rec_tp_child(*sys.argv[2:])
    elif sys.argv[1:2] == [MESH_CHILD]:
        which, rest = sys.argv[2], sys.argv[3:]
        if which == "38" and rest:
            _mesh_gloo_rank(int(rest[0]), int(rest[1]))
        elif which == "52" and len(rest) == 3:
            _tp_rank(int(rest[0]), rest[1], rest[2])
        else:
            {"37": _mesh_solve_child, "38": _mesh_gloo_child,
             "39": _mesh_engine_child, "40": _mesh_train_child,
             "41": _analysis_child, "52": _tp_child}[which](*rest)
    else:
        main()
