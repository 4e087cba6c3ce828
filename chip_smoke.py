#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (scso_tpu_torch) end to end on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA H100 (the
kernels are built for sm_90a). It never falls back to the CPU: without
a CUDA device, or outside a checkout, it exits non-zero and prints no
result. Every solve runs in the solver's default fused mode — replays
of the solve captured into a CUDA graph, its CG and Armijo loops
conditional nodes — unless a phase says otherwise; the presolve or a
warm-up with the timed chain's options makes each capture, so that the
timed chains replay it. Phases, each fatal on failure:

  1. The card (name and power limit from nvidia-smi); build the CUDA
     kernels from ``scso_tpu_torch/csrc`` and print the build seconds.
  2. Each kernel against its plain PyTorch version on the card, in
     float32 and float64, at the main-path and narrow shapes (K1, K1
     with A's bfloat16 copy and w, v in the working type, K2 in its ggn
     and its newton flavour, also normalized by another row count, K2s,
     and K1s under a one-rank
     NCCL group: bitwise K1, with A in bfloat16 too, and its
     overlapped form with 2 and 3 column chunks against the plain
     version), at block-boundary shapes (with n % 8 != 0: a bfloat16
     row that is not 16-byte aligned), at n above K1's shared-memory
     form (also with A in bfloat16),
     at odd n for K3, on both sides of its form gates (one block, one
     cluster of the card's largest size, the grid form) and at slice
     edges of its cluster (every slice full, a short last
     one, empty trailing blocks), also
     with NaN and ±inf in d and with a NaN η (non-finite where the plain
     version's outputs are, equal elsewhere), for K5
     at the multinomial bench shape (where its limit must also reject
     a one-TF32-product version of either contraction, emulated in
     PyTorch), at boundary shapes (both of its forms and both sides of
     each limit) and at k = 1, 17, 128, 129 and 200, and for K4 at the
     L-BFGS path's shape and at other n and m (up to 4100 slots) with
     empty, partial, full and wrapped memories and a slot with yᵀs = 0,
     on both sides of its shared-memory residency limit and of
     SMEM_BYTES, each also launched with S and Y streamed, q in the
     output and α, ρ in the scratch (the same bits),
     and for K2 and K2s on both sides of their one-pass form's n limit
     and at fewer rows than blocks; K2 (both flavours) and K2s with
     LSQ_GLM and POISSON_GLM, each kind computed in the kernel (its
     launches counted under the kind, never the split form), at the
     main shape, 262144×4096, 524288×1024 and those boundary shapes, A
     in float32, float64 and bfloat16; the split forms of K2, K2s (a
     user-built least-squares spec of kind "least_squares" and a
     kind=None logistic spec) and K5 (a squared-loss and a kind=None
     multinomial spec) at a few shapes; K2 (both
     flavours), K2s and K5 also with A in bfloat16 (y and the other
     operands in float32 or float64) at each of their shapes and forms;
     two runs of a kernel must give bitwise-equal outputs. Times (CUDA events around
     runs of back-to-back calls, the median of 5 runs' per-call time)
     of each kernel beside its plain version at its path's full-width
     shape, with the rate over A's bytes of those that stream A (K1,
     K1 with A in bfloat16, K1s, K2 in both flavours and K2s also at
     524288×1024 beside their bounds, K2 also in its split form; the lsq
     kind's rows at 262144×4096, the poisson kind's at the main shape),
     and of one 40 KB NCCL all-reduce. K3 (at n = 10112, 2²⁰ and 2²⁴)
     and K4 (at (n, m) = (10112, 10), (100000, 10) and (10112, 100))
     also get the device time alone (``graph_ms``: a CUDA graph of 20
     calls replayed between events) and the host time a call
     (``host_ms``: the enqueue rate over 100 calls), beside an empty
     kernel's launch measured the same three ways (one block, and one
     cluster of 16), the floor a launch sets; and K3's device time in
     each form (one block, clusters of 8 and 16, the grid) at n from
     1024 to 2²⁴ (``k3_sweep``), the sweep its gates come from.
  3. The sparse-logistic path at full width: 196608×10000 (padded to
     10112), seed 7, float32 on the card, solved by the JAX bench's
     ProxGGNSCORE(solver='cg', cg_maxiter=100) with A in float32
     throughout (auto_lp=False, F32_CG; phase 11 runs the bfloat16
     copy) and the pseudo-Huber l1 smoother — a presolve chain fixes
     x*, then a timed chain from x0 must reach the 1e-6 objective gap
     with K1, K2 and K3 launched (counted on the card under replay).
     Then the captured chain against its eager form (the private
     ``capture=False``: the same bodies with a host read a predicate),
     in turns c, e, e, c, c, e (`capture_turns`): the same epochs and
     CG iterations, x and every objective history bitwise; each one's
     best seconds, the capture's seconds and nodes, the replays and
     host reads a solve. And the chain in timed mode (the JAX package's
     `_solve_python`, its uncached step): one time a record, times
     non-decreasing, the final objective within E2E_RTOL of the fused
     chain's.
  4. Cross-checks: the same timed chain with kernels='torch' must agree
     on the final objective, and a small float64 solve through the
     kernels must match the plain path on the CPU.
  5. The multinomial path at full width (the JAX bench's
     family_multinomial(big=True)): 196608×1024×16, seed 11, float32,
     λ = 1e-3, the same method (A in float32: auto_lp=False) and
     protocol — K5 and K3 launched, K1
     and K2 not; the kernels='torch' chain must agree on the final
     objective, the captured chain is the eager one bitwise (as in
     phase 3), K5's form and time at that shape are printed beside its
     plain version's and its two-pass and split forms', and a small
     float64 multinomial solve through the kernels must match the plain
     path on the CPU.
  6. The L-BFGS path (ProxLQNSCORE(m=10), the default method, with the
     closed-form gradient) on phase 3's data, from x0 for a fixed 300
     epochs, with kernels and with kernels='torch': K4 and K3 launched
     and no other kernel, the two objective histories within 1e-5
     relative, the gap to phase 3's anchor printed, the captured run
     the eager one bitwise (as in phase 3); small float64
     L-BFGS solves (m = 10 and 100) through the kernels must match the
     CPU plain path.
  7. The uncached GGN-CG path (ProxGGNSCORE(solver='cg', cg_maxiter=100,
     epoch_cache=False)) on phase 3's data under phase 3's protocol to
     the 1e-6 gap: K2s, K1 and K3 launched, K2, K4 and K5 not; the
     kernels='torch' chain must agree on the final objective, the
     captured chain is the eager one bitwise (as in phase 3), and a
     small float64 uncached solve through the kernels must match the
     CPU plain path.
  8. The row-sharded cached GGN-CG path. (a) `shard_problem` of phase
     3's problem over the one-rank NCCL mesh under phase 3's protocol:
     the same epochs, CG iterations and final objective, bitwise, with
     K1s, K1, K2 and K3 launched as often as K1, K2 and K3 in phase 3.
     The one-rank solve captures its NCCL all-reduces into the graph.
     (b) Two ranks on the one card over gloo (NCCL refuses two ranks on
     one card; gloo reduces CUDA tensors through the host, which a
     capture refuses, so these ranks run timed mode, a row shard's
     public mode: the cached step, uncaptured): the parent
     writes 2×32768×10000 rows (seed 7) with
     `save_problem_data` to a temporary directory, two worker processes
     of this script load their rows with `load_problem_rows_sharded`
     and solve to the 1e-6 gap with comm_overlap_chunks 1 and 2; each
     final objective within E2E_RTOL of the parent's unsharded chain,
     x bitwise equal on both ranks, and the small float64 two-rank
     solve of every method (`small_sharded_cases`: cached and uncached
     GGN-CG, L-BFGS with BB and with Armijo, Newton-CG, dense Newton,
     the dense dual and primal GGN systems, multinomial cached and
     uncached, mini-batches, a test set off the cache) matching the
     CPU's plain unsharded solve (fused, a record every epoch; fvaltest
     too) to 1e-9, x bitwise equal on both ranks. Its seconds are
     not a scaling number.
  9. Phase 3's chain at the JAX bench's secondary shape, 524288×1024
     (seed 7, f32; where the JAX package's plain f32 tile sums stalled
     at a 1.7e-6 gap): it must reach the 1e-6 gap with K1, K2 and K3,
     agree with its kernels='torch' chain on the final objective, and
     its captured chain is the eager one bitwise (as in phase 3).
 10. Phase 3's problem with kind=None in its GLM spec (a user-built
     GLMSpec) under kernels='auto', phase 3's protocol: K1, K2 (in its
     split form) and K3 launched; the chain reaches the gap and agrees
     with its kernels='torch' chain.
 11. Precision-adaptive CG: phase 3's and phase 9's problems (anchored
     at their x*, no second presolve) and a smaller one (LP_SMALL_SHAPE,
     presolved here), each solved under phase 3's protocol in turns
     with A in float32 and with auto_lp=True (a bfloat16 copy of A for
     the bulk epochs, A for the endgame): f32, lp, lp, f32. Each lp
     chain must reach the gap with K1 launched on the copy and on A,
     its final objective within E2E_RTOL of phase 3's (9's) chain; the
     seconds, epochs and CG iterations of both arms are printed, with
     whether the copy won and whether AUTO (auto_lp=None) attaches it
     at that size. Then a small float64 solve with the copy,
     cg_adaptive=True and cg_lp_tol=1e-2 through the kernels must match
     the CPU plain path on the same copy.
 12. The Newton-CG path: ProxNSCORE(solver='cg', cg_maxiter=100) on
     phase 3's problem under phase 3's protocol, with its own presolve
     anchor, (a) with greedy damping off (NEWTON_GREEDY_OFF: at λ = 0.01
     the full greedy Newton step diverges on this data, in the JAX
     package as here, PERF.md), (b) with greedy AUTO (on) at λ =
     NEWTON_GREEDY_LAM: K1, K2 in its newton flavour (in the kernel, not
     its split form) and K3 launched, no other kernel; each
     kernels='torch' chain must agree on the final objective. (c) One
     60-epoch solve from x0 in phase 3's own configuration (λ = 0.01,
     greedy AUTO) with each kernels mode: the two must turn non-finite
     at the same record (or end at the same objective), their records
     printed. Then small float64 solves
     through the kernels against the CPU plain path: cached Newton-CG,
     uncached (ss_type 3), Newton-CG on a multinomial problem (K5), and
     on the JAX bench's family_logreg_100x50 problem the dense Newton
     solve (hess_fx) and the dense dual and primal GGN solves.
 13. iterate_mixed (a coarse solve with A itself cast to bfloat16 to a
     1e-3 gap, then the float32 finish; the chain's options for the
     fine phase), under phase 3's protocol with the fine phase chained
     on to the gap: (a) on phase 3's anchored problem, in turns with
     phase 3's f32 chain and phase 11's lp chain (f32, lp, mixed, mixed,
     lp, f32): K2 and K1 with A in bfloat16 at least once a coarse
     epoch and a coarse CG iteration, the final objective within
     E2E_RTOL of phase 3's; (b) on phase 5's problem, in turns with its
     f32 chain: K5 with A in bfloat16, the objective within E2E_RTOL of
     phase 5's; (c) the cached multinomial chain with auto_lp=True (K5 on
     the bfloat16 copy in the bulk epochs) against the f32 chain, in
     turns (f32, lp, lp, f32, five times), at 196608×1024×16 and
     49152×1024×16: whether the copy won (medians) sets AUTO's
     multi-output threshold; (d) small float64 iterate_mixed solves
     through the kernels against the CPU plain path: cached and
     uncached GGN-CG, Newton-CG, L-BFGS and multinomial. Each chain's
     seconds, epochs (coarse and fine), CG iterations, launches and the
     products of the bfloat16 A outside the kernels are printed.

 14. The sparse-group-lasso λ₂ path at full width (bench.py's
     family_gl_path(big=True)): 262144×4000 (seed 1234, groups of 16,
     p_active 0.1, noise 0.1, float32) padded to 4096 with a zero-weight
     pad group — A 4.29 GB on the card —, LSQ_GLM, λ = [1e-8, λ₂] for λ₂
     in logspace(-1, -4, 8), PHuberSmootherGL(1e-2), the 'gl' prox,
     F32_CG; per point a presolve of at most 6 chunks from the previous
     point's x, then timed chunks at f_tol=1e-6 until the signed gap is
     at most 1e-6. Worst gap ≤ 1.05e-6, with K1 and K2 (its lsq kind in
     the kernel) launched and no other kernel (the 'gl' prox's tail is
     not K3's); the kernels='torch' timed chains from the same points
     agree on each point's final objective. Small float64 group-lasso
     solves (512×128: cached and uncached GGN-CG, iterate_mixed of
     both) through the kernels match the CPU.
 15. The Poisson l1 path at the main path's shape:
     make_sparse_poisson_data(196608, 10000) (density 0.05, 64 active,
     seed 7, float32, padded to 10112), POISSON_GLM with its hooks,
     PHuberSmootherL1L2(1.0), F32_CG, phase 3's protocol at λ = 0.01 (λ
     = 1e-3 where x* is all zero or the chain takes fewer than 5
     epochs): the 1e-6 gap with K1, K2 (its poisson kind in the kernel)
     and K3; the kernels='torch' chain agrees on the final objective.
     Small float64 Poisson solves (examples/07_poisson.py's 2000×192:
     cached and uncached GGN-CG, Newton-CG and iterate_mixed of each)
     through the kernels match the CPU.

 16. Mini-batches at full width: phase 3's problem with batch_size 50000
     (three full batches and a partial one of 46608 rows), shuffled
     (rng_seed 7), 6 epochs: K2s, K1 and K3 in every batch step, K2
     never; the objective below x0's; the captured solve the eager one
     bitwise, and timed mode (the same host-drawn permutations) the
     fused one bitwise; unshuffled, the kernels and kernels='torch'
     solves agree on the final objective. One batch's gather (an
     index_select into the reused buffer) is timed beside an epoch.
 17. Problems without data: example 04's box QP at n = 8192 (float32,
     ProxNSCORE's Newton-CG on the jvp of the closed-form gradient,
     'indbox', the three box smoothers): x in the box, K3; example 01's
     Rosenbrock (float64, ProxLQNSCORE(m=10)): x within ROSENBROCK_ATOL
     of [1, 1] and the CPU's x to 1e-9, K4 and K3; and phase 3's problem
     with the out_fn hooks and no GLM spec for 6 epochs (the generic
     GGN-CG branch, J by jvp and vjp): K3 and no K1 or K2. Each captured
     solve the eager one bitwise.
 18. Metrics, a test set (32768 rows, seed 8) and resume on phase 3's
     problem: an 8-epoch solve saved with save_state to a .npz, loaded
     with load_state and resumed to the 1e-6 gap — x and every history
     (fvaltest and the test-MSE metric included) bitwise the
     uninterrupted solve's, in fused mode (the resume replaying the
     graph it has: no capture) and in timed mode; then the chain with
     static_precond (with_col_sumsq) to the gap, and one chunk with
     curvature_rows=65536 (which stalls short of the gap, in the JAX
     package's semantics too): K2s, K1 and K3, each within E2E_RTOL of
     its kernels='torch' solve.
 19. iterate_continuation on phase 3's problem (μ over [16, 4, 1], λ
     over [0.04, 0.02, 0.01], stage_epochs 6) against the direct solve:
     the same float32 fixed point (x to 1e-6), at most one capture for
     the non-final stages,
     the captured homotopy the eager one bitwise; each stage's epochs,
     seconds and captures.
 20. the λ sweep of bench.py's family_sweep(big=True): 4096 instances of
     the logistic01 problem at 2048×128 f32 (seed 7), λ = logspace(−3,
     −0.5), ProxNSCORE(solver='cg', ss_type=3), max_epoch 60,
     stats_every 4, x_tol 1e-6, as one batched solve (kernels='torch'
     by design: every product of the batch one cuBLAS product, A read
     once for all instances; no K1–K5 launch, the counters checked), one
     captured graph replayed once a solve: the throughput plan, and the
     quality plan followed by the x0_grid polish — seconds, solves/s,
     the converged share, mean epochs, the capture's seconds and nodes,
     and plan='auto''s pick (the same on a second call: the latency it
     weighs is measured once a process) beside the rule's estimate of
     a wave's epoch and the epoch the throughput plan took; eight
     instances spread over the grid against the scalar fused solve at
     their λ (the final objective within E2E_RTOL where both converged),
     the eager form the captured one bit for bit, every result tensor on
     the card; and, reported only, the spread of the objectives when the
     same instances are solved 1024 at a time (float32 products of
     another batch width round differently).
 21. federated_solve on examples/09_federated.py's problem (1024×32
     f64, ProxNSCORE(solver='dense', ss_type=3), 8 clients, 8 rounds of
     4 local epochs, f_tol 1e-8): each round's centralized objective
     against the CPU's to 1e-9 (SMALL_RTOL), the local epochs equal,
     one capture serving every round; rounds, objectives, seconds (the
     capture included).
 22. Every single-instance method on a row shard, captured: phase 5's
     multinomial, phase 6's L-BFGS (300 epochs), phase 7's uncached
     GGN-CG, phase 12's Newton-CG (greedy off), phase 16's mini-batches
     and phase 18's test set with f(x) off the epoch cache, each one
     solve at its phase's full shape on the problem sharded over phase
     8(a)'s one-rank NCCL mesh, against its unsharded fused solve: the
     same epochs, CG iterations, x and every history bit for bit, the
     same kernel launches (K1s once for each K1), the all-reduces inside
     the replayed graph (the host issues fewer than the capturing run;
     more graph nodes than unsharded); seconds of each.
 23. Meshes of two axes. (a) On phase 8(a)'s one NCCL rank: a 16-λ
     sweep (np.logspace(-3, -1, 16), the throughput plan, max_epoch 60,
     cached GGN-CG) of phase 3's problem row-sharded on a 1×1
     ('batch', 'data') mesh against the same sweep on no mesh, bit for
     bit (x, objectives, epochs); and phase 3's cached chain on the
     problem feature-sharded on a 1×1 ('data', 'model') mesh under
     phase 3's protocol: its final objective within E2E_RTOL of phase
     3's, its launches (the column shard takes the products route: K3
     alone launches) and seconds. (b) Four gloo ranks on the one card
     (``--mesh-worker``; gloo cannot be captured, so the sweeps run
     their bodies eagerly on the card and the solves in timed mode):
     float64 sweeps (throughput, two path waves, a fleet, federated
     rounds, mini-batches) on a 2×2 ('batch', 'data') mesh and
     feature-sharded solves (cached and uncached GGN-CG, Newton-CG,
     L-BFGS, multinomial, a test set) on a 2×2 ('data', 'model') mesh,
     each within 1e-9 (SMALL_RTOL) of the same on the CPU unsharded,
     every rank holding the same results bit for bit.
 24. The utilities (after dropping the earlier captures, as phase 23).
     (d) The native generator (`scso_tpu_torch._native`, g++ at first
     use; it must load) at MAIN_SHAPE with seed SEED + 1, its seconds
     against numpy's for the same call. (a) `make_serving_fn` on phase
     3's problem and options (the chain's solve: CHUNK_KW, L = 1):
     call 1 serves phase 3's data and captures, giving `iterate`'s bits
     on it; call 2 serves (d)'s fresh data with no new capture and gives
     `iterate`'s bits on a problem built from that data (padded as
     make_problem pads it). Each call's seconds and K1/K2/K3 launches
     (the exported artifact is phase 25's). (c) `sanitize(nans=True)`: a small float32
     cached solve completes with the fused solve's bits, its K1, K2 and
     K3 outputs checked; a loss that returns NaN raises
     FloatingPointError naming the op. (e) Each example of
     examples/torch once on the card (its seconds), in this process:
     after phase 12's dense solves, example 04's dense solve must still
     capture (C14). (b) Last, since a
     process that has run the profiler replays graphs slower:
     `profile_solve` of phase 3's solve (timed mode, eager): its Chrome
     trace holds K1, K2s and K3 by name exactly as often as their
     launch counters say (timed mode runs GGN-CG off the epoch cache,
     as in the JAX package: K2s, not K2), and `device_memory_stats()`.
 25. The exported solver and a fused solve over gloo (after dropping
     the earlier captures). (a) `export_solver` of phase 3's solve (its
     problem and options, cached GGN-CG at full width): a
     ``torch.export`` program whose loops are ``while_loop`` and
     ``cond`` and whose K1–K5 are the custom ops ``torch.ops.scso.*``,
     loaded in this process (`load_solver`) and run twice on phase 3's
     data: `iterate`'s epochs and x (bit for bit, else within
     EXPORT_RTOL, reported); the seconds of the export, the load and
     each solve, the artifact's bytes, beside phase 24's served call;
     then once on 24(a)'s fresh data (the padding, diag(AᵀA) and the
     epoch cache at x0 derived from it): `iterate`'s bits on that data.
     The op library is built in a thread from phase 1 on
     (`start_ops_build`); its seconds, and those phase 25 waited.
     (b) A profiler trace of the loaded solve holds K1, K2 and K3 by
     name as often as `iterate`'s counters launched them. (c) A process
     that imports torch and numpy alone (no PYTHONPATH, run from a
     directory that holds nothing of the repo) loads 4096×500 artifacts
     of the cached GGN-CG and the L-BFGS solve (K4), each with the op
     library it carries, solves, and gives this process's bits; it
     fails if scso_tpu_torch was imported. (d) Each custom op (K1 with A
     in float32, float64 and bfloat16; K2 in both flavours and K2s for
     logistic01, lsq, poisson and the split form; K3; K4; K5 in its
     tensor-core, two-pass and split forms and with A in bfloat16)
     against its plain version (phase 2's tolerances) and against the
     ctypes launch of the same kernel: the same bits; and the host time
     a call of K3 and of K4 takes through each route. (e) Phase 22's
     uncached solve on phase 3's problem sharded over a one-rank gloo
     group (a ``file://`` rendezvous), fused: gloo reduces CUDA tensors
     through the host, so the fused program runs uncaptured, with no
     capture, and gives phase 22's one-NCCL-rank bits, K1s, K1, K2s and
     K3 launched.
     The whole run's seconds are printed at its end.

The last two lines of standard output are one JSON object with each
kernel's numbers, then ``{"ok": true, "device": {...}}`` (K1 with A in
bfloat16 is its own row, ``normal_matvec_bf16``: its launches are
phase 11's lp chains' and 13's; so is K2's newton flavour,
``glm_prep_pair_newton``, with phase 12's launches, and K2, its newton
flavour, K2s and K5 with A in bfloat16, the ``_bf16`` rows, with phase
13's; K2 and K2s computing the lsq and poisson kinds, ``KIND_ROWS`` and
their ``_bf16`` rows, with phase 14's and 15's, the small solves'
included, timed at their paths' shapes). Each kernel's ``bound_ms`` is the larger of the bytes it must
move (each input read once, each output written once) over 3.35 TB/s
and its multiply-adds over A (or the vectors) at 67 TFLOP/s — K5 with
A in bfloat16, on the tensor cores, at 495 TFLOP/s (TF32) — the H100
SXM data sheet's rates, at the shape it was timed; ``library_ms`` is
null: no single PyTorch call computes any of these functions. The K3
and K4 rows add ``device_ms`` and ``host_ms`` (``graph_ms`` and
``host_ms`` at the ``ms`` row's shape).
Tolerances (stated with each comparison below): float32 rtol 2e-5 and
atol 3e-5·max(1, max|ref|); K5 in float32 atol TOL["k5"]·max|ref|
alone, with no floor of 1, so that it holds the tensor-core form's
split TF32 to float32 accuracy; float64 rtol 1e-12 and atol
1e-12·max(1, max|ref|).
"""

from __future__ import annotations

import io
import json
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import zipfile
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))

SEED = 7
CHUNK = 60            # epochs per solve in a chain (as bench.py)
GAP = 1e-6
MAIN_SHAPE = (196608, 10000)
NARROW_SHAPE = (524288, 1024)
# tests/test_pallas.py's block-boundary shapes, then ragged n (rows not
# 16-byte aligned: the kernels' one-value-per-load path)
BOUNDARY_SHAPES = [(37, 128), (947, 384), (2249, 1920), (131, 128),
                   (660, 256), (3465, 2432), (999, 1001), (64, 130)]
# K2/K2s form boundaries (csrc/glm_prep.cuh): the last n of the one-pass
# form and the first past it — K2 14336 f32 / 7168 f64, K2s 28672 f32 /
# 14336 f64 — and fewer rows than blocks (m = 1, 5), in both dtypes
PREP_SHAPES = [(1, 256), (5, 1001), (1031, 14336), (1031, 14340),
               (517, 7168), (517, 7170), (301, 28672), (301, 28676),
               (517, 14336), (517, 14338),
               # K2's cluster form with A in bfloat16 (float32): 16-row
               # groups to n = 2320, clusters of 1 block to 3584, of 2 to
               # 7168 (prep_case's float32 rows), of 3 to 10752, of 4 to
               # 14336 (above), rows not 16-byte aligned
               (1031, 2320), (1031, 2328), (1031, 3584), (1031, 3592),
               (517, 7176), (517, 10752), (517, 10760), (517, 10753)]
# K3 at odd n; phase 2 adds both sides of each of its form gates and
# slice edges (k3_boundary_cases)
K3_NS = [7, 129, 1000, 8192, 8320, 9001, 16384, 23456, 131072]
K3_REGS = ["l1", "l2", "indbox", "none"]
# K3 timed (per call, device, host) at the main path's n and at 2²⁰ and
# 2²⁴; its forms swept at K3_SWEEP_NS, from 1024 to 2²⁴ (the gates of
# ops/cuda/score_update.py come from that sweep)
K3_TIMED_NS = (10112, 1 << 20, 1 << 24)
K3_SWEEP_NS = (1024, 4096, 10112, 16384, 32768, 65536, 1 << 18, 1 << 19,
               1 << 20, 1 << 22, 1 << 24)
WIDE_SHAPES = [(4099, 40000, "float32"), (2049, 20000, "float64")]
MGLM_SHAPE = (196608, 1024, 16)
# tests/test_multioutput.py's kernel and odd shapes, the widest p of
# K5's tensor-core form (f32, k <= 16, p <= 1024) and the first past it
# (its two-pass form), then k = 1, 17 and 128 at odd m and p; the
# tensor-core form on both sides of its k and p limits, of its paddings
# (p 128/256/512, k 8) and with rows that are not 16-byte aligned
# (p % 4 != 0); k = 129 and 200
MGLM_SHAPES = [(512, 128, 8), (700, 256, 4), (130, 128, 3), (16, 1, 2),
               (33, 5, 7), (8, 12, 2), (64, 4, 11), (3001, 1024, 16),
               (3001, 1025, 9), (1031, 77, 1), (1031, 77, 17),
               (1031, 77, 128), (3001, 1024, 17), (1031, 1020, 16),
               (1031, 1022, 16), (999, 132, 9), (999, 256, 8),
               (999, 260, 16), (999, 512, 5), (999, 516, 12),
               (1031, 77, 129), (1031, 77, 200)]
TOL = {"float32": (2e-5, 3e-5), "float64": (1e-12, 1e-12),
       "k5": (0.0, 3e-5)}  # K5 in float32: over max|ref|, no floor
# K2/K2s's split form (specs the kernels do not compute themselves) and
# K5's (m, p, k)
PREP_SPLIT_SHAPES = [(5, 1001), (1031, 14340), (301, 28676)]
MGLM_SPLIT_SHAPES = [(1031, 77, 3), (3001, 1024, 16), (517, 100, 200)]
E2E_RTOL = 5e-6       # final objective, kernels vs plain, float32
SMALL_RTOL = 1e-9     # small float64 solve, card kernels vs CPU plain
LBFGS_EPOCHS = 300
LBFGS_RTOL = 1e-5     # L-BFGS objective histories, kernels vs plain, f32
# K4 cases: (n, m, pairs pushed); the first is the L-BFGS path's shape;
# memories past 64 slots (α and ρ in shared memory), and one past its
# 32 KB budget (the wrapper's scratch)
TWO_LOOP_CASES = [(10112, 10, 10), (10112, 10, 0), (361, 5, 3),
                  (777, 9, 18), (100000, 10, 13), (64, 1, 4),
                  (777, 65, 70), (361, 100, 103), (2000, 200, 130),
                  (64, 4100, 4103), (10112, 100, 103)]
# K4 timed (per call, device, host): the L-BFGS path's shape, a wider n
# and a larger memory; phase 2 adds both sides of its shared-memory
# residency limit and of SMEM_BYTES (two_loop_boundary_cases)
TWO_LOOP_TIMED = ((10112, 10), (100000, 10), (10112, 100))
TWO_RANK_ROWS = 32768  # rows of each rank in phase 8(b)
# the GGN-CG method of phases 3, 5, 7-10 and 13 (and chip_profile.py,
# chip_sharded.py): the JAX bench's ProxGGNSCORE(solver='cg',
# cg_maxiter=100) with A in float32 throughout; phases 11 and 13(c) run
# it with the bfloat16 copy (auto_lp=True), which AUTO attaches on the
# card from iterate._AUTO_LP_MIN_BYTES (_MGLM for the multinomial) on
F32_CG = dict(solver="cg", cg_maxiter=100, auto_lp=False)
# phase 11's third, smaller shape, for AUTO's byte threshold (the bench
# shapes are the other two)
LP_SMALL_SHAPE = (32768, 10000)
# phase 14: bench.py's family_gl_path(big=True) — 262144×4000 (padded to
# 4096 with the zero-weight pad group), groups of 16, an 8-point λ₂ path
GL_DATA = (262144, 4000)
GL_SHAPE = (262144, 4096)
GL_GROUP = 16
GL_PATH = 8
GL_KW = dict(x_tol=1e-8, max_epoch=60, verbose=0, alpha=1.0, stats_every=4)
GL_GAP_LIMIT = 1.05e-6   # bench.py's worst_gap gate
# phase 15: the Poisson l1 path at the main path's shape, λ = 0.01, else
# (x* all zero, or a chain of fewer than 5 epochs) λ = 1e-3
POISSON_LAMS = (0.01, 1e-3)
HBM_BYTES_S = 3.35e12  # H100 SXM data sheet: HBM3 rate
FP32_FLOP_S = 67e12    # H100 SXM data sheet: FP32 outside the tensor cores
BF16_FLOP_S = 989e12   # H100 SXM data sheet: bfloat16 on the tensor cores

KERNELS = {
    "normal_matvec": ("scso_tpu_torch/csrc/matvec.cu",
                      "scso_tpu/ops/pallas/matvec.py:118"),
    # K1's variant for A stored in bfloat16 (the TPU kernel compiles the
    # same function for a bf16 A)
    "normal_matvec_bf16": ("scso_tpu_torch/csrc/matvec.cu",
                           "scso_tpu/ops/pallas/matvec.py:118"),
    "normal_matvec_sharded": ("scso_tpu_torch/ops/cuda/matvec.py",
                              "scso_tpu/ops/pallas/matvec.py:196"),
    "glm_prep_pair": ("scso_tpu_torch/csrc/glm_prep.cu",
                      "scso_tpu/ops/pallas/glm_prep.py:239"),
    # K2 in the newton flavour (ProxNSCORE's epoch cache: the TPU kernel
    # traces the spec's gres and hvp_w instead)
    "glm_prep_pair_newton": ("scso_tpu_torch/csrc/glm_prep.cu",
                             "scso_tpu/ops/pallas/glm_prep.py:239"),
    "glm_prep": ("scso_tpu_torch/csrc/glm_prep.cu",
                 "scso_tpu/ops/pallas/glm_prep.py:84"),
    "score_update": ("scso_tpu_torch/csrc/score_update.cu",
                     "scso_tpu/ops/pallas/score_update.py:108"),
    "mglm_matvec": ("scso_tpu_torch/csrc/mglm_matvec.cu",
                    "scso_tpu/ops/pallas/mglm_matvec.py:152"),
    "two_loop": ("scso_tpu_torch/csrc/two_loop.cu",
                 "scso_tpu/ops/pallas/two_loop.py:69"),
    # K2, its newton flavour, K2s and K5 with A in bfloat16 (the TPU
    # kernels compile the same functions for a bf16 A and upcast each
    # tile): iterate_mixed's coarse phase, K5 also the cached mglm lp copy
    "glm_prep_pair_bf16": ("scso_tpu_torch/csrc/glm_prep_bf16.cu",
                           "scso_tpu/ops/pallas/glm_prep.py:239"),
    "glm_prep_pair_newton_bf16": ("scso_tpu_torch/csrc/glm_prep_bf16.cu",
                                  "scso_tpu/ops/pallas/glm_prep.py:239"),
    "glm_prep_bf16": ("scso_tpu_torch/csrc/glm_prep_bf16.cu",
                      "scso_tpu/ops/pallas/glm_prep.py:84"),
    "mglm_matvec_bf16": ("scso_tpu_torch/csrc/mglm_matvec.cu",
                         "scso_tpu/ops/pallas/mglm_matvec.py:152"),
}
# K2 (both flavours) and K2s computing the least-squares and the Poisson
# GLM in the kernel (the TPU kernels trace LSQ_GLM's and POISSON_GLM's
# forms): row → (the kernel's row, kind, flavour). Each is timed at its
# path's shape: lsq at GL_SHAPE (phase 14), poisson at the main shape
# (phase 15); its launches are its path's, and the small float64 solves'
# (K2s; K2's newton flavour; A in bfloat16: iterate_mixed's coarse phase)
KIND_ROWS = {
    "glm_prep_pair_lsq": ("glm_prep_pair", "lsq", "ggn"),
    "glm_prep_pair_poisson": ("glm_prep_pair", "poisson", "ggn"),
    "glm_prep_pair_newton_poisson": ("glm_prep_pair_newton", "poisson",
                                     "newton"),
    "glm_prep_lsq": ("glm_prep", "lsq", "ggn"),
    "glm_prep_poisson": ("glm_prep", "poisson", "ggn"),
}
for _row, (_base, _, _) in list(KIND_ROWS.items()):
    KERNELS[_row] = KERNELS[_base]
    KERNELS[f"{_row}_bf16"] = KERNELS[f"{_base}_bf16"]
# the rows of KERNELS that are the kernel of another row with A in
# bfloat16
BF16_OF = {"normal_matvec_bf16": "normal_matvec",
           "glm_prep_pair_bf16": "glm_prep_pair",
           "glm_prep_pair_newton_bf16": "glm_prep_pair_newton",
           "glm_prep_bf16": "glm_prep", "mglm_matvec_bf16": "mglm_matvec"}
LOGISTIC_KERNELS = ("normal_matvec", "glm_prep_pair", "score_update")
MGLM_KERNELS = ("mglm_matvec", "score_update")
LBFGS_KERNELS = ("two_loop", "score_update")
UNCACHED_KERNELS = ("glm_prep", "normal_matvec", "score_update")
SHARDED_KERNELS = ("normal_matvec_sharded", "normal_matvec", "glm_prep_pair",
                   "score_update")
NEWTON_KERNELS = ("normal_matvec", "glm_prep_pair_newton", "score_update")
# phase 14 (the 'gl' prox keeps its tail out of K3, in both packages) and
# phase 15
GL_KERNELS = ("normal_matvec", "glm_prep_pair", "glm_prep_pair_lsq")
POISSON_KERNELS = LOGISTIC_KERNELS + ("glm_prep_pair_poisson",)
# phase 12: the Newton-CG method; on phase 3's data at λ = 0.01 the
# greedy trial's full Newton steps run away to NaN, as the JAX package's
# do (chain (c) holds both modes to the same records), so chain (a)
# keeps phase 3's λ with greedy off and chain (b) runs greedy AUTO at
# the smallest λ probed on the card where it converges
NEWTON_CG = dict(solver="cg", cg_maxiter=100)
NEWTON_GREEDY_OFF = dict(NEWTON_CG, greedy_alpha=False)
NEWTON_GREEDY_LAM = 0.03


def fail(msg: str):
    print(f"{os.path.basename(sys.argv[0])} FAILED: {msg}", file=sys.stderr,
          flush=True)
    sys.exit(1)


def log(msg: str):
    if msg.startswith("phase "):
        msg += f" [{time.perf_counter() - T_START:.1f} s into the run]"
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def limit_of(want, tol):
    """(rtol, atol) of TOL[tol] against the reference ``want``: atol is
    TOL's factor times max|ref|, floored at 1 except for K5's."""
    rtol, atol_rel = TOL[tol]
    top = float(want.abs().max()) if want.numel() else 1.0
    return rtol, atol_rel * (top if tol == "k5" else max(1.0, top))


def compare(name, got, want, tol, check=True):
    """Max abs error; fails past rtol·|ref| + atol (``limit_of``), or,
    with ``check`` False, returns whether it is past it."""
    import torch

    rtol, atol = limit_of(want, tol)
    got, want = got.double(), want.double()
    err = (got - want).abs()
    past = bool((err > rtol * want.abs() + atol).any())
    if not check:
        return past
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite kernel output")
    if past:
        fail(f"{name}: max abs err {float(err.max()):.3e} exceeds "
             f"rtol {rtol:g} + atol {atol:.3e} ({tol})")
    return float(err.max()) if err.numel() else 0.0


def same_bits(name, a, b):
    import torch

    for i, (u, v) in enumerate(zip(a, b)):
        if not torch.equal(u, v):
            fail(f"{name}: rerun output {i} differs bitwise")


def time_ms(fn, reps=5, run_ms=20.0, calls=None):
    """ms a call: the median over ``reps`` runs of back-to-back calls
    between two CUDA events, after a warm-up; a run holds as many calls
    (1 to 50) as fill about ``run_ms``, or ``calls`` where given. A
    collective needs ``calls``: every rank must make as many calls, and
    a count from each rank's own clock differs between ranks."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    end.synchronize()
    if calls is None:
        calls = max(1, min(50, int(run_ms / max(start.elapsed_time(end),
                                                1e-3))))
    times = []
    for _ in range(reps):
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def graph_ms(fn, calls=20, reps=5):
    """Device time a call alone: a CUDA graph of ``calls`` calls, captured
    after a warm-up on a side stream, replayed between two CUDA events;
    the median over ``reps`` replays."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def host_ms(fn, calls=100, reps=5):
    """Host time a call: the enqueue rate, the host clock around
    ``calls`` calls with no synchronisation among them; the median over
    ``reps`` runs."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / calls)
    torch.cuda.synchronize()
    return statistics.median(times)


def three_times(fn):
    """(per call, device, host) ms of ``fn``: time_ms, graph_ms,
    host_ms."""
    return time_ms(fn), graph_ms(fn), host_ms(fn)


def launch_floor():
    """three_times of an empty kernel's launch: one block, and one
    cluster of 16 blocks through cudaLaunchKernelEx."""
    import torch

    from scso_tpu_torch.ops.cuda import launch

    dev = torch.device("cuda", torch.cuda.current_device())
    return {"one block": three_times(lambda: launch.empty_launch(dev)),
            "cluster of 16": three_times(
                lambda: launch.empty_launch(dev, 16, 16))}


def data_kernel_case(m, n, dtype, gen, mesh, timed=False):
    """K1, K1s (on the one-rank ``mesh``), K2 and K2s against their
    plain versions on random data (m, n); K1 and K1s also with A's
    bfloat16 copy (w and v in ``dtype``)."""
    import torch

    from scso_tpu_torch._src.struct import replace
    from scso_tpu_torch.models.losses import LOGISTIC01_GLM
    from scso_tpu_torch.ops.cuda.glm_prep import (
        glm_prep, glm_prep_pair, glm_prep_pair_torch, glm_prep_torch)
    from scso_tpu_torch.ops.cuda.matvec import (
        normal_matvec, normal_matvec_sharded, normal_matvec_sharded_torch,
        normal_matvec_torch)

    dev = "cuda"
    dn = str(dtype).replace("torch.", "")
    A = torch.randn((m, n), generator=gen, device=dev, dtype=dtype)
    A.mul_(0.1)
    w = torch.rand((m,), generator=gen, device=dev, dtype=dtype) / m
    v = torch.randn((n,), generator=gen, device=dev, dtype=dtype)
    y = (torch.rand((m,), generator=gen, device=dev) < 0.5).to(dtype)
    xt = torch.randn((n,), generator=gen, device=dev, dtype=dtype) * 0.1
    xd = torch.randn((n,), generator=gen, device=dev, dtype=dtype) * 0.1
    tag = f"({m}x{n} {dn})"
    res = {}

    k1 = normal_matvec(A, w, v)
    same_bits(f"normal_matvec {tag}", [k1], [normal_matvec(A, w, v)])
    res["normal_matvec"] = compare(f"normal_matvec {tag}", k1,
                                   normal_matvec_torch(A, w, v), dn)
    # K1s: one rank's all-reduce is a copy, so bitwise K1; its
    # overlapped form against K1s's plain version
    if not torch.equal(normal_matvec_sharded(A, w, v, mesh), k1):
        fail(f"normal_matvec_sharded {tag}: not bitwise K1 on one rank")
    plain = normal_matvec_sharded_torch(A, w, v, mesh)
    res["normal_matvec_sharded"] = max(
        [compare(f"normal_matvec_sharded {tag}", k1, plain, dn)]
        + [compare(f"normal_matvec_sharded overlap {c} {tag}",
                   normal_matvec_sharded(A, w, v, mesh, overlap_chunks=c),
                   plain, dn) for c in (2, 3)])
    del k1, plain
    # K1 with A in bfloat16: the plain version upcasts the copy to
    # dtype (an A-sized temporary), so both use the same values of A
    A_lp = A.to(torch.bfloat16)
    res["normal_matvec_bf16"] = bf16_matvec_checks(A_lp, w, v, mesh, tag,
                                                   dn)

    res.update(prep_checks(A, y, xt, xd, tag, dn))
    res.update(bf16_prep_checks(A_lp, y, xt, xd, tag, dn))
    times = {}
    if timed:
        times["normal_matvec"] = (
            time_ms(lambda: normal_matvec(A, w, v)),
            time_ms(lambda: normal_matvec_torch(A, w, v)))
        times["normal_matvec_bf16"] = (
            time_ms(lambda: normal_matvec(A_lp, w, v)),
            time_ms(lambda: normal_matvec_torch(A_lp, w, v)))
        times["normal_matvec_sharded"] = (
            time_ms(lambda: normal_matvec_sharded(A, w, v, mesh)),
            time_ms(lambda: normal_matvec_sharded_torch(A, w, v, mesh)))
        times["glm_prep_pair"] = (
            time_ms(lambda: glm_prep_pair(A, y, xt, xd, LOGISTIC01_GLM)),
            time_ms(lambda: glm_prep_pair_torch(A, y, xt, xd,
                                                LOGISTIC01_GLM)))
        times["glm_prep_pair_newton"] = (
            time_ms(lambda: glm_prep_pair(A, y, xt, xd, LOGISTIC01_GLM,
                                          flavour="newton")),
            time_ms(lambda: glm_prep_pair_torch(A, y, xt, xd, LOGISTIC01_GLM,
                                                flavour="newton")))
        times["glm_prep"] = (
            time_ms(lambda: glm_prep(A, y, xt, LOGISTIC01_GLM)),
            time_ms(lambda: glm_prep_torch(A, y, xt, LOGISTIC01_GLM)))
        # with A in bfloat16, beside the float32 A's times above
        times["glm_prep_pair_bf16"] = (
            time_ms(lambda: glm_prep_pair(A_lp, y, xt, xd, LOGISTIC01_GLM)),
            time_ms(lambda: glm_prep_pair_torch(A_lp, y, xt, xd,
                                                LOGISTIC01_GLM)))
        times["glm_prep_pair_newton_bf16"] = (
            time_ms(lambda: glm_prep_pair(A_lp, y, xt, xd, LOGISTIC01_GLM,
                                          flavour="newton")),
            time_ms(lambda: glm_prep_pair_torch(A_lp, y, xt, xd,
                                                LOGISTIC01_GLM,
                                                flavour="newton")))
        times["glm_prep_bf16"] = (
            time_ms(lambda: glm_prep(A_lp, y, xt, LOGISTIC01_GLM)),
            time_ms(lambda: glm_prep_torch(A_lp, y, xt, LOGISTIC01_GLM)))
        # the split form (phase 10's spec): the same plain version
        split = replace(LOGISTIC01_GLM, kind=None)
        times["glm_prep_pair, split form"] = (
            time_ms(lambda: glm_prep_pair(A, y, xt, xd, split)),
            times["glm_prep_pair"][1])
    del A, A_lp
    torch.cuda.empty_cache()
    return res, times


def bf16_matvec_checks(A_lp, w, v, mesh, tag, dn):
    """K1 with a bfloat16 A against its plain version at ``dn``'s
    tolerance, with a bitwise rerun; K1s on it under the one-rank
    ``mesh`` bitwise K1. Returns K1's max abs error."""
    import torch

    from scso_tpu_torch.ops.cuda.matvec import (
        normal_matvec, normal_matvec_sharded, normal_matvec_torch)

    what = f"normal_matvec, A in bfloat16 {tag}"
    got = normal_matvec(A_lp, w, v)
    if got.dtype != v.dtype:
        fail(f"{what}: result in {got.dtype}, not v's {v.dtype}")
    same_bits(what, [got], [normal_matvec(A_lp, w, v)])
    if not torch.equal(normal_matvec_sharded(A_lp, w, v, mesh), got):
        fail(f"normal_matvec_sharded, A in bfloat16 {tag}: not bitwise K1 "
             "on one rank")
    return compare(what, got, normal_matvec_torch(A_lp, w, v), dn)


def least_squares_glm():
    """A GLM spec the prep kernels do not compute themselves (their
    split form): squared loss, identity link, no ggn_rw/ggn_w."""
    import torch

    import scso_tpu_torch as st

    return st.GLMSpec(
        link=lambda z: z, dlink=torch.ones_like,
        res=lambda y, yh: (yh - y) / y.shape[0],
        qdiag=lambda y, yh: torch.ones_like(yh) / y.shape[0],
        hvp_w=lambda y, z: torch.ones_like(z) / y.shape[0],
        gres=lambda y, z: (z - y) / y.shape[0],
        loss_z=lambda y, z: 0.5 * torch.mean((z - y) ** 2),
        loss_sample=lambda y, z: 0.5 * (z - y) ** 2, kind="least_squares")


def squared_moglm(k):
    """An MOGLM spec K5 does not compute itself (its split form)."""
    import torch

    import scso_tpu_torch as st

    return st.MOGLMSpec(
        n_out=k, gres=lambda y, Z: (Z - y) / Z.shape[0],
        quad=lambda y, Z, U: U / Z.shape[0],
        qdiag_w=lambda y, Z: torch.ones_like(Z) / Z.shape[0],
        loss_z=lambda y, Z: 0.5 * torch.sum((Z - y) ** 2) / Z.shape[0],
        loss_sample=lambda y, Z: 0.5 * torch.sum((Z - y) ** 2, dim=-1))


def prep_checks(A, y, xt, xd, tag, dn, glm=None):
    """K2 (in both flavours) and K2s against their plain versions on
    ``glm`` (the logistic01 spec by default), normalized by A's rows and
    by another count (as on one rank of four), each with a bitwise
    rerun: {kernel: max abs err}."""
    from scso_tpu_torch.models.losses import LOGISTIC01_GLM
    from scso_tpu_torch.ops.cuda.glm_prep import (
        glm_prep, glm_prep_pair, glm_prep_pair_torch, glm_prep_torch)

    glm = glm or LOGISTIC01_GLM
    res = {"glm_prep_pair": 0.0, "glm_prep_pair_newton": 0.0,
           "glm_prep": 0.0}
    for m_norm in (None, 4 * A.shape[0] + 3):
        what = f"m_norm={m_norm} {tag}" if m_norm else tag
        for fl, key in (("ggn", "glm_prep_pair"),
                        ("newton", "glm_prep_pair_newton")):
            pp = glm_prep_pair(A, y, xt, xd, glm, m_norm, fl)
            same_bits(f"{key} {what}", pp,
                      glm_prep_pair(A, y, xt, xd, glm, m_norm, fl))
            ref = glm_prep_pair_torch(A, y, xt, xd, glm, m_norm, fl)
            res[key] = max([res[key]]
                           + [compare(f"{key}.{f} {what}", g, r, dn)
                              for f, g, r in zip(pp._fields, pp, ref)])
            del pp, ref
        k2s = glm_prep(A, y, xt, glm, m_norm)
        same_bits(f"glm_prep {what}", k2s, glm_prep(A, y, xt, glm, m_norm))
        ref = glm_prep_torch(A, y, xt, glm, m_norm)[:3]
        res["glm_prep"] = max(
            [res["glm_prep"]]
            + [compare(f"glm_prep.{f} {what}", g, r, dn)
               for f, g, r in zip(("w", "b", "hd"), k2s, ref)])
        del k2s, ref
    return res


def bf16_prep_checks(A_lp, y, xt, xd, tag, dn, glm=None):
    """`prep_checks` with A in bfloat16 (y and the candidates in ``dn``):
    {kernel_bf16: max abs err}. The plain versions upcast A to ``dn``
    (exact), so the tolerances are ``dn``'s."""
    return {f"{k}_bf16": e for k, e in prep_checks(
        A_lp, y, xt, xd, f"A in bfloat16 {tag}", dn, glm).items()}


def prep_case(m, n, dtype, gen):
    """K2 and K2s alone at one of PREP_SHAPES."""
    import torch

    from scso_tpu_torch.ops.cuda.glm_prep import max_n, prep_grid

    dev, dn = "cuda", str(dtype).replace("torch.", "")
    A = torch.randn((m, n), generator=gen, device=dev, dtype=dtype) * 0.1
    y = (torch.rand((m,), generator=gen, device=dev) < 0.5).to(dtype)
    xt = torch.randn((n,), generator=gen, device=dev, dtype=dtype) * 0.1
    xd = torch.randn((n,), generator=gen, device=dev, dtype=dtype) * 0.1
    forms = "/".join("one-pass" if n <= max_n(dtype, c) else "wide"
                     for c in (2, 1))
    forms += "; A in bf16 " + "/".join(prep_grid(
        m, n, dtype, c, 132, True, torch.bfloat16).form for c in (2, 1))
    res = prep_checks(A, y, xt, xd, f"({m}x{n} {dn})", dn)
    res.update(bf16_prep_checks(A.to(torch.bfloat16), y, xt, xd,
                                f"({m}x{n} {dn})", dn))
    log(f"  K2/K2s {m}x{n} {dn} ({forms}): max abs err "
        f"K2 {res['glm_prep_pair']:.3e} K2 newton "
        f"{res['glm_prep_pair_newton']:.3e} K2s {res['glm_prep']:.3e}; "
        f"A in bf16: K2 {res['glm_prep_pair_bf16']:.3e} K2 newton "
        f"{res['glm_prep_pair_newton_bf16']:.3e} K2s "
        f"{res['glm_prep_bf16']:.3e}")
    if (m, n) in PREP_SPLIT_SHAPES:
        from scso_tpu_torch._src.struct import replace
        from scso_tpu_torch.models.losses import LOGISTIC01_GLM

        for name, glm in (("least squares", least_squares_glm()),
                          ("kind=None", replace(LOGISTIC01_GLM, kind=None))):
            what = f"split, {name} ({m}x{n} {dn})"
            res = prep_checks(A, y, xt, xd, what, dn, glm)
            res.update(bf16_prep_checks(A.to(torch.bfloat16), y, xt, xd,
                                        what, dn, glm))
            log(f"  K2/K2s split form, {name} spec, {m}x{n} {dn}: max abs "
                f"err K2 {res['glm_prep_pair']:.3e} K2 newton "
                f"{res['glm_prep_pair_newton']:.3e} K2s "
                f"{res['glm_prep']:.3e}; A in bf16: K2 "
                f"{res['glm_prep_pair_bf16']:.3e} K2 newton "
                f"{res['glm_prep_pair_newton_bf16']:.3e} K2s "
                f"{res['glm_prep_bf16']:.3e}")


def kind_inputs(m, n, dtype, gen, kind):
    """A (m, n), y of the family (counts 0-5 for Poisson, Gaussian for
    least squares) and two candidates, on the card."""
    import torch

    dev = "cuda"
    A = torch.randn((m, n), generator=gen, device=dev, dtype=dtype)
    A.mul_(0.1)
    if kind == "poisson":
        y = torch.randint(0, 6, (m,), generator=gen, device=dev).to(dtype)
    else:
        y = torch.randn((m,), generator=gen, device=dev, dtype=dtype)
    xt = torch.randn((n,), generator=gen, device=dev, dtype=dtype) * 0.1
    xd = torch.randn((n,), generator=gen, device=dev, dtype=dtype) * 0.1
    return A, y, xt, xd


def kind_case(m, n, dtype, gen, timed=False):
    """K2 (both flavours) and K2s with LSQ_GLM and POISSON_GLM against
    their plain versions at (m, n), A in ``dtype`` and in bfloat16, each
    with a bitwise rerun (`prep_checks`); every launch must compute the
    kind in the kernel (its kind counter, not the split form). ``timed``:
    every row of KIND_ROWS is timed here too (kernel and plain). Returns
    ({row: max abs err}, {row: (ms, plain ms)})."""
    import torch

    from scso_tpu_torch.models.losses import LSQ_GLM, POISSON_GLM
    from scso_tpu_torch.ops.cuda import counters
    from scso_tpu_torch.ops.cuda.glm_prep import (
        glm_prep, glm_prep_pair, glm_prep_pair_torch, glm_prep_torch)

    dn = str(dtype).replace("torch.", "")
    errs, times = {}, {}
    for kind, glm in (("lsq", LSQ_GLM), ("poisson", POISSON_GLM)):
        A, y, xt, xd = kind_inputs(m, n, dtype, gen, kind)
        A_lp = A.to(torch.bfloat16)
        tag = f"{kind} ({m}x{n} {dn})"
        counters.reset()
        res = prep_checks(A, y, xt, xd, tag, dn, glm)
        res.update(bf16_prep_checks(A_lp, y, xt, xd, tag, dn, glm))
        snap = counters.snapshot()
        for base in ("glm_prep_pair", "glm_prep_pair_newton", "glm_prep"):
            for a in ("", "_bf16"):
                if not snap[f"{base}{a}"] == snap[f"{base}_{kind}{a}"] > 0:
                    fail(f"{base}{a} {tag}: {snap[f'{base}{a}']} launches, "
                         f"{snap[f'{base}_{kind}{a}']} of them with the "
                         f"{kind} kind in the kernel")
        for row, (base, k, flavour) in KIND_ROWS.items():
            if k != kind:
                continue
            errs[row], errs[f"{row}_bf16"] = res[base], res[f"{base}_bf16"]
            if not timed:
                continue
            for a, key in ((A, row), (A_lp, f"{row}_bf16")):
                if base == "glm_prep":
                    times[key] = (
                        time_ms(lambda: glm_prep(a, y, xt, glm)),
                        time_ms(lambda: glm_prep_torch(a, y, xt, glm)))
                else:
                    times[key] = (
                        time_ms(lambda: glm_prep_pair(
                            a, y, xt, xd, glm, flavour=flavour)),
                        time_ms(lambda: glm_prep_pair_torch(
                            a, y, xt, xd, glm, flavour=flavour)))
        log(f"  K2/K2s {tag}, one read of A: max abs err K2 "
            f"{res['glm_prep_pair']:.3e} K2 newton "
            f"{res['glm_prep_pair_newton']:.3e} K2s {res['glm_prep']:.3e}; "
            f"A in bf16: K2 {res['glm_prep_pair_bf16']:.3e} K2 newton "
            f"{res['glm_prep_pair_newton_bf16']:.3e} K2s "
            f"{res['glm_prep_bf16']:.3e}")
        del A, A_lp
        torch.cuda.empty_cache()
    return errs, times


def score_update_inputs(n, reg, dtype, gen):
    """K3's arguments at n: lgr = 0 on a tenth of the values."""
    import torch

    dev = "cuda"
    r = lambda: torch.randn((n,), generator=gen, device=dev, dtype=dtype)
    x, d, lgr = r(), r(), r()
    lgr[torch.rand((n,), generator=gen, device=dev) < 0.1] = 0.0
    hr = torch.rand((n,), generator=gen, device=dev, dtype=dtype) + 1e-3
    lam = torch.tensor(0.07, dtype=dtype, device=dev)
    ss = torch.tensor(0.6, dtype=dtype, device=dev)
    lb = torch.full((n,), -0.5, dtype=dtype, device=dev)
    ub = torch.full((n,), 0.7, dtype=dtype, device=dev)
    return (x, d, lgr, hr, lam, ss, 3.0, "l1" if reg == "none" else reg,
            reg != "none", lb, ub)


def score_update_case(n, reg, dtype, gen, timed=False, form=None):
    """K3 against its plain version at n, in update_form's form or in
    ``form``; with ``timed``, (per call, device, host) ms of the kernel
    and the plain version's per-call ms."""
    from scso_tpu_torch.ops.cuda import score_update as k3

    dn = str(dtype).replace("torch.", "")
    args = score_update_inputs(n, reg, dtype, gen)
    run = ((lambda: k3.score_update(*args)) if form is None
           else (lambda: k3._launch(*args, form=form)))
    tag = f"score_update (n={n} {reg} {dn}{'' if form is None else f' {form}'})"
    got = run()
    same_bits(tag, got, run())
    want = k3.score_update_torch(*args)
    err = max(compare(f"{tag}.{f}", g, w_, dn)
              for f, g, w_ in zip(got._fields, got, want))
    times = None
    if timed:
        times = (*three_times(run), time_ms(lambda: k3.score_update_torch(
            *args)))
    return err, times


def k3_boundary_cases(max_cluster):
    """(n, form) of K3 on both sides of each gate of update_form (form
    None: the wrapper's own choice) and at slice edges of a cluster of
    ``max_cluster`` blocks (forced): every slice full, a short last
    slice, and empty trailing blocks."""
    from scso_tpu_torch.ops.cuda.score_update import (
        CLUSTER_N, GRID_N, UpdateForm, cluster_slice)

    gates = [(n, None) for n in (CLUSTER_N - 1, CLUSTER_N, GRID_N - 1,
                                 GRID_N)]
    full = max_cluster * 640
    edges = [(n, UpdateForm(max_cluster, cluster_slice(n, max_cluster),
                            False))
             for n in (full, full + 1, 16 * 32 + 1, 1)]
    return gates + edges


def k3_sweep(max_cluster, gen):
    """K3's device time (graph_ms, float32, l1) at each n of K3_SWEEP_NS
    in each form: one block, clusters of 8 and ``max_cluster`` blocks,
    and the grid form (blocks of at least 65536 values)."""
    import torch

    from scso_tpu_torch.ops.cuda import score_update as k3

    out = {}
    for n in K3_SWEEP_NS:
        args = score_update_inputs(n, "l1", torch.float32, gen)
        forms = {f"cluster {c}": k3.UpdateForm(c, k3.cluster_slice(n, c),
                                               False)
                 for c in sorted({1, 8, max_cluster})}
        nblk = min(1024, -(-n // (1 << 16)))
        forms["grid"] = k3.UpdateForm(nblk, -(-n // nblk), True)
        out[n] = {name: graph_ms(lambda: k3._launch(*args, form=f))
                  for name, f in forms.items()}
        log(f"  K3 sweep n={n}: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in out[n].items())
            + f" (device time, graph_ms); update_form: "
            f"{k3.update_form(n, max_cluster)}")
        del args
    return out


def score_update_nonfinite_case(n, reg, dtype, gen, form=None):
    """K3 on a runaway step (NaN and ±inf in d), then on a NaN η: its
    outputs must be non-finite where the plain version's are, with the
    same values elsewhere (a NaN must not come out as a finite x⁺); in
    update_form's form or in ``form``."""
    import torch

    from scso_tpu_torch.ops.cuda import score_update as k3
    from scso_tpu_torch.ops.cuda.score_update import score_update_torch

    score_update = ((lambda *a: k3._launch(*a, form=form)) if form
                    else k3.score_update)

    dev = "cuda"
    dn = str(dtype).replace("torch.", "")
    r = lambda: torch.randn((n,), generator=gen, device=dev, dtype=dtype)
    x, d, lgr = r(), r(), r()
    d[::7], d[1::11], d[2::13] = float("nan"), float("inf"), -float("inf")
    hr = torch.rand((n,), generator=gen, device=dev, dtype=dtype) + 1e-3
    lam = torch.tensor(0.07, dtype=dtype, device=dev)
    ss = torch.tensor(0.6, dtype=dtype, device=dev)
    lb = torch.full((n,), -0.5, dtype=dtype, device=dev)
    ub = torch.full((n,), 0.7, dtype=dtype, device=dev)
    lgr_nan = lgr.clone()
    lgr_nan[n // 2] = float("nan")
    for what, g in (("runaway step", lgr), ("NaN η", lgr_nan)):
        args = (x, d, g, hr, lam, ss, 3.0, "l1" if reg == "none" else reg,
                reg != "none", lb, ub)
        tag = f"score_update (n={n} {reg} {dn}, {what})"
        got, want = score_update(*args), score_update_torch(*args)
        for f, u, v in zip(got._fields, got, want):
            fin = torch.isfinite(v)
            if not (torch.equal(torch.isnan(u), torch.isnan(v))
                    and torch.equal(u[torch.isinf(v)], v[torch.isinf(v)])):
                fail(f"{tag}.{f}: non-finite outputs differ from the "
                     "plain version's")
            if bool(fin.any()):
                compare(f"{tag}.{f}", u[fin], v[fin], dn)


def two_loop_inputs(n, m, pushes, dtype, gen):
    """K4's memory of ``pushes`` SPD-quadratic pairs (γ = B·δ) and a
    gradient; with two or more pairs, one valid slot gets an s and a y
    of disjoint support, so yᵀs = 0 exactly."""
    import torch

    from scso_tpu_torch.ops import lbfgs_core

    dev = "cuda"
    bdiag = torch.rand((n,), generator=gen, device=dev, dtype=dtype) * 4 + 0.5
    mem = lbfgs_core.init_memory(n, m, dtype, dev)
    for _ in range(pushes):
        delta = torch.randn((n,), generator=gen, device=dev,
                            dtype=dtype) * 0.1
        mem = lbfgs_core.update_memory(mem, delta, bdiag * delta)
    if pushes >= 2:
        slot = (int(mem.pos) - 2) % m
        S, Y = mem.S.clone(), mem.Y.clone()
        S[slot, n // 2:] = 0
        Y[slot, : n // 2] = 0
        mem = mem._replace(S=S, Y=Y)
    g = torch.randn((n,), generator=gen, device=dev, dtype=dtype)
    return mem, g


def two_loop_case(n, m, pushes, dtype, gen, timed=False, plan=None):
    """K4 against its plain version on two_loop_inputs' memory;
    ``plan`` forces a launch plan; with ``timed``, (per call, device,
    host) ms of the kernel and the plain version's per-call ms."""
    import torch

    from scso_tpu_torch.ops.cuda import launch
    from scso_tpu_torch.ops.cuda import two_loop as k4

    dn = str(dtype).replace("torch.", "")
    mem, g = two_loop_inputs(n, m, pushes, dtype, gen)
    run = ((lambda: k4.two_loop(mem, g)) if plan is None
           else (lambda: k4._launch(mem, g, plan)))
    tag = (f"two_loop (n={n} m={m} pairs={pushes} {dn}"
           f"{'' if plan is None else f' {plan}'})")
    got = run()
    same_bits(tag, [got], [run()])
    if plan is None:
        # the same blocks and slices with S and Y streamed, q in the
        # output and α, ρ in the scratch must give the same bits
        bare = k4.two_loop_plan(n, m, g.element_size(), launch.max_cluster(
            "scso_two_loop", dtype, g.device.index))._replace(
                alpha_smem=False, q_smem=False, resident=False, smem=0)
        same_bits(f"{tag} against {bare}", [got], [k4._launch(mem, g, bare)])
    err = compare(tag, got, k4.two_loop_torch(mem, g), dn)
    if pushes == 0 and not torch.equal(got, -g):
        fail(f"{tag}: an empty memory must give -g exactly")
    times = None
    if timed:
        times = (*three_times(run),
                 time_ms(lambda: k4.two_loop_torch(mem, g)))
    return err, times


def two_loop_boundary_cases(dtype, max_cluster):
    """(n, m, pushes) of K4 on both sides of its shared-memory residency
    limit (m = 10: the largest n whose slices sit in shared memory, and
    the next) and of SMEM_BYTES (the largest m whose α and ρ sit in
    shared memory, and the next), as two_loop_plan lays them out on this
    card."""
    import torch

    from scso_tpu_torch.ops.cuda.two_loop import SMEM_BYTES, two_loop_plan

    size = torch.empty((), dtype=dtype).element_size()
    step = 32 * max_cluster
    n = step
    while two_loop_plan(n + step, 10, size, max_cluster).resident:
        n += step
    if not (two_loop_plan(n, 10, size, max_cluster).resident
            and not two_loop_plan(n + 1, 10, size, max_cluster).resident):
        fail(f"two_loop: no residency edge at n={n} ({dtype})")
    m = SMEM_BYTES // (2 * size)
    return [(n, 10, 13), (n + 1, 10, 13), (64, m, m + 3),
            (64, m + 1, m + 4)]


def wide_matvec_case(m, n, dtype, gen):
    """K1 above its shared-memory form's n limit."""
    import torch

    from scso_tpu_torch.ops.cuda.matvec import (
        normal_matvec, normal_matvec_torch)

    dev, dn = "cuda", str(dtype).replace("torch.", "")
    A = torch.randn((m, n), generator=gen, device=dev, dtype=dtype) * 0.1
    w = torch.rand((m,), generator=gen, device=dev, dtype=dtype) / m
    v = torch.randn((n,), generator=gen, device=dev, dtype=dtype)
    tag = f"normal_matvec wide ({m}x{n} {dn})"
    got = normal_matvec(A, w, v)
    same_bits(tag, [got], [normal_matvec(A, w, v)])
    err = compare(tag, got, normal_matvec_torch(A, w, v), dn)
    A_lp = A.to(torch.bfloat16)
    del A
    got = normal_matvec(A_lp, w, v)
    tag = f"normal_matvec wide, A in bfloat16 ({m}x{n} {dn})"
    same_bits(tag, [got], [normal_matvec(A_lp, w, v)])
    return err, compare(tag, got, normal_matvec_torch(A_lp, w, v), dn)


def mglm_inputs(m, p, k, dtype, gen):
    import torch

    dev = "cuda"
    A = torch.randn((m, p), generator=gen, device=dev, dtype=dtype)
    labels = torch.randint(0, k, (m,), generator=gen, device=dev)
    y = torch.nn.functional.one_hot(labels, k).to(dtype)
    Z = A @ (torch.randn((p, k), generator=gen, device=dev, dtype=dtype)
             * 0.3)
    V = torch.randn((p, k), generator=gen, device=dev, dtype=dtype)
    return A, y, Z, V


def tf32(x):
    """x as one TF32 operand of the tensor cores: its 13 low mantissa
    bits cleared."""
    import torch

    return (x.view(torch.int32) & -8192).view(torch.float32)


def one_tf32_product_rejected(A, y, Z, V, spec, want):
    """K5 with one TF32 product in either contraction (where split TF32
    takes three), emulated in float32 PyTorch: fails unless TOL["k5"]
    rejects both. Returns their max abs errors."""
    variants = {
        "A·V": A.T @ spec.quad(y, Z, tf32(A) @ tf32(V)),
        "Aᵀ·QU": tf32(A).T @ tf32(spec.quad(y, Z, A @ V)),
    }
    errs = {}
    for what, got in variants.items():
        errs[what] = float((got.double() - want.double()).abs().max())
        if not compare(what, got, want, "k5", check=False):
            fail(f"K5's limit passes one TF32 product in {what} (max abs "
                 f"err {errs[what]:.3e}): it cannot tell split TF32 from "
                 "one TF32 product")
    return errs


def mglm_case(m, p, k, dtype, gen, timed=False):
    """K5 against its plain version, with A in ``dtype`` and in
    bfloat16. Returns ({kernel: max err}, {kernel: (kernel ms, plain
    ms)}, empty unless ``timed``)."""
    import torch

    from scso_tpu_torch.models.losses import multinom_mglm
    from scso_tpu_torch.ops.cuda.mglm_matvec import (
        mglm_matvec, mglm_matvec_torch)

    dn = str(dtype).replace("torch.", "")
    A, y, Z, V = mglm_inputs(m, p, k, dtype, gen)
    spec = multinom_mglm(k)
    tol = "k5" if dtype == torch.float32 else dn
    errs, times = {}, {}
    for key, A_ in (("mglm_matvec", A),
                    ("mglm_matvec_bf16", A.to(torch.bfloat16))):
        narrow = A_.dtype == torch.bfloat16
        tag = (f"mglm_matvec{', A in bfloat16' if narrow else ''} "
               f"({m}x{p}x{k} {dn})")
        got = mglm_matvec(A_, y, Z, V, spec)
        if got.dtype != dtype:
            fail(f"{tag}: result in {got.dtype}, not V's {dtype}")
        same_bits(tag, [got], [mglm_matvec(A_, y, Z, V, spec)])
        want = mglm_matvec_torch(A_, y, Z, V, spec)
        errs[key] = compare(tag, got, want, tol)
        if not timed:
            continue
        rtol, atol = limit_of(want, tol)
        # A in bfloat16 is exact in TF32: one TF32 product of A is A's
        # product, and the emulation truncates V (QU) alone
        A_up = A_.to(dtype) if narrow else A_
        one = one_tf32_product_rejected(A_up, y, Z, V, spec, want)
        log(f"  K5 {m}x{p}x{k} {dn}{', A in bf16' if narrow else ''}: max "
            f"abs err {errs[key]:.3e}, max|ref| "
            f"{float(want.abs().max()):.3e}, limit {atol:.3e}; one TF32 "
            "product (emulated): " + ", ".join(
                f"in {w} {e:.3e}" for w, e in one.items()) + " (rejected)")
        del A_up
        times[key] = (time_ms(lambda: mglm_matvec(A_, y, Z, V, spec)),
                      time_ms(lambda: mglm_matvec_torch(A_, y, Z, V, spec)))
    del A, A_
    torch.cuda.empty_cache()
    return errs, times


def mglm_split_case(m, p, k, dtype, gen):
    """K5's split form (specs it does not compute itself) against the
    plain version, with A in ``dtype`` and in bfloat16, with a bitwise
    rerun."""
    from scso_tpu_torch._src.struct import replace
    from scso_tpu_torch.models.losses import multinom_mglm
    from scso_tpu_torch.ops.cuda.mglm_matvec import (
        mglm_matvec, mglm_matvec_torch)

    import torch

    dn = str(dtype).replace("torch.", "")
    A, y, Z, V = mglm_inputs(m, p, k, dtype, gen)
    errs = []
    for spec in (squared_moglm(k), replace(multinom_mglm(k), kind=None)):
        for A_ in (A, A.to(torch.bfloat16)):
            tag = (f"mglm_matvec split form, kind {spec.kind}, A in "
                   f"{A_.dtype} ({m}x{p}x{k} {dn})")
            got = mglm_matvec(A_, y, Z, V, spec)
            same_bits(tag, [got], [mglm_matvec(A_, y, Z, V, spec)])
            errs.append(compare(tag, got,
                                mglm_matvec_torch(A_, y, Z, V, spec), dn))
    return max(errs)


def work_bounds(main, mglm_shape, lbfgs_case):
    """(bytes, flops) each kernel must move and do at its timed shape,
    float32: each input read once and each output written once; the
    multiply-adds over A (or, for K3 and K4, over the vectors). K1s is
    K1 plus one all-reduce of n values (read and written once on one
    rank)."""
    m, n = main
    mm, p, k = mglm_shape
    n4, mem = lbfgs_case[0], lbfgs_case[1]
    f = 4
    k1 = (f * (m * n + m + 2 * n), 4 * m * n)
    k5 = (mm * p, f * (2 * mm * k + 2 * p * k), 4 * mm * p * k)
    out = {
        "normal_matvec": k1,
        # A in bfloat16, w, v and the result in float32
        "normal_matvec_bf16": (2 * m * n + f * (m + 2 * n), 4 * m * n),
        "normal_matvec_sharded": (k1[0] + 2 * f * n, k1[1]),
        "score_update": (f * 5 * n, 20 * n),
        "two_loop": (f * (2 * mem * n4 + 2 * n4), 8 * mem * n4),
    }
    # A in float32, and (the _bf16 rows) in bfloat16 with every other
    # operand in float32
    out.update(prep_work(m, n))
    a, rest, ops = k5
    out["mglm_matvec"] = (f * a + rest, ops)
    out["mglm_matvec_bf16"] = (2 * a + rest, ops)
    # the kinds' rows at their paths' shapes (KIND_ROWS)
    for shape, kind in ((GL_SHAPE, "lsq"), (main, "poisson")):
        at = prep_work(*shape)
        for row, (base, k_, _) in KIND_ROWS.items():
            if k_ == kind:
                out[row] = at[base]
                out[f"{row}_bf16"] = at[f"{base}_bf16"]
    return out


def prep_work(m, n):
    """(bytes, flops) of K2 (both flavours) and K2s at (m, n), A in
    float32 and (the _bf16 keys) in bfloat16, every other operand in
    float32: A, y and the candidates read once; w, b, hd and the losses
    written once; 7 operations an element of A a candidate (the dot's
    multiply-add, ρ·a and w·a² added)."""
    f = 4
    k2 = (m * n, f * (3 * m + 6 * n + 2), 14 * m * n)  # A's values, rest
    k2s = (m * n, f * (2 * m + 3 * n), 7 * m * n)
    out = {}
    for name, (a, rest, ops) in (("glm_prep_pair", k2),
                                 ("glm_prep_pair_newton", k2),
                                 ("glm_prep", k2s)):
        out[name] = (f * a + rest, ops)
        out[f"{name}_bf16"] = (2 * a + rest, ops)
    return out


def bound(bytes_, flops, name=None):
    """(bound_ms, bound_by) on the data sheet's H100 SXM peaks: bytes at
    the HBM rate, operations at the FP32 rate, but K5 with A in bfloat16,
    whose multiply-adds run on the tensor cores with A as a bfloat16
    operand, at the bfloat16 rate."""
    rate = BF16_FLOP_S if name == "mglm_matvec_bf16" else FP32_FLOP_S
    t_bytes, t_ops = bytes_ / HBM_BYTES_S, flops / rate
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(mesh):
    import torch
    import torch.distributed as dist

    from scso_tpu_torch.ops.cuda import launch
    from scso_tpu_torch.ops.cuda.two_loop import two_loop_plan

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    main = (MAIN_SHAPE[0], MAIN_SHAPE[1] + (-MAIN_SHAPE[1]) % 128)
    errs = {k: 0.0 for k in KERNELS}
    times, narrow_times = {}, {}
    # (device, host) ms a call of K3 and K4 at their paths' shapes
    split = {}
    floor = launch_floor()
    for what, t in floor.items():
        log(f"  launch floor, an empty kernel ({what}): per call {t[0]:.4f}"
            f" ms, device {t[1]:.4f} ms, host {t[2]:.4f} ms a call")
    k3_sweep(launch.max_cluster("scso_score_update", torch.float32, 0), gen)
    for dtype in (torch.float32, torch.float64):
        for (m, n) in [main, NARROW_SHAPE] + BOUNDARY_SHAPES:
            timed = dtype == torch.float32 and (m, n) in (main, NARROW_SHAPE)
            t0 = time.perf_counter()
            res, t = data_kernel_case(m, n, dtype, gen, mesh, timed=timed)
            log(f"  K1/K1s/K2/K2s {m}x{n} {dtype}: max abs err "
                f"K1 {res['normal_matvec']:.3e} "
                f"K1 with A in bf16 {res['normal_matvec_bf16']:.3e} "
                f"K1s {res['normal_matvec_sharded']:.3e} "
                f"K2 {res['glm_prep_pair']:.3e} "
                f"K2 newton {res['glm_prep_pair_newton']:.3e} "
                f"K2s {res['glm_prep']:.3e}; A in bf16: "
                f"K2 {res['glm_prep_pair_bf16']:.3e} "
                f"K2 newton {res['glm_prep_pair_newton_bf16']:.3e} "
                f"K2s {res['glm_prep_bf16']:.3e} "
                f"({time.perf_counter() - t0:.1f} s)")
            if timed and (m, n) == main:
                times.update(t)
                errs.update(res)
            elif timed:
                narrow_times = t
        for (m, n) in PREP_SHAPES:
            prep_case(m, n, dtype, gen)
        k3_cases = [(n, None) for n in K3_NS] + k3_boundary_cases(
            launch.max_cluster("scso_score_update", dtype, 0))
        for n, form in k3_cases:
            for reg in K3_REGS:
                score_update_case(n, reg, dtype, gen, form=form)
                score_update_nonfinite_case(n, reg, dtype, gen, form=form)
        # K3 at the main-path width (not in the odd-n list), and timed
        # there and at the other K3_TIMED_NS
        err, t = score_update_case(main[1], "l1", dtype, gen,
                                   timed=dtype == torch.float32)
        if dtype == torch.float32:
            times["score_update"] = (t[0], t[3])
            split["score_update"] = t[1:3]
            errs["score_update"] = err
            for n in K3_TIMED_NS:
                t = t if n == main[1] else score_update_case(
                    n, "l1", dtype, gen, timed=True)[1]
                log(f"  K3 n={n} float32: per call {t[0]:.4f} ms, device "
                    f"{t[1]:.4f} ms, host {t[2]:.4f} ms a call, plain "
                    f"{t[3]:.4f} ms; bound "
                    f"{bound(4 * 5 * n, 20 * n)[0]:.5f} ms")
        log(f"  K3 {len(k3_cases)}×{len(K3_REGS)} cases (gates and slice "
            f"edges: {[(n, f) for n, f in k3_cases if n not in K3_NS]}) "
            f"+ n={main[1]} {dtype}: ok")
        dn = str(dtype).replace("torch.", "")
        for (m, n, wdn) in WIDE_SHAPES:
            if wdn == dn:
                err, err_lp = wide_matvec_case(m, n, dtype, gen)
                log(f"  K1 wide {m}x{n} {dn}: max abs err {err:.3e}, with "
                    f"A in bf16 {err_lp:.3e}")
        for (m, p, k) in [MGLM_SHAPE] + MGLM_SHAPES:
            timed = dtype == torch.float32 and (m, p, k) == MGLM_SHAPE
            t0 = time.perf_counter()
            err, t = mglm_case(m, p, k, dtype, gen, timed=timed)
            if (m, p, k) == MGLM_SHAPE:
                log(f"  K5 {m}x{p}x{k} {dn}: max abs err "
                    f"{err['mglm_matvec']:.3e}, with A in bf16 "
                    f"{err['mglm_matvec_bf16']:.3e} "
                    f"({time.perf_counter() - t0:.1f} s)")
            if timed:
                times.update(t)
                errs.update(err)
        log(f"  K5 {len(MGLM_SHAPES)} boundary shapes {dn}, A in {dn} and "
            "in bf16: ok")
        for (m, p, k) in MGLM_SPLIT_SHAPES:
            log(f"  K5 split form {m}x{p}x{k} {dn}: max abs err "
                f"{mglm_split_case(m, p, k, dtype, gen):.3e}")
        k4_max = launch.max_cluster("scso_two_loop", dtype, 0)
        k4_cases = TWO_LOOP_CASES + two_loop_boundary_cases(dtype, k4_max)
        for i, (n, m, pushes) in enumerate(k4_cases):
            timed = dtype == torch.float32 and i == 0
            err, t = two_loop_case(n, m, pushes, dtype, gen, timed=timed)
            if i == 0:
                log(f"  K4 n={n} m={m} {dn}: max abs err {err:.3e}")
            if timed:
                times["two_loop"] = (t[0], t[3])
                split["two_loop"] = t[1:3]
                errs["two_loop"] = err
        log(f"  K4 {len(k4_cases)} memories {dn} (residency and SMEM_BYTES "
            f"edges: {k4_cases[len(TWO_LOOP_CASES):]}; cluster of "
            f"{k4_max} at most): ok")
        if dtype == torch.float32:
            for n, m in TWO_LOOP_TIMED:
                t = two_loop_case(n, m, m + 3, dtype, gen, timed=True)[1]
                log(f"  K4 n={n} m={m} float32 ({two_loop_plan(n, m, 4, k4_max)}): "
                    f"per call {t[0]:.4f} ms, device {t[1]:.4f} ms, host "
                    f"{t[2]:.4f} ms a call, plain {t[3]:.4f} ms; bound "
                    f"{bound(4 * (2 * m * n + 2 * n), 8 * m * n)[0]:.5f} ms")
    # the least-squares and Poisson kinds in K2/K2s: the main shape, the GL
    # path's, the narrow one and PREP_SHAPES (both sides of each one-pass
    # limit, fewer rows than blocks), A in float32 / float64 and bfloat16;
    # every kind row timed at the main shape and at GL_SHAPE, the JSON
    # line taking each at its path's shape
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.float64):
        for (m, n) in [main, GL_SHAPE, NARROW_SHAPE] + PREP_SHAPES:
            timed = dtype == torch.float32 and (m, n) in (main, GL_SHAPE)
            e, t = kind_case(m, n, dtype, gen, timed)
            for k, v in t.items():
                kind = KIND_ROWS[k.replace("_bf16", "")][1]
                path_shape = GL_SHAPE if kind == "lsq" else main
                if (m, n) == path_shape:
                    times[k] = v
                    errs[k] = e[k]
                a = m * n * (2 if k.endswith("_bf16") else 4)
                at = prep_work(m, n)[KIND_ROWS[k.replace("_bf16", "")][0]
                                     + ("_bf16" if k.endswith("_bf16")
                                        else "")]
                log(f"  time at {m}x{n}, {k}: kernel {v[0]:.4f} ms, "
                    f"{a / v[0] / 1e6:.1f} GB/s of A, bound "
                    f"{bound(*at, k)[0]:.4f} ms, plain {v[1]:.4f} ms (CUDA "
                    "events, runs of calls)")
    log(f"  K2/K2s lsq and poisson kinds: {2 * (3 + len(PREP_SHAPES))} "
        f"shapes ({time.perf_counter() - t0:.1f} s)")
    # the kernels that stream A: their achieved rate over A's bytes
    a_bytes = dict.fromkeys(("normal_matvec", "normal_matvec_sharded",
                             "glm_prep_pair", "glm_prep_pair_newton",
                             "glm_prep", "glm_prep_pair, split form"),
                            4 * main[0] * main[1])
    a_bytes["mglm_matvec"] = 4 * MGLM_SHAPE[0] * MGLM_SHAPE[1]
    for k in BF16_OF:
        a_bytes[k] = a_bytes[BF16_OF[k]] // 2
    for k, (ms, plain) in times.items():
        if k.replace("_bf16", "") in KIND_ROWS:
            continue  # logged above, at their paths' shapes
        rate = (f", {a_bytes[k] / ms / 1e6:.1f} GB/s of A" if k in a_bytes
                else "")
        log(f"  time at the main-path shape, {k}: kernel {ms:.4f} ms"
            f"{rate}, plain {plain:.4f} ms (CUDA events, runs of calls)")
    narrow_bounds = work_bounds(NARROW_SHAPE, MGLM_SHAPE, TWO_LOOP_CASES[0])
    for k, (ms, plain) in narrow_times.items():
        a = NARROW_SHAPE[0] * NARROW_SHAPE[1] * (2 if k in BF16_OF else 4)
        extra = (f", bound {bound(*narrow_bounds[k], k)[0]:.4f} ms"
                 if k in narrow_bounds else "")
        log(f"  time at {NARROW_SHAPE[0]}x{NARROW_SHAPE[1]}, {k}: kernel "
            f"{ms:.4f} ms, {a / ms / 1e6:.1f} GB/s of A{extra}, plain "
            f"{plain:.4f} ms (CUDA events, runs of calls)")
    main_bound = bound(*work_bounds(main, MGLM_SHAPE,
                                    TWO_LOOP_CASES[0])["glm_prep_pair"])[0]
    log(f"  K2 at {main[0]}x{main[1]}: newton flavour "
        f"{times['glm_prep_pair_newton'][0]:.4f} ms, ggn flavour "
        f"{times['glm_prep_pair'][0]:.4f} ms, bound {main_bound:.4f} ms "
        "(the same bytes)")
    bounds = work_bounds(main, MGLM_SHAPE, TWO_LOOP_CASES[0])
    for k, base in BF16_OF.items():
        log(f"  A in bfloat16 against A in float32, {k}: "
            f"{times[k][0]:.4f} ms against {times[base][0]:.4f} ms, bound "
            f"{bound(*bounds[k], k)[0]:.4f} ms against "
            f"{bound(*bounds[base], base)[0]:.4f} ms (one call)")
    buf = torch.ones(main[1], device="cuda")
    ar_ms = time_ms(lambda: dist.all_reduce(buf, group=mesh.group))
    log(f"  one all-reduce of {buf.numel() * 4} bytes over the one-rank "
        f"NCCL group: {ar_ms:.4f} ms (CUDA events, runs of calls)")
    return (errs, times, work_bounds(main, MGLM_SHAPE, TWO_LOOP_CASES[0]),
            split)


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path
# ---------------------------------------------------------------------------


def build_problem(M, N, device, dtype, sol=None, lam=0.01):
    import numpy as np

    import scso_tpu_torch as st
    from scso_tpu_torch.models import losses, synthetic

    A, y, x0, _ = synthetic.make_sparse_logreg_data(
        M, N, density=0.05, n_active=64, seed=SEED, dtype=np.float32,
        label01=True)
    return st.Problem(A, y, x0, losses.logistic01_f, lam,
                      grad_fx=losses.logistic01_grad,
                      glm=losses.LOGISTIC01_GLM, sol=sol, dtype=dtype,
                      device=device, pad_features=True)


# the options of each solve of a chain (bench.py's)
CHUNK_KW = dict(x_tol=1e-12, f_tol=GAP, max_epoch=CHUNK, verbose=0,
                stats_every=4, alpha=1.0)


def solve_chunk(method, prob, capture=True, mode="fused"):
    """One solve of a chain: in the default fused mode a captured solve
    on the card, with ``capture=False`` the same solve's bodies run
    eagerly (the reference form); ``mode='timed'`` the timed loop."""
    import scso_tpu_torch as st

    return st.iterate(method, prob, "l1", st.PHuberSmootherL1L2(1.0),
                      _capture=capture, **dict(CHUNK_KW, mode=mode))


def presolve(method, prob):
    """Chain warm-started solves until the objective stops improving by
    1e-7 relative (at most 12): the best iterate anchors x*."""
    from scso_tpu_torch._src.struct import replace

    best, x_opt, cur, epochs = float("inf"), None, prob, 0
    for _ in range(12):
        s = solve_chunk(method, cur)
        epochs += s.epochs
        obj = float(s.obj[-1])
        improved = obj < best * (1 - 1e-7)
        if obj < best:
            best, x_opt = obj, s.state.x
        if not improved:
            break
        cur = replace(cur, x0=s.state.x)
    return best, x_opt, epochs


def timed_chain(method, prob, best, keep_x=False, first=None, capture=True,
                mode="fused"):
    """Fresh solves from x0 against x*, chained until the gap fires.
    ``keep_x`` adds the final iterate (a tensor) as ``x`` and each
    solve's objective history as ``objs``. ``first`` ((method, problem)
    → Solution) runs the first solve instead of `solve_chunk` (phase 13:
    iterate_mixed); its cg_info is kept as ``first_info``. ``capture``
    and ``mode`` go to `solve_chunk`; ``solves`` counts the solves and
    ``loop`` holds what the solve loop did on the card meanwhile
    (`graph.STATS`: captures, replays, host reads)."""
    from scso_tpu_torch._src.struct import replace
    from scso_tpu_torch.ops.cuda import graph

    t_solve, epochs, cg_total, cur, prev_gap = 0.0, 0, 0, prob, float("inf")
    objs = []
    graph.reset_stats()
    for i in range(12):
        t0 = time.perf_counter()
        s = (first(method, cur) if first is not None and i == 0 else
             solve_chunk(method, cur, capture, mode))
        if i == 0:
            first_info = dict(s.cg_info or {})
        t_solve += time.perf_counter() - t0
        objs.append(s.obj)
        if mode == "timed" and (len(s.times) != len(s.obj) or not bool(
                (s.times[1:] >= s.times[:-1]).all())):
            fail(f"timed mode: {len(s.times)} times for {len(s.obj)} "
                 "records, or times that decrease")
        epochs += s.epochs
        cg_total += (s.cg_info or {}).get("total_cg_iters", 0)
        gap = float(s.objrel[-1])
        signed_min = float(((s.obj - best) / abs(best)).min())
        if gap <= GAP or signed_min <= GAP:
            break
        if s.epochs < CHUNK and gap >= prev_gap * 0.99:
            break
        prev_gap = gap
        cur = replace(cur, x0=warm_start(cur, s))
    if gap > GAP and signed_min <= GAP:
        gap = GAP  # reached below the anchor
    out = dict(seconds=t_solve, epochs=epochs, cg_iters=cg_total, gap=gap,
               obj=float(s.obj[-1]), first_info=first_info, solves=i + 1,
               loop=dict(graph.STATS))
    if keep_x:
        out["x"], out["objs"] = s.x, objs
    return out


def warm_start(prob, s):
    """The padded iterate a chained solve starts from: fused mode's
    ``state.x``; timed mode keeps no state (as the JAX package's), so its
    x with the padded features' zeros appended."""
    if s.state is not None:
        return s.state.x
    x0 = prob.x0.new_zeros(prob.x0.shape)
    x0[..., : s.x.shape[-1]] = s.x
    return x0


def same_run(what, a, b):
    """Fail unless two runs (captured, eager) took the same epochs and CG
    iterations to bitwise the same x and objective histories."""
    import torch

    for key in ("epochs", "cg_iters"):
        if a[key] != b[key]:
            fail(f"{what}: captured {key} {a[key]} != eager {b[key]}")
    if not torch.equal(a["x"], b["x"]) or len(a["objs"]) != len(b["objs"]) \
            or not all(torch.equal(p, q) for p, q in zip(a["objs"],
                                                          b["objs"])):
        fail(f"{what}: the captured and the eager runs differ in x or in "
             "an objective history")


def capture_turns(what, run):
    """``run(capture)`` — a chain, or one solve, returning timed_chain's
    dict with ``x`` and ``objs`` — captured (the default fused mode) and
    eager (``capture=False``: the same graph bodies run on the card with a
    host read a predicate), in turns c, e, e, c, c, e. The two must take
    the same epochs and CG iterations to bitwise the same x and
    objective histories. Returns and prints the best of 3 seconds of
    each, the capture's seconds and nodes (made earlier, by the
    presolve or the warm-up), and the replays and host reads a solve."""
    from scso_tpu_torch.ops.cuda import graph

    runs = {True: [], False: []}
    for capture in (True, False, False, True, True, False):
        runs[capture].append(run(capture))
    c, e = runs[True][0], runs[False][0]
    for r in runs[True][1:] + runs[False]:
        same_run(what, c, r)
    graphs = graph.last_graphs()
    per = lambda r, k: r["loop"][k] / r["solves"]
    out = dict(captured_s=min(r["seconds"] for r in runs[True]),
               eager_s=min(r["seconds"] for r in runs[False]),
               capture_s={k: g.seconds for k, g in graphs.items()},
               nodes={k: g.nodes for k, g in graphs.items()},
               captures_in_turns=sum(r["loop"]["captures"]
                                     for r in runs[True]),
               replays_per_solve=per(c, "replays"),
               host_reads_per_solve=per(c, "host_reads"),
               eager_host_reads_per_solve=per(e, "host_reads"),
               solves=c["solves"], epochs=c["epochs"],
               cg_iters=c["cg_iters"])
    if out["captures_in_turns"]:
        fail(f"{what}: the timed captured runs captured anew "
             f"({out['captures_in_turns']} captures)")
    log(f"  captured vs eager ({what}): same {c['epochs']} epochs and "
        f"{c['cg_iters']} CG iterations, x and objective histories "
        f"bitwise; best of 3 in turns: captured {out['captured_s']:.4f} s, "
        f"eager {out['eager_s']:.4f} s; {c['solves']} solves, "
        f"{out['replays_per_solve']:.1f} replays and "
        f"{out['host_reads_per_solve']:.1f} host reads a solve (eager "
        f"{out['eager_host_reads_per_solve']:.1f})")
    for k, g in graphs.items():
        log(f"  capture seconds ({what}, {k} graph): {g.seconds:.3f}")
        log(f"  graph nodes ({what}, {k} graph): {g.nodes}")
    return out


def phase_main_path(shape=MAIN_SHAPE, timed_mode=False):
    """The cached GGN-CG chain at ``shape`` (phase 3; phase 9 at the
    JAX bench's secondary shape), then the same chain with
    kernels='torch', the captured chain against the eager one in turns,
    and with ``timed_mode`` the chain in timed mode."""
    import dataclasses

    import torch

    import scso_tpu_torch as st
    from scso_tpu_torch._src.struct import replace
    from scso_tpu_torch.ops.cuda import counters

    t0 = time.perf_counter()
    prob = build_problem(*shape, "cuda", torch.float32)
    torch.cuda.synchronize()
    log(f"  data {shape[0]}x{shape[1]} padded to "
        f"{tuple(prob.A.shape)}, made and moved in "
        f"{time.perf_counter() - t0:.1f} s")
    method = st.ProxGGNSCORE(**F32_CG)
    t0 = time.perf_counter()
    best, x_opt, pre_epochs = presolve(method, prob)
    log(f"  presolve: obj* {best:.9e} after {pre_epochs} epochs "
        f"({time.perf_counter() - t0:.1f} s)")
    prob_t = replace(prob, x_star=x_opt)
    solve_chunk(method, prob_t)  # warm-up

    counters.reset()
    kern = timed_chain(method, prob_t, best)
    launches = counters.snapshot()
    log(f"  timed solve, kernels: {kern['seconds']:.4f} s, "
        f"{kern['epochs']} epochs, {kern['cg_iters']} CG iterations, "
        f"gap {kern['gap']:.3e}, launches {launches}")
    if not kern["gap"] <= GAP * 1.05:
        fail(f"the kernel path missed the {GAP:g} gap: {kern['gap']:.3e}")
    check_launches(launches, LOGISTIC_KERNELS, "sparse-logistic")

    plain_method = dataclasses.replace(method, kernels="torch")
    solve_chunk(plain_method, prob_t)  # warm-up
    plain = timed_chain(plain_method, prob_t, best)
    log(f"  timed solve, kernels='torch': {plain['seconds']:.4f} s, "
        f"{plain['epochs']} epochs, {plain['cg_iters']} CG iterations, "
        f"gap {plain['gap']:.3e}")
    rel = abs(kern["obj"] - plain["obj"]) / abs(plain["obj"])
    if not rel <= E2E_RTOL:
        fail(f"final objectives differ: kernels {kern['obj']:.9e}, torch "
             f"{plain['obj']:.9e} (rel {rel:.2e} > {E2E_RTOL:g})")
    log(f"  final objective: kernels {kern['obj']:.9e}, torch "
        f"{plain['obj']:.9e}, rel diff {rel:.2e} (tolerance {E2E_RTOL:g})")
    tag = "x".join(map(str, shape))
    kern["loop"] = capture_turns(
        f"cached GGN-CG {tag}",
        lambda c: timed_chain(method, prob_t, best, keep_x=True, capture=c))
    if timed_mode:
        kern["timed_mode"] = timed_mode_chain(method, prob_t, best, kern)
    return kern, plain, launches, prob_t, best


def timed_mode_chain(method, prob_t, best, fused):
    """Phase 3's chain in timed mode (the JAX package's `_solve_python`:
    the uncached step, a stats record, a time and a host stop test every
    epoch): its times one a record and non-decreasing (checked in
    `timed_chain`), its final objective within E2E_RTOL of the fused
    chain's."""
    solve_chunk(method, prob_t, mode="timed")  # warm-up: the capture
    t = timed_chain(method, prob_t, best, mode="timed")
    rel = abs(t["obj"] - fused["obj"]) / abs(fused["obj"])
    log(f"  timed mode: {t['seconds']:.4f} s, {t['epochs']} epochs, gap "
        f"{t['gap']:.3e}, {t['loop']['host_reads'] / t['solves']:.1f} "
        f"host reads a solve; final objective {t['obj']:.9e} vs the fused "
        f"chain's {fused['obj']:.9e}, rel diff {rel:.2e} (tolerance "
        f"{E2E_RTOL:g})")
    if not rel <= E2E_RTOL:
        fail(f"timed mode's final objective {t['obj']:.9e} differs from "
             f"the fused chain's {fused['obj']:.9e} by {rel:.2e}")
    t.pop("first_info")
    return t


def phase_small_f64(method, what, solve=None, build=None, kernels=None):
    """A small float64 solve through the kernels on the card against the
    plain path on the CPU: the objective histories must agree. ``build``
    (device → problem) defaults to the 512x200 sparse-logistic problem;
    ``kernels``, when given, are the kernels the card's solve must
    launch, and it must launch no other. Returns the card's launches."""
    import torch

    from scso_tpu_torch.ops.cuda import counters

    build = build or (lambda dev: build_problem(512, 200, dev,
                                                torch.float64))
    solve = solve or solve_chunk
    counters.reset()
    gpu = build("cuda")
    s_gpu = solve(method, gpu)
    launched = counters.snapshot()
    if kernels is not None:
        check_launches(launched, kernels, f"small f64 {what}")
    s_cpu = solve(method, build("cpu"))
    if s_gpu.epochs != s_cpu.epochs or s_gpu.x.shape != s_cpu.x.shape:
        fail(f"small f64 {what} solve: epochs {s_gpu.epochs} vs "
             f"{s_cpu.epochs}, x shape {tuple(s_gpu.x.shape)}")
    rel = float(((s_gpu.obj - s_cpu.obj).abs() / s_cpu.obj.abs()).max())
    if not (bool(torch.isfinite(s_gpu.x).all())
            and bool(torch.isfinite(s_cpu.obj).all()) and rel <= SMALL_RTOL):
        fail(f"small f64 {what} solve: objective histories differ by "
             f"{rel:.2e}")
    shape = "x".join(map(str, gpu.A.shape))
    log(f"  small f64 {what} {shape}: {s_gpu.epochs} epochs, card kernels "
        f"vs CPU plain max rel objective diff {rel:.2e} "
        f"(tolerance {SMALL_RTOL:g})")
    return launched


def check_launches(launches, expected, what):
    for k, c in launches.items():
        if (c > 0) != (k in expected):
            fail(f"kernel {k} was launched {c} times on the {what} path")


# ---------------------------------------------------------------------------
# phase 5: the multinomial path
# ---------------------------------------------------------------------------


def build_mglm_problem(m, p, k, device, dtype, seed=11, lam=1e-3):
    import numpy as np

    import scso_tpu_torch as st
    from scso_tpu_torch.models import losses, synthetic

    A, Y, x0, _ = synthetic.make_multinomial_data(m, p, k, seed=seed,
                                                  dtype=np.float32)
    return st.Problem(A, Y, x0, losses.multinom_f, lam,
                      grad_fx=losses.multinom_grad,
                      mglm=losses.multinom_mglm(k), dtype=dtype,
                      device=device)


def mglm_form_and_time(prob, x):
    """K5's form (`mglm_grid`) and time at the multinomial bench shape, on
    the chain's A and Z = A·W at x, beside its plain version's and those
    of its two-pass and split forms (the geometry `mglm_grid` gives them
    at this shape; the split form with the spec's own quad)."""
    import torch

    from scso_tpu_torch.ops.cuda import launch
    from scso_tpu_torch.ops.cuda.mglm_matvec import (
        _launch, mglm_grid, mglm_matvec, mglm_matvec_torch)

    A, y, spec = prob.A, prob.y, prob.mglm
    (m, p), k = A.shape, spec.n_out
    Z = A @ x.reshape(p, k)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    V = torch.randn((p, k), generator=gen, device="cuda", dtype=A.dtype)
    grid = mglm_grid(m, p, k, A.dtype, launch.sm_count(0))
    ms = time_ms(lambda: mglm_matvec(A, y, Z, V, spec))
    plain = time_ms(lambda: mglm_matvec_torch(A, y, Z, V, spec))
    log(f"  K5 at {m}x{p}x{k}: {grid.form} form ({grid.blocks} blocks of "
        f"{grid.threads} threads, {grid.rows_per_block} rows a block, "
        f"{grid.smem_bytes} B of shared memory), {ms:.4f} ms, plain "
        f"{plain:.4f} ms (CUDA events, runs of calls)")
    # the other forms at this shape, in the same call
    grids = {"two_pass": mglm_grid(m, p, k, torch.float64, launch.sm_count(0)),
             "split": mglm_grid(m, p, k, A.dtype, launch.sm_count(0), False)}
    forms = {f: time_ms(lambda g=g: _launch(A, y, Z, V, spec, g))
             for f, g in grids.items()}
    log("  K5's other forms at that shape: " + ", ".join(
        f"{f} {t:.4f} ms" for f, t in forms.items()))
    return dict(form=grid.form, ms=ms, plain_ms=plain,
                **{f"{f}_ms": t for f, t in forms.items()})


def phase_multinomial():
    import dataclasses

    import torch

    import scso_tpu_torch as st
    from scso_tpu_torch._src.struct import replace
    from scso_tpu_torch.ops.cuda import counters

    t0 = time.perf_counter()
    prob = build_mglm_problem(*MGLM_SHAPE, "cuda", torch.float32)
    torch.cuda.synchronize()
    log(f"  data {'x'.join(map(str, MGLM_SHAPE))} made and moved in "
        f"{time.perf_counter() - t0:.1f} s")
    method = st.ProxGGNSCORE(**F32_CG)
    t0 = time.perf_counter()
    best, x_opt, pre_epochs = presolve(method, prob)
    log(f"  presolve: obj* {best:.9e} after {pre_epochs} epochs "
        f"({time.perf_counter() - t0:.1f} s)")
    prob_t = replace(prob, x_star=x_opt)
    solve_chunk(method, prob_t)  # warm-up

    counters.reset()
    kern = timed_chain(method, prob_t, best)
    launches = counters.snapshot()
    log(f"  timed solve, kernels: {kern['seconds']:.4f} s, "
        f"{kern['epochs']} epochs, {kern['cg_iters']} CG iterations, "
        f"gap {kern['gap']:.3e}, launches {launches}")
    if not kern["gap"] <= GAP * 1.05:
        fail(f"the multinomial kernel path missed the {GAP:g} gap: "
             f"{kern['gap']:.3e}")
    check_launches(launches, MGLM_KERNELS, "multinomial")

    plain_method = dataclasses.replace(method, kernels="torch")
    solve_chunk(plain_method, prob_t)  # warm-up
    plain = timed_chain(plain_method, prob_t, best)
    log(f"  timed solve, kernels='torch': {plain['seconds']:.4f} s, "
        f"{plain['epochs']} epochs, {plain['cg_iters']} CG iterations, "
        f"gap {plain['gap']:.3e}")
    rel = abs(kern["obj"] - plain["obj"]) / abs(plain["obj"])
    if not rel <= E2E_RTOL:
        fail(f"multinomial final objectives differ: kernels "
             f"{kern['obj']:.9e}, torch {plain['obj']:.9e} (rel {rel:.2e} "
             f"> {E2E_RTOL:g})")
    log(f"  final objective: kernels {kern['obj']:.9e}, torch "
        f"{plain['obj']:.9e}, rel diff {rel:.2e} (tolerance {E2E_RTOL:g})")
    kern["loop"] = capture_turns(
        "multinomial",
        lambda c: timed_chain(method, prob_t, best, keep_x=True, capture=c))
    kern["k5"] = mglm_form_and_time(prob_t, x_opt)

    # small float64 solve: card kernels against the CPU plain path
    small = (256, 32, 4)
    method64 = st.ProxGGNSCORE(solver="cg", greedy_alpha=False)
    s_gpu = solve_chunk(method64, build_mglm_problem(
        *small, "cuda", torch.float64, lam=1e-2))
    s_cpu = solve_chunk(method64, build_mglm_problem(
        *small, "cpu", torch.float64, lam=1e-2))
    if (s_gpu.epochs != s_cpu.epochs
            or s_gpu.x.shape != (small[1] * small[2],)):
        fail(f"small f64 multinomial solve: epochs {s_gpu.epochs} vs "
             f"{s_cpu.epochs}, x shape {tuple(s_gpu.x.shape)}")
    rel64 = float(((s_gpu.obj - s_cpu.obj).abs() / s_cpu.obj.abs()).max())
    if not bool(torch.isfinite(s_gpu.x).all()) or not rel64 <= SMALL_RTOL:
        fail(f"small f64 multinomial solve: objective histories differ "
             f"by {rel64:.2e}")
    log(f"  small f64 multinomial {'x'.join(map(str, small))}: "
        f"{s_gpu.epochs} epochs, card kernels vs CPU plain max rel "
        f"objective diff {rel64:.2e} (tolerance {SMALL_RTOL:g})")
    return kern, plain, launches, prob_t, best


# ---------------------------------------------------------------------------
# phases 6 and 7: the L-BFGS and the uncached GGN-CG paths
# ---------------------------------------------------------------------------


def solve_lbfgs(method, prob, max_epoch=LBFGS_EPOCHS, capture=True):
    """A fixed number of L-BFGS epochs from x0 (x_tol = f_tol = 0: no
    stopping test fires), stats every 4 epochs."""
    import scso_tpu_torch as st

    return st.iterate(method, prob, "l1", st.PHuberSmootherL1L2(1.0),
                      x_tol=0.0, f_tol=0.0, max_epoch=max_epoch, verbose=0,
                      stats_every=4, _capture=capture)


def lbfgs_run(method, prob, capture):
    """One L-BFGS solve as `capture_turns` reads a run."""
    from scso_tpu_torch.ops.cuda import graph

    graph.reset_stats()
    t0 = time.perf_counter()
    s = solve_lbfgs(method, prob, capture=capture)
    return dict(seconds=time.perf_counter() - t0, epochs=s.epochs,
                cg_iters=0, x=s.x, objs=[s.obj], solves=1,
                loop=dict(graph.STATS))


def phase_lbfgs(prob_t):
    import dataclasses

    import torch

    import scso_tpu_torch as st
    from scso_tpu_torch.ops.cuda import counters

    method = st.ProxLQNSCORE(m=10)
    for mode in ("cuda", "torch"):  # warm-up: the captures
        solve_lbfgs(dataclasses.replace(method, kernels=mode), prob_t)
    runs = {}
    for mode in ("cuda", "torch"):
        m_ = dataclasses.replace(method, kernels=mode)
        counters.reset()
        t0 = time.perf_counter()
        s = solve_lbfgs(m_, prob_t)
        seconds = time.perf_counter() - t0
        launches = counters.snapshot()
        if s.epochs != LBFGS_EPOCHS or not bool(torch.isfinite(s.obj).all()):
            fail(f"L-BFGS ({mode}): {s.epochs} epochs, finite objective "
                 f"{bool(torch.isfinite(s.obj).all())}")
        runs[mode] = (s, dict(seconds=seconds, epochs=s.epochs,
                              ms_per_epoch=1e3 * seconds / s.epochs,
                              gap=float(s.objrel[-1]),
                              obj=float(s.obj[-1])), launches)
        log(f"  L-BFGS {LBFGS_EPOCHS} epochs, kernels={mode!r}: "
            f"{seconds:.4f} s ({1e3 * seconds / s.epochs:.3f} ms an "
            f"epoch), obj {float(s.obj[0]):.6e} at x0 → "
            f"{float(s.obj[-1]):.9e}, gap to the anchor "
            f"{float(s.objrel[-1]):.3e}, launches {launches}")
    (s_k, kern, launches), (s_p, plain, _) = runs["cuda"], runs["torch"]
    check_launches(launches, LBFGS_KERNELS, "L-BFGS")
    rel = float(((s_k.obj - s_p.obj).abs() / s_p.obj.abs()).max())
    if not rel <= LBFGS_RTOL:
        fail(f"L-BFGS objective histories differ by {rel:.2e} "
             f"(> {LBFGS_RTOL:g})")
    log(f"  L-BFGS objective histories, kernels vs torch: max rel diff "
        f"{rel:.2e} (tolerance {LBFGS_RTOL:g})")
    kern["loop"] = capture_turns(
        "L-BFGS", lambda c: lbfgs_run(method, prob_t, c))
    for mem in (10, 100):  # 100: past the old 64-slot limit of K4
        phase_small_f64(st.ProxLQNSCORE(m=mem), f"L-BFGS m={mem}",
                        lambda m_, p: solve_lbfgs(m_, p, max_epoch=40))
    return kern, plain, launches


def phase_uncached(prob_t, best):
    import dataclasses

    import scso_tpu_torch as st
    from scso_tpu_torch.ops.cuda import counters

    method = st.ProxGGNSCORE(**F32_CG, epoch_cache=False)
    warm = lambda m_: solve_chunk(m_, prob_t)  # the capture
    warm(method)
    counters.reset()
    kern = timed_chain(method, prob_t, best)
    launches = counters.snapshot()
    log(f"  timed solve, kernels: {kern['seconds']:.4f} s, "
        f"{kern['epochs']} epochs, {kern['cg_iters']} CG iterations, "
        f"gap {kern['gap']:.3e}, launches {launches}")
    if not kern["gap"] <= GAP * 1.05:
        fail(f"the uncached kernel path missed the {GAP:g} gap: "
             f"{kern['gap']:.3e}")
    check_launches(launches, UNCACHED_KERNELS, "uncached GGN-CG")

    plain_method = dataclasses.replace(method, kernels="torch")
    warm(plain_method)
    plain = timed_chain(plain_method, prob_t, best)
    log(f"  timed solve, kernels='torch': {plain['seconds']:.4f} s, "
        f"{plain['epochs']} epochs, {plain['cg_iters']} CG iterations, "
        f"gap {plain['gap']:.3e}")
    rel = abs(kern["obj"] - plain["obj"]) / abs(plain["obj"])
    if not rel <= E2E_RTOL:
        fail(f"uncached final objectives differ: kernels {kern['obj']:.9e}, "
             f"torch {plain['obj']:.9e} (rel {rel:.2e} > {E2E_RTOL:g})")
    log(f"  final objective: kernels {kern['obj']:.9e}, torch "
        f"{plain['obj']:.9e}, rel diff {rel:.2e} (tolerance {E2E_RTOL:g})")
    kern["loop"] = capture_turns(
        "uncached GGN-CG",
        lambda c: timed_chain(method, prob_t, best, keep_x=True, capture=c))
    phase_small_f64(st.ProxGGNSCORE(solver="cg", greedy_alpha=False,
                                    epoch_cache=False), "uncached GGN-CG")
    return kern, plain, launches


# ---------------------------------------------------------------------------
# phase 10: a GLM spec whose forms the prep kernels do not compute
# ---------------------------------------------------------------------------


def phase_kind_none(prob3, best):
    """Phase 3's problem (``prob3``, anchored at its x*) with
    ``kind=None`` in its GLM spec (as a user builds a GLMSpec) under
    kernels='auto': K1, K2 (its split form) and K3 launch; the chain
    must reach the gap and agree with its kernels='torch' chain."""
    import dataclasses

    import scso_tpu_torch as st
    from scso_tpu_torch._src.struct import replace
    from scso_tpu_torch.ops.cuda import counters

    prob_t = replace(prob3, glm=replace(prob3.glm, kind=None))
    method = st.ProxGGNSCORE(**F32_CG)
    solve_chunk(method, prob_t)  # warm-up
    counters.reset()
    kern = timed_chain(method, prob_t, best)
    launches = counters.snapshot()
    log(f"  timed solve, kernels='auto': {kern['seconds']:.4f} s, "
        f"{kern['epochs']} epochs, {kern['cg_iters']} CG iterations, gap "
        f"{kern['gap']:.3e}, launches {launches}")
    if not kern["gap"] <= GAP * 1.05:
        fail(f"the kind=None chain missed the {GAP:g} gap: {kern['gap']:.3e}")
    check_launches(launches, LOGISTIC_KERNELS, "kind=None logistic")
    plain_method = dataclasses.replace(method, kernels="torch")
    solve_chunk(plain_method, prob_t)  # warm-up
    plain = timed_chain(plain_method, prob_t, best)
    rel = abs(kern["obj"] - plain["obj"]) / abs(plain["obj"])
    log(f"  timed solve, kernels='torch': {plain['seconds']:.4f} s, "
        f"{plain['epochs']} epochs, {plain['cg_iters']} CG iterations; final "
        f"objective rel diff {rel:.2e} (tolerance {E2E_RTOL:g})")
    if not rel <= E2E_RTOL:
        fail(f"kind=None final objectives differ: auto {kern['obj']:.9e}, "
             f"torch {plain['obj']:.9e} (rel {rel:.2e} > {E2E_RTOL:g})")
    return kern, plain, launches


# ---------------------------------------------------------------------------
# phase 11: the cached chain with the bfloat16 copy of A
# ---------------------------------------------------------------------------

LP_KERNELS = LOGISTIC_KERNELS + ("normal_matvec_bf16",)


def lp_chains(prob_t, best, ref_obj, what):
    """The cached chain to the gap on ``prob_t`` (anchored at its x*,
    obj* ``best``) with A in float32 (F32_CG) and with the bfloat16 copy
    (auto_lp=True, which attaches the copy and sets cg_lp_tol to the CG
    floor), in turns f32, lp, lp, f32. Each lp chain must launch K1 on
    the copy (the bulk epochs) and on A (the endgame) and end within
    E2E_RTOL of ``ref_obj`` (None: of this phase's f32 chains). Also
    reports whether AUTO (auto_lp=None) attaches the copy to this A.
    Returns (result dict, the lp chains' launches summed)."""
    import torch

    import scso_tpu_torch as st
    from scso_tpu_torch.algorithms.iterate import _auto_lp
    from scso_tpu_torch.ops.cuda import counters

    f32 = st.ProxGGNSCORE(**F32_CG)
    lp = st.ProxGGNSCORE(**dict(F32_CG, auto_lp=True))
    auto_on = _auto_lp(st.ProxGGNSCORE(**dict(F32_CG, auto_lp=None)),
                       prob_t)[1].A_lp is not None
    solve_chunk(f32, prob_t)  # warm-up
    solve_chunk(lp, prob_t)
    runs = {"f32": [], "lp": []}
    lp_launches = dict.fromkeys(counters.snapshot(), 0)
    for arm in ("f32", "lp", "lp", "f32"):
        counters.reset()
        r = timed_chain(f32 if arm == "f32" else lp, prob_t, best)
        r["launches"] = counters.snapshot()
        runs[arm].append(r)
        lc = r["launches"]
        log(f"  {what}, {arm}: {r['seconds']:.4f} s, {r['epochs']} "
            f"epochs, {r['cg_iters']} CG iterations, gap {r['gap']:.3e}, "
            f"obj {r['obj']:.9e}, launches {lc}")
        if not r["gap"] <= GAP * 1.05:
            fail(f"{what} {arm} chain missed the {GAP:g} gap: {r['gap']:.3e}")
        if arm == "f32":
            check_launches(lc, LOGISTIC_KERNELS, f"{what} f32")
            continue
        check_launches(lc, LP_KERNELS, f"{what} lp")
        if not lc["normal_matvec"] > lc["normal_matvec_bf16"]:
            fail(f"{what} lp chain: K1 never ran on A (the endgame)")
        for k in lp_launches:
            lp_launches[k] += lc[k]
    f32_obj = runs["f32"][0]["obj"]
    ref = f32_obj if ref_obj is None else ref_obj
    for r in runs["lp"]:
        rel = abs(r["obj"] - ref) / abs(ref)
        if not rel <= E2E_RTOL:
            fail(f"{what}: lp final objective {r['obj']:.9e} vs "
                 f"{ref:.9e} (rel {rel:.2e} > {E2E_RTOL:g})")
    secs = {arm: [r["seconds"] for r in rs] for arm, rs in runs.items()}
    a_bytes = prob_t.A.numel() * prob_t.A.element_size()
    won = sum(secs["lp"]) < sum(secs["f32"])
    lc = runs["lp"][0]["launches"]
    log(f"  {what}: A {a_bytes} bytes; f32 chains {secs['f32']} s, lp "
        f"chains {secs['lp']} s: the copy {'won' if won else 'lost'}; lp "
        f"launches K1 on the copy {lc['normal_matvec_bf16']} (bulk), on A "
        f"{lc['normal_matvec'] - lc['normal_matvec_bf16']} (endgame); lp "
        f"final objectives within {E2E_RTOL:g} of {ref:.9e}; AUTO "
        f"(auto_lp=None) {'attaches' if auto_on else 'does not attach'} "
        "the copy here")
    torch.cuda.empty_cache()
    out = dict(a_bytes=a_bytes, lp_won=won, auto_attaches=auto_on,
               **{arm: [{k: r[k] for k in ("seconds", "epochs", "cg_iters",
                                            "obj")} for r in rs]
                  for arm, rs in runs.items()},
               lp_bulk_launches=lc["normal_matvec_bf16"],
               lp_endgame_launches=lc["normal_matvec"]
               - lc["normal_matvec_bf16"])
    return out, lp_launches


def phase_lp(main3, narrow9):
    """Phase 11: ``lp_chains`` on phase 3's and phase 9's anchored
    problems (against their chains' final objectives), and on a smaller
    problem presolved here; then a small float64 solve with the copy,
    cg_adaptive=True and cg_lp_tol=1e-2, through the kernels against the
    CPU plain path on the same copy."""
    import torch

    import scso_tpu_torch as st
    from scso_tpu_torch._src.struct import replace
    from scso_tpu_torch.ops.cuda import counters

    res, launches = {}, None
    for name, (prob_t, best, ref) in (("main", main3), ("narrow", narrow9)):
        shape = tuple(prob_t.A.shape)
        res[name], lc = lp_chains(prob_t, best, ref,
                                  f"{shape[0]}x{shape[1]}")
        launches = lc if launches is None else {
            k: launches[k] + lc[k] for k in launches}
    prob = build_problem(*LP_SMALL_SHAPE, "cuda", torch.float32)
    best, x_opt, _ = presolve(st.ProxGGNSCORE(**F32_CG), prob)
    prob_t = replace(prob, x_star=x_opt)
    del prob
    shape = tuple(prob_t.A.shape)
    res["small"], lc = lp_chains(prob_t, best, None,
                                 f"{shape[0]}x{shape[1]}")
    launches = {k: launches[k] + lc[k] for k in launches}
    del prob_t

    M, N = 512, 200
    method = st.ProxGGNSCORE(solver="cg", greedy_alpha=False,
                             cg_adaptive=True, cg_lp_tol=1e-2)
    cpu = st.with_lp_copy(build_problem(M, N, "cpu", torch.float64))
    gpu = replace(build_problem(M, N, "cuda", torch.float64),
                  A_lp=cpu.A_lp.to("cuda"))
    counters.reset()
    s_gpu = solve_chunk(method, gpu)
    lc = counters.snapshot()
    if not 0 < lc["normal_matvec_bf16"] < lc["normal_matvec"]:
        fail(f"small f64 lp solve: launches {lc}")
    s_cpu = solve_chunk(method, cpu)
    if s_gpu.epochs != s_cpu.epochs or s_gpu.x.shape != (N,):
        fail(f"small f64 lp solve: epochs {s_gpu.epochs} vs "
             f"{s_cpu.epochs}, x shape {tuple(s_gpu.x.shape)}")
    rel = float(((s_gpu.obj - s_cpu.obj).abs() / s_cpu.obj.abs()).max())
    if not bool(torch.isfinite(s_gpu.x).all()) or not rel <= SMALL_RTOL:
        fail(f"small f64 lp solve: objective histories differ by {rel:.2e}")
    log(f"  small f64 lp solve {M}x{N} (cg_adaptive, cg_lp_tol=1e-2): "
        f"{s_gpu.epochs} epochs, K1 on the copy {lc['normal_matvec_bf16']} "
        f"of {lc['normal_matvec']} launches, card kernels vs CPU plain max "
        f"rel objective diff {rel:.2e} (tolerance {SMALL_RTOL:g})")
    return res, launches


# ---------------------------------------------------------------------------
# phase 12: the Newton-CG path
# ---------------------------------------------------------------------------


def build_logreg_100x50(device, dtype=None):
    """The JAX bench's family_logreg_100x50 problem (bench.py): 100x50
    sparse logistic, 0/1 labels, seed 1234, λ = 0.1, with its derivative
    hooks (the dense Newton and GGN solves read hess_fx, out_fn and
    loss_fn)."""
    import numpy as np
    import torch

    import scso_tpu_torch as st
    from scso_tpu_torch.models import losses, synthetic

    A, y, x0, _ = synthetic.make_sparse_logreg_data(
        100, 50, density=0.3, n_active=8, seed=1234, dtype=np.float32,
        label01=True)
    return st.Problem(
        A, y, x0, losses.logistic01_f, 0.1, grad_fx=losses.logistic01_grad,
        hess_fx=losses.logistic01_hess, out_fn=losses.sigmoid_out,
        grad_fy=losses.logistic_ggn_residual,
        hess_fy_diag=losses.logistic_ggn_qdiag,
        loss_fn=losses.logistic_loss_01, hvp_w=losses.logistic01_hvp_w,
        ggn_w=losses.logistic_ggn_w, glm=losses.LOGISTIC01_GLM,
        dtype=dtype or torch.float64, device=device)


def newton_chains(prob, method, what):
    """Phase 12's chain on ``prob``: a presolve anchor with ``method``
    (from x0), then the timed chain with the kernels and with
    kernels='torch'. Returns (kernels result, torch result, launches,
    the anchored problem)."""
    import dataclasses

    import torch

    from scso_tpu_torch._src.struct import replace
    from scso_tpu_torch.ops.cuda import counters

    t0 = time.perf_counter()
    best, x_opt, pre_epochs = presolve(
        method, replace(prob, x_star=torch.zeros_like(prob.x0)))
    log(f"  {what}: presolve obj* {best:.9e} after {pre_epochs} epochs "
        f"({time.perf_counter() - t0:.1f} s)")
    if x_opt is None:
        fail(f"the Newton-CG presolve ({what}) found no finite objective")
    prob_t = replace(prob, x_star=x_opt)
    solve_chunk(method, prob_t)  # warm-up
    counters.reset()
    kern = timed_chain(method, prob_t, best)
    launches = counters.snapshot()
    kern.update(anchor_obj=best, presolve_epochs=pre_epochs)
    log(f"  {what}, timed solve, kernels: {kern['seconds']:.4f} s, "
        f"{kern['epochs']} epochs, {kern['cg_iters']} CG iterations, gap "
        f"{kern['gap']:.3e}, launches {launches}")
    if not kern["gap"] <= GAP * 1.05:
        fail(f"the Newton-CG kernel path ({what}) missed the {GAP:g} gap: "
             f"{kern['gap']:.3e}")
    check_launches(launches, NEWTON_KERNELS, f"Newton-CG ({what})")
    plain_method = dataclasses.replace(method, kernels="torch")
    solve_chunk(plain_method, prob_t)  # warm-up
    plain = timed_chain(plain_method, prob_t, best)
    rel = abs(kern["obj"] - plain["obj"]) / abs(plain["obj"])
    log(f"  {what}, timed solve, kernels='torch': {plain['seconds']:.4f} s, "
        f"{plain['epochs']} epochs, {plain['cg_iters']} CG iterations; final "
        f"objective kernels {kern['obj']:.9e}, torch {plain['obj']:.9e}, rel "
        f"diff {rel:.2e} (tolerance {E2E_RTOL:g})")
    if not rel <= E2E_RTOL:
        fail(f"Newton-CG ({what}) final objectives differ: kernels "
             f"{kern['obj']:.9e}, torch {plain['obj']:.9e} (rel {rel:.2e} > "
             f"{E2E_RTOL:g})")
    return kern, plain, launches, prob_t


def phase_newton(prob3, best3):
    """Phase 12: `newton_chains` on phase 3's problem (``prob3``, whose
    GGN anchor objective is ``best3``) with greedy off, and at λ =
    NEWTON_GREEDY_LAM with greedy AUTO; K2's newton flavour must run in
    the kernel. Then the small float64 Newton and dense GGN solves
    against the CPU. Returns (kernels results, torch results, launches,
    (a)'s anchored problem)."""
    import torch

    import scso_tpu_torch as st
    from scso_tpu_torch._src.struct import replace
    from scso_tpu_torch.ops.cuda import launch
    from scso_tpu_torch.ops.cuda.glm_prep import covers, prep_grid

    m, n = prob3.A.shape
    grid = prep_grid(m, n, prob3.A.dtype, 2, launch.sm_count(0),
                     covers(prob3.glm))
    if grid.form != "one_pass":
        fail(f"K2's newton flavour would run its {grid.form} form at "
             f"{m}x{n}")
    log(f"  K2's newton flavour at {m}x{n}: its {grid.form} form")
    kern, plain, launches, nprob_t = newton_chains(
        prob3, st.ProxNSCORE(**NEWTON_GREEDY_OFF), "λ = 0.01, greedy off")
    log(f"  phase 3's GGN anchor {best3:.9e}; Newton's "
        f"{kern['anchor_obj']:.9e}")
    lam = torch.tensor(NEWTON_GREEDY_LAM, dtype=prob3.dtype,
                       device=prob3.device)
    gkern, gplain, glaunches, _ = newton_chains(
        replace(prob3, lam=lam), st.ProxNSCORE(**NEWTON_CG),
        f"λ = {NEWTON_GREEDY_LAM:g}, greedy AUTO")
    kern["greedy"], plain["greedy"] = gkern, gplain
    launches = {k: launches[k] + glaunches[k] for k in launches}
    # (c) phase 3's configuration: the greedy trial's full Newton steps
    # run away on this data, in the JAX package too. Both modes must
    # turn non-finite at the same record, or end at the same objective
    # (the launches are not the path's: they are left out of the counts)
    hist = {}
    for mode in ("cuda", "torch"):
        s = solve_chunk(st.ProxNSCORE(**NEWTON_CG, kernels=mode), prob3)
        hist[mode] = h = s.obj.double().cpu()
        bad = (~torch.isfinite(h)).nonzero()
        (kern if mode == "cuda" else plain)["lam001_greedy"] = dict(
            epochs=s.epochs, obj=float(h[-1]),
            first_non_finite=int(bad[0]) if len(bad) else None)
        log(f"  λ = 0.01, greedy AUTO (phase 3's configuration), "
            f"kernels={mode!r}: {s.epochs} epochs from x0, records "
            f"{[float(v) for v in h]}")
    k_bad = kern["lam001_greedy"]["first_non_finite"]
    p_bad = plain["lam001_greedy"]["first_non_finite"]
    if k_bad != p_bad:
        fail(f"λ = 0.01, greedy AUTO: the first non-finite record is "
             f"{k_bad} with the kernels, {p_bad} with kernels='torch'")
    h_k, h_p = hist["cuda"], hist["torch"]
    if k_bad is None:
        final = abs(float(h_k[-1] - h_p[-1])) / abs(float(h_p[-1]))
        if not final <= E2E_RTOL:
            fail(f"λ = 0.01, greedy AUTO: final objectives differ by "
                 f"{final:.2e}")
    r = min(len(h_k), len(h_p))
    fin = torch.isfinite(h_k[:r]) & torch.isfinite(h_p[:r])
    rel = float(((h_k[:r] - h_p[:r]).abs() / h_p[:r].abs())[fin].max())
    log(f"  λ = 0.01, greedy AUTO: first non-finite record {k_bad} in both "
        f"modes; their finite records differ by at most {rel:.2e} relative")
    torch.cuda.empty_cache()

    # small float64 solves, card kernels against the CPU plain path (λ =
    # 0.1 for the logistic problem: at 0.01 damped Newton diverges on it)
    small = lambda dev: build_problem(512, 200, dev, torch.float64, lam=0.1)
    phase_small_f64(st.ProxNSCORE(solver="cg", greedy_alpha=False),
                    "cached Newton-CG", build=small, kernels=NEWTON_KERNELS)
    phase_small_f64(st.ProxNSCORE(solver="cg", ss_type=3),
                    "uncached Newton-CG (ss_type 3)", build=small,
                    kernels=("normal_matvec", "score_update"))
    phase_small_f64(st.ProxNSCORE(solver="cg", greedy_alpha=False),
                    "multinomial Newton-CG",
                    build=lambda dev: build_mglm_problem(
                        256, 32, 4, dev, torch.float64, lam=1e-2),
                    kernels=MGLM_KERNELS)
    for name, meth in (
            ("dense Newton", st.ProxNSCORE(solver="dense")),
            ("dense_dual GGN", st.ProxGGNSCORE(solver="dense_dual")),
            ("dense_primal GGN", st.ProxGGNSCORE(solver="dense_primal"))):
        phase_small_f64(meth, f"{name}, family_logreg_100x50",
                        build=build_logreg_100x50,
                        kernels=("score_update",))
    return kern, plain, launches, nprob_t


# ---------------------------------------------------------------------------
# phase 13: iterate_mixed, and the cached multinomial chain with the copy
# ---------------------------------------------------------------------------

# the kernels of iterate_mixed's two phases: the coarse one's with A in
# bfloat16, the fine one's with A in float32
MIXED_KERNELS = LOGISTIC_KERNELS + ("glm_prep_pair_bf16", "normal_matvec_bf16")
MIXED_MGLM_KERNELS = MGLM_KERNELS + ("mglm_matvec_bf16",)
# phase 13(c)'s smaller multinomial problem, for AUTO's byte threshold on
# the cached multinomial path (a quarter of MGLM_SHAPE's rows)
MGLM_LP_SMALL_SHAPE = (49152, 1024, 16)


def mixed_solve(method, prob):
    """`st.iterate_mixed` with the chain's options for the fine phase and
    the coarse defaults (coarse_f_tol=1e-3, coarse_max_epoch=50)."""
    import scso_tpu_torch as st

    return st.iterate_mixed(method, prob, "l1", st.PHuberSmootherL1L2(1.0),
                            **CHUNK_KW)


def turns(arms, prob_t, best, what):
    """Chains on ``prob_t`` (anchored at obj* ``best``) in the order of
    ``arms`` ((label, method, first or None) triples, `timed_chain`'s
    ``first``), each to the gap: {label: [results]}, each with its
    launches and bf16 products; an iterate_mixed chain also with its
    coarse phase's epochs and CG iterations (its first `iterate`'s
    Solution, caught by wrapping `iterate`)."""
    from scso_tpu_torch.algorithms import iterate as it_mod
    from scso_tpu_torch.ops.cuda import counters

    # one untimed chain of each arm first: it makes the captures that
    # the timed chains replay
    for label in dict.fromkeys(label for label, _, _ in arms):
        _, method, first = next(a for a in arms if a[0] == label)
        timed_chain(method, prob_t, best, first=first)
    runs = {}
    for label, method, first in arms:
        real, sols = it_mod.iterate, []

        def spy(*a, **kw):
            sols.append(real(*a, **kw))
            return sols[-1]

        counters.reset()
        it_mod.iterate = spy
        try:
            r = timed_chain(method, prob_t, best, first=first)
        finally:
            it_mod.iterate = real
        r["launches"] = counters.snapshot()
        r["bf16_products"] = counters.bf16_products()
        if first is mixed_solve:
            coarse = sols[0]
            r["coarse_epochs"] = coarse.epochs
            r["coarse_cg_iters"] = (coarse.cg_info or {}).get(
                "total_cg_iters", 0)
            r["fine_epochs"] = r["epochs"]
        runs.setdefault(label, []).append(r)
        extra = (f", coarse {r['coarse_epochs']} epochs and "
                 f"{r['coarse_cg_iters']} CG iterations"
                 if "coarse_epochs" in r else "")
        log(f"  {what}, {label}: {r['seconds']:.4f} s, {r['epochs']} "
            f"epochs, {r['cg_iters']} CG iterations{extra}, gap "
            f"{r['gap']:.3e}, obj {r['obj']:.9e}, launches {r['launches']}, "
            f"bf16 products {r['bf16_products']}")
        if not r["gap"] <= GAP * 1.05:
            fail(f"{what} {label} chain missed the {GAP:g} gap: "
                 f"{r['gap']:.3e}")
    return runs


def check_mixed(runs, ref_obj, expected, prep, what):
    """iterate_mixed's chains: only ``expected`` kernels launched, the
    coarse phase's prep (``prep``_bf16) at least once an epoch, K1 (or
    K5) on the bfloat16 A at least once a coarse CG iteration, and the
    final objective within E2E_RTOL of ``ref_obj``."""
    matvec = ("normal_matvec_bf16" if "normal_matvec_bf16" in expected
              else "mglm_matvec_bf16")
    for r in runs:
        lc = r["launches"]
        check_launches(lc, expected, what)
        if prep is not None and not lc[prep] >= r["coarse_epochs"]:
            fail(f"{what}: {prep} launched {lc[prep]} times in "
                 f"{r['coarse_epochs']} coarse epochs")
        if not lc[matvec] >= max(1, r["coarse_cg_iters"]):
            fail(f"{what}: {matvec} launched {lc[matvec]} times for "
                 f"{r['coarse_cg_iters']} coarse CG iterations")
        rel = abs(r["obj"] - ref_obj) / abs(ref_obj)
        if not rel <= E2E_RTOL:
            fail(f"{what}: final objective {r['obj']:.9e} vs {ref_obj:.9e} "
                 f"(rel {rel:.2e} > {E2E_RTOL:g})")


def summary(runs):
    return {label: [{k: r[k] for k in ("seconds", "epochs", "cg_iters",
                                       "obj", "coarse_epochs",
                                       "coarse_cg_iters", "bf16_products")
                     if k in r} for r in rs] for label, rs in runs.items()}


def mglm_lp_turns(prob_t, best, what):
    """13(c): the cached multinomial chain with A in float32 and with the
    bfloat16 copy (auto_lp=True: K5 on the copy while the forcing sits
    at the floor), in turns f32, lp, lp, f32, five times; each lp chain
    within E2E_RTOL of the first f32 chain. The copy wins when the median of
    its chains' seconds is below the f32 chains' median by more than
    half the f32 chains' spread (the host's clock varies from chain to
    chain). Reports that, and whether AUTO (auto_lp=None) attaches the
    copy at this size."""
    import scso_tpu_torch as st
    from scso_tpu_torch.algorithms.iterate import _auto_lp

    f32 = st.ProxGGNSCORE(**F32_CG)
    lp = st.ProxGGNSCORE(**dict(F32_CG, auto_lp=True))
    auto_on = _auto_lp(st.ProxGGNSCORE(**dict(F32_CG, auto_lp=None)),
                       prob_t)[1].A_lp is not None
    runs = turns([("f32", f32, None), ("lp", lp, None), ("lp", lp, None),
                  ("f32", f32, None)] * 5, prob_t, best, what)
    ref = runs["f32"][0]["obj"]
    for r in runs["lp"]:
        check_launches(r["launches"], MIXED_MGLM_KERNELS, f"{what} lp")
        if not r["launches"]["mglm_matvec_bf16"] > 0:
            fail(f"{what} lp chain: K5 never ran on the copy")
        rel = abs(r["obj"] - ref) / abs(ref)
        if not rel <= E2E_RTOL:
            fail(f"{what}: lp final objective {r['obj']:.9e} vs {ref:.9e} "
                 f"(rel {rel:.2e} > {E2E_RTOL:g})")
    for r in runs["f32"]:
        check_launches(r["launches"], MGLM_KERNELS, f"{what} f32")
    secs = {arm: [r["seconds"] for r in rs] for arm, rs in runs.items()}
    med = {arm: statistics.median(t) for arm, t in secs.items()}
    spread = max(secs["f32"]) - min(secs["f32"])
    won = med["lp"] < med["f32"] - spread / 2
    lc = runs["lp"][0]["launches"]
    a_bytes = prob_t.A.numel() * prob_t.A.element_size()
    log(f"  {what}: A {a_bytes} bytes; f32 chains {secs['f32']} s "
        f"(median {med['f32']:.4f}), lp chains {secs['lp']} s (median "
        f"{med['lp']:.4f}): the copy {'won' if won else 'did not win'}; lp "
        f"launches K5 on the copy {lc['mglm_matvec_bf16']}, on A "
        f"{lc['mglm_matvec'] - lc['mglm_matvec_bf16']}; AUTO "
        f"(auto_lp=None) {'attaches' if auto_on else 'does not attach'} "
        "the copy here")
    return dict(a_bytes=a_bytes, lp_won=won, auto_attaches=auto_on,
                median_s=med, **summary(runs))


def phase_mixed(main3, newton12, mglm5):
    """Phase 13. (a) iterate_mixed on phase 3's anchored problem
    (``main3``: the problem, its anchor objective, phase 3's and phase
    7's final objectives) in turns with phase 3's f32 chain and phase
    11's lp chain (f32, lp, mixed, mixed, lp, f32), each to the gap;
    then one iterate_mixed chain on the uncached GGN-CG path (against
    phase 7's objective) and one of Newton-CG with greedy off on phase
    12(a)'s anchored problem (``newton12``: the problem, its anchor,
    12(a)'s final objective); (b) iterate_mixed on phase 5's problem
    (``mglm5``), in turns with its f32 chain; (c) `mglm_lp_turns` at
    MGLM_SHAPE and MGLM_LP_SMALL_SHAPE; (d) small float64 iterate_mixed
    solves through the kernels against the CPU plain path. Returns
    (results, the mixed and lp chains' launches summed)."""
    import torch

    import scso_tpu_torch as st
    from scso_tpu_torch._src.struct import replace

    res, launches = {}, None

    def add(runs, labels):
        nonlocal launches
        for label in labels:
            for r in runs.get(label, []):
                lc = r["launches"]
                launches = lc if launches is None else {
                    k: launches[k] + lc[k] for k in launches}

    prob3, best3, obj3, obj7 = main3
    prob5, best5, obj5 = mglm5
    f32 = st.ProxGGNSCORE(**F32_CG)
    lp = st.ProxGGNSCORE(**dict(F32_CG, auto_lp=True))
    st.iterate_mixed(f32, prob3, "l1", st.PHuberSmootherL1L2(1.0),
                     **dict(CHUNK_KW, max_epoch=2), coarse_max_epoch=2)
    shape = "x".join(map(str, prob3.A.shape))
    log(f" (a) {shape}: f32, lp, mixed, mixed, lp, f32; then mixed on "
        "the uncached and the Newton-CG paths")
    runs = turns([("f32", f32, None), ("lp", lp, None),
                  ("mixed", f32, mixed_solve), ("mixed", f32, mixed_solve),
                  ("lp", lp, None), ("f32", f32, None)], prob3, best3,
                 f"mixed {shape}")
    check_mixed(runs["mixed"], obj3, MIXED_KERNELS, "glm_prep_pair_bf16",
                f"mixed {shape}")
    for r in runs["f32"]:
        check_launches(r["launches"], LOGISTIC_KERNELS, f"{shape} f32")
    for r in runs["lp"]:
        check_launches(r["launches"], LOGISTIC_KERNELS
                       + ("normal_matvec_bf16",), f"{shape} lp")
    res["main"] = summary(runs)
    add(runs, ("mixed",))
    # the uncached GGN-CG and the Newton-CG paths' coarse phases: K2s and
    # K2's newton flavour with A in bfloat16
    unc = st.ProxGGNSCORE(**F32_CG, epoch_cache=False)
    runs = turns([("mixed", unc, mixed_solve)], prob3, best3,
                 f"mixed uncached {shape}")
    check_mixed(runs["mixed"], obj7, ("glm_prep", "glm_prep_bf16",
                                      "normal_matvec", "normal_matvec_bf16",
                                      "score_update"),
                "glm_prep_bf16", f"mixed uncached {shape}")
    res["uncached"] = summary(runs)
    add(runs, ("mixed",))
    nprob, nbest, nobj = newton12
    newton = st.ProxNSCORE(**NEWTON_GREEDY_OFF)
    runs = turns([("mixed", newton, mixed_solve)], nprob, nbest,
                 f"mixed Newton-CG {shape}")
    check_mixed(runs["mixed"], nobj, NEWTON_KERNELS + (
        "glm_prep_pair_newton_bf16", "normal_matvec_bf16"),
        "glm_prep_pair_newton_bf16", f"mixed Newton-CG {shape}")
    res["newton"] = summary(runs)
    add(runs, ("mixed",))
    torch.cuda.empty_cache()

    shape = "x".join(map(str, MGLM_SHAPE))
    log(f" (b) {shape}: f32, mixed, mixed, f32")
    m5 = st.ProxGGNSCORE(**F32_CG)
    runs = turns([("f32", m5, None), ("mixed", m5, mixed_solve),
                  ("mixed", m5, mixed_solve), ("f32", m5, None)], prob5,
                 best5, f"mixed {shape}")
    check_mixed(runs["mixed"], obj5, MIXED_MGLM_KERNELS, None,
                f"mixed {shape}")
    res["multinomial"] = summary(runs)
    add(runs, ("mixed",))

    log(" (c) the cached multinomial chain with the bfloat16 copy")
    res["mglm_lp"] = {"main": mglm_lp_turns(prob5, best5, f"lp {shape}")}
    small = build_mglm_problem(*MGLM_LP_SMALL_SHAPE, "cuda", torch.float32)
    sbest, sx, _ = presolve(m5, small)
    small = replace(small, x_star=sx)
    res["mglm_lp"]["small"] = mglm_lp_turns(
        small, sbest, "lp " + "x".join(map(str, MGLM_LP_SMALL_SHAPE)))
    del small
    torch.cuda.empty_cache()

    log(" (d) small float64 iterate_mixed solves, card against CPU")
    logreg = lambda lam: (lambda dev: build_problem(512, 200, dev,
                                                    torch.float64, lam=lam))
    for method, what, build, kernels in (
            (st.ProxGGNSCORE(solver="cg", greedy_alpha=False),
             "iterate_mixed, cached GGN-CG", logreg(0.01),
             MIXED_KERNELS),
            (st.ProxGGNSCORE(solver="cg", greedy_alpha=False,
                             epoch_cache=False),
             "iterate_mixed, uncached GGN-CG", logreg(0.01),
             ("glm_prep", "glm_prep_bf16", "normal_matvec",
              "normal_matvec_bf16", "score_update")),
            (st.ProxNSCORE(solver="cg", greedy_alpha=False),
             "iterate_mixed, Newton-CG", logreg(0.1),
             ("glm_prep_pair_newton", "glm_prep_pair_newton_bf16",
              "normal_matvec", "normal_matvec_bf16", "score_update")),
            (st.ProxLQNSCORE(), "iterate_mixed, L-BFGS", logreg(0.01),
             LBFGS_KERNELS),
            (st.ProxGGNSCORE(solver="cg", greedy_alpha=False),
             "iterate_mixed, multinomial",
             lambda dev: build_mglm_problem(256, 32, 4, dev, torch.float64,
                                            lam=1e-2),
             MIXED_MGLM_KERNELS)):
        phase_small_f64(method, what, solve=mixed_solve, build=build,
                        kernels=kernels)
    return res, launches


# ---------------------------------------------------------------------------
# phase 14: the sparse-group-lasso λ₂ path (least squares, K2's lsq kind)
# ---------------------------------------------------------------------------


def build_gl_problem(data, device, dtype, data_dtype=None):
    """bench.py's family_gl_path problem: make_group_lasso_problem(m, n,
    16, p_active=0.1, noise_std=0.1, seed=1234), LSQ_GLM with its hooks,
    λ = [1e-8, 0.1], x* the generator's x, padded to a multiple of 128
    with the zero-weight pad group."""
    import numpy as np

    import scso_tpu_torch as st
    from scso_tpu_torch.models import losses, synthetic

    A, y, x_true, x0, groups = synthetic.make_group_lasso_problem(
        *data, GL_GROUP, p_active=0.1, noise_std=0.1, seed=1234,
        dtype=data_dtype or np.float32)
    lam2 = float(np.logspace(-1, -4, GL_PATH).astype(np.float32)[0])
    return st.Problem(
        A, y, x0, losses.lsq_f, [1e-8, lam2], grad_fx=losses.lsq_grad,
        out_fn=losses.linear_out, loss_fn=losses.lsq_loss,
        grad_fy=losses.lsq_ggn_residual, hess_fy_diag=losses.lsq_ggn_qdiag,
        glm=losses.LSQ_GLM, sol=x_true, groups=groups, dtype=dtype,
        device=device, pad_features=True)


def gl_solve(method, prob, **kw):
    import scso_tpu_torch as st

    return st.iterate(method, prob, "gl", st.PHuberSmootherGL(1e-2, prob),
                      **{**GL_KW, **kw})


def gl_path(method, prob, anchors=None):
    """bench.py's family_gl_path protocol: for λ₂ in logspace(-1, -4, 8),
    a presolve of at most 6 chunks (f_tol=0) from the previous point's x
    fixes the point's anchor (its best chunk), then timed chunks from
    that x at f_tol=1e-6, chained until the signed gap (obj − obj*)/|obj*|
    is at most 1e-6 or stops improving. (bench.py's untimed warm-up
    solves are jit dispatches; here one untimed solve with the timed
    chunks' options, at the first point, captures the graph that every
    timed chunk replays.) With
    ``anchors`` — another run's points — the timed chunks alone, from
    those points' x, λ and anchors. Returns the timed seconds, epochs,
    CG iterations, worst gap and the points (x_warm, λ, x*, obj*, final
    objective, gap)."""
    import numpy as np
    import torch

    from scso_tpu_torch._src.struct import replace

    t_path, epochs, cg, worst = 0.0, 0, 0, 0.0
    points, x_warm = [], prob.x0
    grid = np.logspace(-1, -4, GL_PATH).astype(np.float32)
    for i, lam2 in enumerate(grid[:len(anchors) if anchors else None]):
        if anchors:
            x_warm, lamv, x_opt, best = anchors[i][:4]
        else:
            lamv = torch.tensor([1e-8, float(lam2)], dtype=prob.dtype,
                                device=prob.device)
            cur, best, x_opt = replace(prob, lam=lamv, x0=x_warm), np.inf, None
            for _ in range(6):
                s = gl_solve(method, cur, f_tol=0.0)
                obj = float(s.obj[-1])
                improved = obj < best * (1 - 1e-7)
                if obj < best:
                    best, x_opt = obj, s.state.x
                if not improved:
                    break
                cur = replace(cur, x0=s.state.x)
        cur_t = replace(prob, lam=lamv, x0=x_warm, x_star=x_opt)
        if i == 0:
            gl_solve(method, cur_t, f_tol=1e-6)  # warm-up: the capture
        pt_gap = np.inf
        for _ in range(6):
            t0 = time.perf_counter()
            s = gl_solve(method, cur_t, f_tol=1e-6)
            t_path += time.perf_counter() - t0
            epochs += s.epochs
            cg += (s.cg_info or {}).get("total_cg_iters", 0)
            gap = float(((s.obj.double() - best) / abs(best)).min())
            improved = gap < pt_gap - 1e-8
            pt_gap = min(pt_gap, gap)
            if pt_gap <= 1e-6 or not improved:
                break
            cur_t = replace(cur_t, x0=s.state.x)
        # a below-anchor finish counts as the target, as in bench.py
        worst = max(worst, max(pt_gap, 1e-6) if pt_gap <= 1e-6 else pt_gap)
        points.append((x_warm, lamv, x_opt, best, float(s.obj[-1]), pt_gap))
        x_warm = s.state.x
    return t_path, epochs, cg, worst, points


def phase_gl_path():
    """The sparse-group-lasso λ₂ path at full width (bench.py's
    family_gl_path(big=True)) through the kernels: K1 and K2 with the
    lsq kind in the kernel, no other kernel (the 'gl' prox's tail is not
    K3's); worst gap ≤ GL_GAP_LIMIT; each point's final objective
    against the kernels='torch' chain from the same x and anchor. Then
    small float64 group-lasso solves against the CPU."""
    import dataclasses

    import numpy as np
    import torch

    import scso_tpu_torch as st
    from scso_tpu_torch.ops.cuda import counters

    t0 = time.perf_counter()
    prob = build_gl_problem(GL_DATA, "cuda", torch.float32)
    torch.cuda.synchronize()
    a_bytes = prob.A.numel() * prob.A.element_size()
    log(f"  data {GL_DATA[0]}x{GL_DATA[1]} padded to {tuple(prob.A.shape)} "
        f"({prob.groups.n_groups} groups, the last the zero-weight pad "
        f"group), A {a_bytes} bytes ({a_bytes / 1e9:.2f} GB) on the card, "
        f"made and moved in {time.perf_counter() - t0:.1f} s")
    method = st.ProxGGNSCORE(**F32_CG)
    t0 = time.perf_counter()
    counters.reset()
    secs, epochs, cg, worst, points = gl_path(method, prob)
    launches = counters.snapshot()
    wall = time.perf_counter() - t0
    log(f"  path, kernels: timed solves {secs:.4f} s, {epochs} epochs, "
        f"{cg} CG iterations, worst gap {worst:.3e} (whole path with "
        f"presolves {wall:.1f} s), launches {launches}")
    for i, p in enumerate(points):
        log(f"   point {i}: λ₂ {float(p[1][1]):.3e}, obj* {p[3]:.9e}, final "
            f"{p[4]:.9e}, signed gap {p[5]:.3e}, nnz "
            f"{int((p[2] != 0).sum())}")
    if not worst <= GL_GAP_LIMIT:
        fail(f"the group-lasso path's worst gap {worst:.3e} exceeds "
             f"{GL_GAP_LIMIT:g}")
    check_launches(launches, GL_KERNELS, "group-lasso")
    if launches["glm_prep_pair_lsq"] != launches["glm_prep_pair"]:
        fail(f"group-lasso path: {launches['glm_prep_pair']} K2 launches, "
             f"{launches['glm_prep_pair_lsq']} with the lsq kind in the "
             "kernel")
    plain_method = dataclasses.replace(method, kernels="torch")
    t0 = time.perf_counter()
    psecs, pepochs, pcg, pworst, ppoints = gl_path(plain_method, prob,
                                                   anchors=points)
    rels = [abs(k[4] - p[4]) / abs(p[4]) for k, p in zip(points, ppoints)]
    log(f"  path, kernels='torch' (all {len(ppoints)} points, timed "
        f"chains from the kernels run's x and anchors): {psecs:.4f} s, "
        f"{pepochs} epochs, {pcg} CG iterations, worst gap {pworst:.3e} "
        f"({time.perf_counter() - t0:.1f} s); final objectives' max rel "
        f"diff {max(rels):.2e} (tolerance {E2E_RTOL:g})")
    if not max(rels) <= E2E_RTOL:
        fail(f"group-lasso path: final objectives differ by {max(rels):.2e}")
    res = dict(seconds=secs, epochs=epochs, cg_iters=cg, worst_gap=worst,
               a_bytes=a_bytes, torch_seconds=psecs, torch_epochs=pepochs,
               objs=[p[4] for p in points])
    del prob, points, ppoints
    torch.cuda.empty_cache()

    small = dict(x_tol=1e-12, f_tol=1e-10, max_epoch=40)
    gl_small = lambda dev: build_gl_problem((512, 128), dev, torch.float64,
                                            np.float64)
    solve = lambda m, p: gl_solve(m, p, **small)
    mixed = lambda m, p: st.iterate_mixed(
        m, p, "gl", st.PHuberSmootherGL(1e-2, p), **{**GL_KW, **small})
    small_launches = {}
    for method, what, run, kernels in (
            (st.ProxGGNSCORE(**F32_CG), "group-lasso GGN-CG", solve,
             GL_KERNELS),
            (st.ProxGGNSCORE(**F32_CG, epoch_cache=False),
             "group-lasso uncached GGN-CG", solve,
             ("normal_matvec", "glm_prep", "glm_prep_lsq")),
            (st.ProxGGNSCORE(**F32_CG), "group-lasso iterate_mixed, cached",
             mixed, GL_KERNELS + ("normal_matvec_bf16", "glm_prep_pair_bf16",
                                  "glm_prep_pair_lsq_bf16")),
            (st.ProxGGNSCORE(**F32_CG, epoch_cache=False),
             "group-lasso iterate_mixed, uncached", mixed,
             ("normal_matvec", "glm_prep", "glm_prep_lsq",
              "normal_matvec_bf16", "glm_prep_bf16", "glm_prep_lsq_bf16"))):
        got = phase_small_f64(method, what, solve=run, build=gl_small,
                              kernels=kernels)
        small_launches = {k: small_launches.get(k, 0) + c
                          for k, c in got.items()}
    return res, {k: launches[k] + small_launches[k] for k in launches}


# ---------------------------------------------------------------------------
# phase 15: the Poisson l1 path (K2's poisson kind)
# ---------------------------------------------------------------------------


def build_poisson_problem(M, N, device, dtype, lam, density=0.05,
                          n_active=64, data_dtype=None, pad=True):
    """make_sparse_poisson_data(M, N) at seed 7 with POISSON_GLM and its
    hooks, as examples/07_poisson.py builds the problem."""
    import numpy as np

    import scso_tpu_torch as st
    from scso_tpu_torch.models import losses, synthetic

    A, y, x0, x_true = synthetic.make_sparse_poisson_data(
        M, N, density=density, n_active=n_active, seed=SEED,
        dtype=data_dtype or np.float32)
    return st.Problem(
        A, y, x0, losses.poisson_f, lam, grad_fx=losses.poisson_grad,
        hess_fx=losses.poisson_hess, out_fn=losses.exp_out,
        grad_fy=losses.poisson_ggn_residual,
        hess_fy_diag=losses.poisson_ggn_qdiag, loss_fn=losses.poisson_loss,
        hvp_w=losses.poisson_hvp_w, ggn_w=losses.poisson_ggn_w,
        glm=losses.POISSON_GLM, dtype=dtype, device=device,
        pad_features=pad, sol=None if pad else x_true)


def phase_poisson():
    """The Poisson l1 path at the main path's shape under phase 3's
    protocol (presolve anchor, timed chain from x0 to the 1e-6 gap): K1,
    K2 with the poisson kind in the kernel, and K3; the kernels='torch'
    chain must agree on the final objective. Then small float64 Poisson
    solves against the CPU."""
    import dataclasses

    import numpy as np
    import torch

    import scso_tpu_torch as st
    from scso_tpu_torch._src.struct import replace
    from scso_tpu_torch.ops.cuda import counters

    t0 = time.perf_counter()
    prob = build_poisson_problem(*MAIN_SHAPE, "cuda", torch.float32,
                                 POISSON_LAMS[0])
    torch.cuda.synchronize()
    log(f"  data {MAIN_SHAPE[0]}x{MAIN_SHAPE[1]} padded to "
        f"{tuple(prob.A.shape)}, made and moved in "
        f"{time.perf_counter() - t0:.1f} s")
    method = st.ProxGGNSCORE(**F32_CG)
    for lam in POISSON_LAMS:
        prob = replace(prob, lam=torch.tensor(lam, dtype=prob.dtype,
                                              device=prob.device))
        t0 = time.perf_counter()
        best, x_opt, pre_epochs = presolve(method, prob)
        nnz = int((x_opt != 0).sum())
        log(f"  λ = {lam:g}: presolve obj* {best:.9e}, nnz {nnz}, after "
            f"{pre_epochs} epochs ({time.perf_counter() - t0:.1f} s)")
        prob_t = replace(prob, x_star=x_opt)
        counters.reset()
        kern = timed_chain(method, prob_t, best)
        launches = counters.snapshot()
        log(f"  timed solve, kernels: {kern['seconds']:.4f} s, "
            f"{kern['epochs']} epochs, {kern['cg_iters']} CG iterations, "
            f"gap {kern['gap']:.3e}, launches {launches}")
        if nnz > 0 and kern["epochs"] >= 5:
            break
        log(f"  λ = {lam:g} gives a trivial path (nnz {nnz}, "
            f"{kern['epochs']} epochs)")
    log(f"  λ used: {lam:g}")
    if not kern["gap"] <= GAP * 1.05:
        fail(f"the Poisson path missed the {GAP:g} gap: {kern['gap']:.3e}")
    check_launches(launches, POISSON_KERNELS, "Poisson")
    if launches["glm_prep_pair_poisson"] != launches["glm_prep_pair"]:
        fail(f"Poisson path: {launches['glm_prep_pair']} K2 launches, "
             f"{launches['glm_prep_pair_poisson']} with the poisson kind in "
             "the kernel")
    plain = timed_chain(dataclasses.replace(method, kernels="torch"),
                        prob_t, best)
    rel = abs(kern["obj"] - plain["obj"]) / abs(plain["obj"])
    log(f"  timed solve, kernels='torch': {plain['seconds']:.4f} s, "
        f"{plain['epochs']} epochs, {plain['cg_iters']} CG iterations; "
        f"final objective rel diff {rel:.2e} (tolerance {E2E_RTOL:g})")
    if not rel <= E2E_RTOL:
        fail(f"Poisson final objectives differ: kernels {kern['obj']:.9e}, "
             f"torch {plain['obj']:.9e} (rel {rel:.2e} > {E2E_RTOL:g})")
    kern["lam"] = lam
    del prob, prob_t
    torch.cuda.empty_cache()

    small = lambda dev: build_poisson_problem(
        2000, 192, dev, torch.float64, 5e-2, density=0.08, n_active=12,
        data_dtype=np.float64, pad=False)
    cached = ("normal_matvec", "glm_prep_pair", "glm_prep_pair_poisson",
              "score_update")
    uncached = ("normal_matvec", "glm_prep", "glm_prep_poisson",
                "score_update")
    newton = ("normal_matvec", "glm_prep_pair_newton",
              "glm_prep_pair_newton_poisson", "score_update")
    bf16 = lambda ks: ks + tuple(f"{k}_bf16" for k in ks
                                 if k != "score_update")
    small_launches = {}
    for meth, what, run, kernels in (
            (st.ProxGGNSCORE(solver="cg"), "Poisson GGN-CG", None, cached),
            (st.ProxGGNSCORE(solver="cg", epoch_cache=False),
             "Poisson uncached GGN-CG", None, uncached),
            (st.ProxNSCORE(solver="cg"), "Poisson Newton-CG", None, newton),
            (st.ProxGGNSCORE(solver="cg"), "Poisson iterate_mixed, cached",
             mixed_solve, bf16(cached)),
            (st.ProxGGNSCORE(solver="cg", epoch_cache=False),
             "Poisson iterate_mixed, uncached", mixed_solve, bf16(uncached)),
            (st.ProxNSCORE(solver="cg"), "Poisson iterate_mixed, Newton-CG",
             mixed_solve, bf16(newton))):
        got = phase_small_f64(meth, what, solve=run, build=small,
                              kernels=kernels)
        small_launches = {k: small_launches.get(k, 0) + c
                          for k, c in got.items()}
    return kern, plain, {k: launches[k] + small_launches[k]
                         for k in launches}


# ---------------------------------------------------------------------------
# phase 8: the row-sharded cached GGN-CG path
# ---------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_sharded_one_rank(mesh, prob_t, best, kern, launches3):
    """8(a): phase 3's chain on the problem sharded over one rank."""
    import scso_tpu_torch as st
    from scso_tpu_torch.ops.cuda import counters
    from scso_tpu_torch.parallel import shard_problem

    method = st.ProxGGNSCORE(**F32_CG)
    sp = shard_problem(prob_t, mesh)
    solve_chunk(method, sp)  # warm-up
    counters.reset()
    sh = timed_chain(method, sp, best)
    launches = counters.snapshot()
    log(f"  timed solve, one rank (NCCL): {sh['seconds']:.4f} s, "
        f"{sh['epochs']} epochs, {sh['cg_iters']} CG iterations, gap "
        f"{sh['gap']:.3e}, launches {launches}; phase 3 unsharded: "
        f"{kern['seconds']:.4f} s")
    for key in ("epochs", "cg_iters", "obj"):
        if sh[key] != kern[key]:
            fail(f"one-rank sharded {key} {sh[key]!r} != phase 3's "
                 f"{kern[key]!r}")
    check_launches(launches, SHARDED_KERNELS, "one-rank sharded")
    want = dict(launches3, normal_matvec_sharded=launches3["normal_matvec"])
    if launches != want:
        fail(f"one-rank sharded launches {launches} != {want}")
    log(f"  final objective {sh['obj']:.9e}, epochs and CG iterations: "
        "bitwise phase 3's")
    return sh, launches


def build_two_rank_problem(device):
    import numpy as np
    import torch

    import scso_tpu_torch as st
    from scso_tpu_torch.models import losses, synthetic

    A, y, x0, _ = synthetic.make_sparse_logreg_data(
        2 * TWO_RANK_ROWS, MAIN_SHAPE[1], density=0.05, n_active=64,
        seed=SEED, dtype=np.float32, label01=True)
    prob = st.Problem(A, y, x0, losses.logistic01_f, 0.01,
                      grad_fx=losses.logistic01_grad,
                      glm=losses.LOGISTIC01_GLM, dtype=torch.float32,
                      device=device, pad_features=True)
    return prob, (A, y, x0)


def small_test_problem(device):
    """512x200 sparse logistic (features padded to 256) with a 128-row
    test set from the same generator, float64."""
    import numpy as np
    import torch

    import scso_tpu_torch as st
    from scso_tpu_torch.models import losses, synthetic

    A, y, x0, _ = synthetic.make_sparse_logreg_data(
        512, 200, density=0.05, n_active=64, seed=SEED, dtype=np.float64,
        label01=True)
    At, yt, _, _ = synthetic.make_sparse_logreg_data(
        128, 200, density=0.05, n_active=64, seed=SEED + 1,
        dtype=np.float64, label01=True)
    return st.Problem(A, y, x0, losses.logistic01_f, 0.01,
                      grad_fx=losses.logistic01_grad,
                      glm=losses.LOGISTIC01_GLM, Atest=At, ytest=yt,
                      dtype=torch.float64, device=device, pad_features=True)


def small_sharded_cases():
    """Phase 8(b)'s small float64 solve of each method on a row shard:
    name → (build(device) → problem, method, iterate kwargs). The two
    gloo ranks solve them in timed mode (a record every epoch), the CPU
    unsharded in fused mode with a record every epoch."""
    import torch

    import scso_tpu_torch as st

    logreg = lambda lam: (lambda dev: build_problem(512, 200, dev,
                                                    torch.float64, lam=lam))
    mglm = lambda dev: build_mglm_problem(512, 64, 4, dev, torch.float64,
                                          lam=1e-2)
    ggn = lambda **k: st.ProxGGNSCORE(solver="cg", greedy_alpha=False, **k)
    # 20 epochs a solve (60 and 40 before phase 25 took its share of the
    # run's time): the two gloo ranks' time is their collectives'
    lbfgs_kw = dict(x_tol=0.0, f_tol=0.0, max_epoch=20, verbose=0)
    short = dict(CHUNK_KW, max_epoch=20)
    return {
        "cached": (logreg(0.01), ggn(), short),
        "lbfgs": (logreg(0.01), st.ProxLQNSCORE(), lbfgs_kw),
        "lbfgs_armijo": (logreg(0.01), st.ProxLQNSCORE(ss_type=3),
                         dict(lbfgs_kw, alpha=1.0)),
        "uncached": (logreg(0.01), ggn(epoch_cache=False), short),
        "newton_cg": (logreg(0.1), st.ProxNSCORE(solver="cg",
                                                 greedy_alpha=False),
                      short),
        "newton_dense": (build_logreg_100x50, st.ProxNSCORE(),
                         dict(CHUNK_KW, max_epoch=20)),
        "ggn_dense_dual": (build_logreg_100x50,
                           st.ProxGGNSCORE(solver="dense_dual"),
                           dict(CHUNK_KW, max_epoch=20)),
        "ggn_dense_primal": (build_logreg_100x50,
                             st.ProxGGNSCORE(solver="dense_primal"),
                             dict(CHUNK_KW, max_epoch=20)),
        "mglm": (mglm, ggn(), short),
        "mglm_uncached": (mglm, ggn(epoch_cache=False), short),
        "batches": (logreg(0.01), st.ProxGGNSCORE(solver="cg"),
                    dict(BATCH_KW, batch_size=96, rng_seed=3, alpha=None)),
        "test_set": (small_test_problem, ggn(epoch_cache=False), short),
    }


def small_iterate(method, prob, kw, **more):
    import scso_tpu_torch as st

    kw = {k: v for k, v in dict(kw, **more).items() if v is not None}
    return st.iterate(method, prob, "l1", st.PHuberSmootherL1L2(1.0), **kw)


def rank_worker(port, rank, workdir):
    """One of phase 8(b)'s two ranks (``--rank-worker``): load this
    rank's rows from ``workdir``, solve to the gap with
    comm_overlap_chunks 1 and 2, then the small float64 solve of each
    method (`small_sharded_cases`); save."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import scso_tpu_torch as st
    from scso_tpu_torch.models import losses
    from scso_tpu_torch.ops.cuda import counters
    from scso_tpu_torch.parallel import (
        distributed_init, load_problem_rows_sharded, make_mesh,
        shard_problem)

    torch.backends.cuda.matmul.allow_tf32 = False
    rank = int(rank)
    if distributed_init("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=2, rank=rank) != 2:
        fail(f"rank {rank}: the two-rank gloo group did not form")
    mesh = make_mesh()
    with open(os.path.join(workdir, "anchor.json")) as fh:
        best = json.load(fh)["best"]
    prob = load_problem_rows_sharded(
        os.path.join(workdir, "data"), np.load(os.path.join(workdir,
                                                            "x0.npy")),
        losses.logistic01_f, 0.01, mesh, device="cuda",
        grad_fx=losses.logistic01_grad, glm=losses.LOGISTIC01_GLM,
        sol=np.load(os.path.join(workdir, "xstar.npy")), pad_features=True)
    out = {}
    # gloo reduces CUDA tensors through the host, which a capture
    # refuses: these ranks run timed mode, a row shard's public mode
    # (the cached step, uncaptured)
    for chunks in (1, 2):
        method = st.ProxGGNSCORE(**F32_CG, comm_overlap_chunks=chunks)
        solve_chunk(method, prob, mode="timed")  # warm-up
        counters.reset()
        r = timed_chain(method, prob, best, keep_x=True, mode="timed")
        r["launches"] = counters.snapshot()
        out[f"x{chunks}"] = r.pop("x").cpu().numpy()
        r.pop("objs")
        out[f"chain{chunks}"] = json.dumps(r)
    for name, (build, method, kw) in small_sharded_cases().items():
        s = small_iterate(method, shard_problem(build("cuda"), mesh), kw,
                          mode="timed")
        out[f"small_{name}"] = s.obj.numpy()
        out[f"small_{name}_x"] = s.x.cpu().numpy()
        out[f"small_{name}_test"] = s.fvaltest.numpy()
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


def wait_all(procs, timeout):
    """Wait for every process; the first to fail, or the timeout, ends
    the others (a rank left alone would wait at its next collective)."""
    deadline = time.monotonic() + timeout
    while any(p.poll() is None for p in procs):
        if (time.monotonic() > deadline
                or any(p.poll() not in (None, 0) for p in procs)):
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            return
        time.sleep(0.2)


def phase_sharded_two_ranks():
    """8(b): two worker ranks on the one card over gloo against the
    parent's unsharded chain on the same data."""
    import numpy as np
    import torch

    import scso_tpu_torch as st
    from scso_tpu_torch._src.struct import replace
    from scso_tpu_torch.parallel import save_problem_data

    workdir = tempfile.mkdtemp(prefix="scso_chip_smoke_")
    procs = []
    try:
        t0 = time.perf_counter()
        prob, (A, y, x0) = build_two_rank_problem("cuda")
        save_problem_data(os.path.join(workdir, "data"), A, y)
        np.save(os.path.join(workdir, "x0.npy"), x0)
        del A, y
        log(f"  data 2x{TWO_RANK_ROWS}x{MAIN_SHAPE[1]} made and written in "
            f"{time.perf_counter() - t0:.1f} s")
        method = st.ProxGGNSCORE(**F32_CG)
        best, x_opt, _ = presolve(method, prob)
        prob_t = replace(prob, x_star=x_opt)
        solve_chunk(method, prob_t)  # warm-up
        ref = timed_chain(method, prob_t, best)
        del prob, prob_t
        torch.cuda.empty_cache()
        np.save(os.path.join(workdir, "xstar.npy"),
                x_opt[:MAIN_SHAPE[1]].cpu().numpy())
        with open(os.path.join(workdir, "anchor.json"), "w") as fh:
            json.dump({"best": best}, fh)
        log(f"  unsharded chain, kernels: {ref['seconds']:.4f} s, "
            f"{ref['epochs']} epochs, {ref['cg_iters']} CG iterations, "
            f"obj {ref['obj']:.9e}")
        port = free_port()
        t0 = time.perf_counter()
        logs = [open(os.path.join(workdir, f"rank{r}.log"), "w+")
                for r in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank-worker",
             str(port), str(r), workdir], stdout=logs[r],
            stderr=subprocess.STDOUT) for r in range(2)]
        wait_all(procs, timeout=400)
        for r, (p, fh) in enumerate(zip(procs, logs)):
            fh.seek(0)
            if p.returncode != 0:
                fail(f"phase 8(b) rank {r} exited {p.returncode}:\n"
                     f"{fh.read()[-4000:]}")
            fh.close()
        log(f"  two ranks done in {time.perf_counter() - t0:.1f} s "
            "(start-up, loading and solves)")
        ranks = [dict(np.load(os.path.join(workdir, f"rank{r}.npz")))
                 for r in range(2)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(workdir, ignore_errors=True)
    res = {"unsharded": ref}
    for chunks in (1, 2):
        got = json.loads(str(ranks[0][f"chain{chunks}"]))
        if not np.array_equal(ranks[0][f"x{chunks}"], ranks[1][f"x{chunks}"]):
            fail(f"two ranks (comm_overlap_chunks={chunks}) hold different "
                 "x")
        rel = abs(got["obj"] - ref["obj"]) / abs(ref["obj"])
        if not (rel <= E2E_RTOL and got["gap"] <= GAP * 1.05):
            fail(f"two ranks (comm_overlap_chunks={chunks}): obj "
                 f"{got['obj']:.9e} vs unsharded {ref['obj']:.9e} (rel "
                 f"{rel:.2e}), gap {got['gap']:.3e}")
        lc = got["launches"]
        # the overlapped form's local products are matrix products: it
        # launches neither K1 nor K1s
        check_launches(lc, SHARDED_KERNELS if chunks == 1 else tuple(
            k for k in SHARDED_KERNELS
            if k not in ("normal_matvec", "normal_matvec_sharded")),
            f"two-rank (comm_overlap_chunks={chunks})")
        if chunks == 1 and lc["normal_matvec_sharded"] != lc["normal_matvec"]:
            fail(f"two-rank: K1s launched {lc['normal_matvec_sharded']} "
                 f"times but K1 {lc['normal_matvec']}")
        log(f"  gloo, two ranks on one card, timed mode, "
            f"comm_overlap_chunks={chunks}: {got['seconds']:.4f} s, "
            f"{got['epochs']} epochs, obj {got['obj']:.9e} (rel "
            f"diff to unsharded {rel:.2e}, tolerance {E2E_RTOL:g}), x "
            f"bitwise equal on both ranks, launches on rank 0 {lc}")
        res[f"two_ranks_overlap{chunks}"] = got
    # a row shard's timed mode records every epoch (and takes the cached
    # step where the cache acts): the unsharded fused solve's records
    # with stats_every = 1
    small = {}
    for name, (build, method, kw) in small_sharded_cases().items():
        s_cpu = small_iterate(method, build("cpu"), kw, stats_every=1)
        got = [r[f"small_{name}"] for r in ranks]
        want = s_cpu.obj.numpy()
        if not (np.array_equal(got[0], got[1]) and np.array_equal(
                ranks[0][f"small_{name}_x"], ranks[1][f"small_{name}_x"])
                and got[0].shape == want.shape):
            fail(f"small f64 two-rank {name} solve: the ranks' x or "
                 f"histories differ, or its {len(got[0])} records are not "
                 f"the CPU's {len(want)}")
        rel64 = float(np.max(np.abs(got[0] - want) / np.abs(want)))
        tests = ranks[0][f"small_{name}_test"]
        if len(tests) or len(s_cpu.fvaltest):
            ft = s_cpu.fvaltest.numpy()
            if tests.shape != ft.shape:
                fail(f"small f64 two-rank {name}: {len(tests)} fvaltest "
                     f"records against the CPU's {len(ft)}")
            rel64 = max(rel64, float(np.max(np.abs(tests - ft)
                                            / np.abs(ft))))
        if not (np.all(np.isfinite(got[0])) and rel64 <= SMALL_RTOL):
            fail(f"small f64 two-rank {name} solve: histories differ by "
                 f"{rel64:.2e}")
        small[name] = rel64
        log(f"  small f64 two-rank {name}: {len(want) - 1} epochs, card "
            f"(gloo, timed) vs CPU plain unsharded max rel diff "
            f"{rel64:.2e} (tolerance {SMALL_RTOL:g})")
    res["small_f64_rel"] = small
    return res


def one_rank_nccl():
    """A one-rank NCCL group in this process (a TCP store on
    localhost) and its mesh."""
    import torch.distributed as dist

    from scso_tpu_torch.parallel import distributed_init, make_mesh

    # a failed init warns and returns 1 too: read the group itself
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        size = distributed_init(init_method=f"tcp://localhost:{free_port()}",
                                world_size=1, rank=0)
    if not (size == 1 and dist.is_initialized()
            and dist.get_backend() == "nccl"):
        fail("the one-rank NCCL group did not form: "
             + "; ".join(str(w.message) for w in caught))
    return make_mesh()


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 22: every single-instance method on a row shard, captured
# ---------------------------------------------------------------------------


def sharded_method_cases(prob_t, mprob_t):
    """Phase 22's solves: name → (problem, solve(problem) → Solution, the
    kernels it launches), each one solve of its phase's path at full
    width: 5's multinomial, 6's L-BFGS (300 epochs), 7's uncached
    GGN-CG, 12's Newton-CG (greedy off), 16's mini-batches and 18's test
    set with f(x) off the epoch cache (the uncached method)."""
    import scso_tpu_torch as st

    sm = st.PHuberSmootherL1L2(1.0)
    uncached = st.ProxGGNSCORE(**F32_CG, epoch_cache=False)
    return {
        "multinomial": (mprob_t, lambda p: solve_chunk(
            st.ProxGGNSCORE(**F32_CG), p), MGLM_KERNELS),
        "lbfgs": (prob_t, lambda p: solve_lbfgs(st.ProxLQNSCORE(m=10), p),
                  LBFGS_KERNELS),
        "uncached": (prob_t, lambda p: solve_chunk(uncached, p),
                     UNCACHED_KERNELS),
        "newton_cg": (prob_t, lambda p: solve_chunk(
            st.ProxNSCORE(**NEWTON_GREEDY_OFF), p), NEWTON_KERNELS),
        "mini_batches": (prob_t, lambda p: st.iterate(
            st.ProxGGNSCORE(**F32_CG), p, "l1", sm, **BATCH_KW),
            UNCACHED_KERNELS),
        "test_set": (test_set_problem(prob_t),
                     lambda p: solve_chunk(uncached, p), UNCACHED_KERNELS),
    }


def captured_run(solve, prob):
    """``solve(prob)`` twice: a warm-up that captures, then a timed
    replay. Returns (the timed Solution, its seconds, its launches, its
    captures, the torch.distributed.all_reduce calls the host made in
    the warm-up and in the timed run, the replayed graphs' nodes)."""
    import torch
    import torch.distributed as dist

    from scso_tpu_torch.ops.cuda import counters, graph

    calls = [0]
    real = dist.all_reduce

    def counted(*args, **kw):
        calls[0] += 1
        return real(*args, **kw)

    dist.all_reduce = counted
    try:
        solve(prob)  # warm-up: the capture
        warm_calls, calls[0] = calls[0], 0
        counters.reset()
        graph.reset_stats()
        t0 = time.perf_counter()
        s = solve(prob)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = counters.snapshot()
    finally:
        dist.all_reduce = real
    nodes = sum(g.nodes for g in graph.last_graphs().values())
    return (s, seconds, launches, graph.STATS["captures"], warm_calls,
            calls[0], nodes)


def phase_sharded_methods(mesh, prob_t, mprob_t):
    """Phase 22: each method of `sharded_method_cases` on the problem
    sharded over the one-rank NCCL mesh, captured (mode='fused'), against
    its unsharded fused solve: the same epochs, CG iterations, x and
    every history, bit for bit; the same kernel launches (K1s once for
    each K1); the all-reduces inside the replayed graph (the host issues
    only the priming's and the final record's: the warm-up, which
    captures, issues more, and the sharded graph has more nodes)."""
    from scso_tpu_torch.parallel import shard_problem

    out, total, sols = {}, None, {}
    for name, (prob, solve, kernels) in sharded_method_cases(
            prob_t, mprob_t).items():
        s0, sec0, lc0, cap0, _, _, nodes0 = captured_run(solve, prob)
        s1, sec1, lc1, cap1, warm, calls, nodes1 = captured_run(
            solve, shard_problem(prob, mesh))
        same_solution(f"phase 22 {name}: sharded vs unsharded", s0, s1)
        if s0.cg_info != s1.cg_info:
            fail(f"phase 22 {name}: CG {s1.cg_info} sharded vs "
                 f"{s0.cg_info} unsharded")
        check_launches(lc0, kernels, f"phase 22 {name} unsharded")
        want = dict(lc0, normal_matvec_sharded=lc0["normal_matvec"])
        if lc1 != want:
            fail(f"phase 22 {name}: sharded launches {lc1} != {want}")
        if cap0 or cap1 or not (warm > calls and nodes1 > nodes0):
            fail(f"phase 22 {name}: captures in the timed runs {cap0}, "
                 f"{cap1}; all-reduces from the host {warm} (warm-up) and "
                 f"{calls} (replay); graph nodes {nodes1} sharded, "
                 f"{nodes0} unsharded")
        log(f"  {name}: {s1.epochs} epochs, CG {s1.cg_info}, bitwise the "
            f"unsharded solve; sharded {sec1:.4f} s, unsharded "
            f"{sec0:.4f} s; all-reduces from the host: {warm} capturing, "
            f"{calls} replaying; graph nodes {nodes1} (unsharded "
            f"{nodes0}); launches {lc1}")
        out[name] = dict(seconds=sec1, unsharded_seconds=sec0,
                         epochs=s1.epochs, cg=(s1.cg_info or {}).get(
                             "total_cg_iters", 0), launches=lc1,
                         host_all_reduces=calls, nodes=nodes1)
        total = lc1 if total is None else {k: total[k] + lc1[k]
                                           for k in total}
        sols[name] = s1
    return out, total, sols


# ---------------------------------------------------------------------------
# phases 16-19: mini-batches, problems without data, metrics and resume,
# continuation
# ---------------------------------------------------------------------------

BATCH_SIZE = 50000      # phase 16: 3 full batches and one of 46608 rows
BATCH_EPOCHS = 6
BATCH_KW = dict(batch_size=BATCH_SIZE, rng_seed=7, max_epoch=BATCH_EPOCHS,
                x_tol=1e-12, f_tol=1e-12, verbose=0, alpha=1.0)
BOX_QP_N = 8192         # phase 17
TEST_ROWS = 32768       # phase 18: the test set
RESUME_AT = 8           # phase 18: epochs before the checkpoint
CURVATURE_ROWS = 65536  # phase 18
ROSENBROCK_ATOL = 1e-5  # phase 17: max|x - [1, 1]|
# phase 19: each solve to its float32 fixed point (the steps below 1e-7
# of |x|); x within CONT_XTOL·max(1, max|x|) of the direct solve's
# (example 10's atol)
CONT_KW = dict(x_tol=1e-7, f_tol=0.0, max_epoch=150, verbose=0,
               stats_every=4, alpha=1.0)
CONT_XTOL = 1e-6


def solve_pair(what, solve, warm=True, eager=True):
    """``solve(capture)`` captured (a warm-up captures, then a timed run
    replays; without ``warm`` the timed run makes the capture) and eager
    (``capture=False``, unless ``eager`` is false): the same epochs, x
    and histories, bitwise. Returns (the timed captured Solution, its
    seconds, its captures and launches by kernel)."""
    import torch

    from scso_tpu_torch.ops.cuda import counters, graph

    if warm:
        solve(True)  # warm-up: the captures
    counters.reset()
    graph.reset_stats()
    t0 = time.perf_counter()
    s = solve(True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    captures, launches = graph.STATS["captures"], counters.snapshot()
    if eager:
        same_solution(f"{what}: captured vs eager", s, solve(False))
    return s, seconds, captures, launches


def same_solution(what, a, b):
    """Fail unless two Solutions have the same epochs and, bit for bit,
    the same x and histories (fvaltest and the metrics included)."""
    import torch

    fields = ("obj", "fval", "rel", "objrel", "pri_res_norm", "fvaltest")
    bad = [f for f in fields if not torch.equal(
        torch.nan_to_num(getattr(a, f), nan=7.0),
        torch.nan_to_num(getattr(b, f), nan=7.0))]
    bad += [f"metric {k}" for k in a.metricvals
            if not torch.equal(a.metricvals[k], b.metricvals[k])]
    if a.epochs != b.epochs or not torch.equal(a.x, b.x) or bad:
        fail(f"{what}: epochs {a.epochs} vs {b.epochs}, x equal "
             f"{torch.equal(a.x, b.x)}, differing histories {bad}")


def path_line(what, seconds, epochs, launches, captures):
    log(f"  {what}: {seconds:.4f} s, {epochs} epochs, launches "
        + json.dumps({k: launches[k] for k in
                      ("normal_matvec", "glm_prep_pair", "glm_prep",
                       "score_update", "two_loop")})
        + f", captures {captures}")


def phase_minibatch(prob_t):
    """Phase 16: mini-batches at full width (phase 3's problem):
    batch_size 50000 (3 full batches and a partial one of 46608 rows),
    shuffled with rng_seed 7, 6 epochs, fused, against its eager form
    and timed mode (the same permutations: bitwise); K1, K2s and K3 in
    every batch, K2 never; the objective below x0's; unshuffled, the
    kernels and the kernels='torch' chains agree on the final objective.
    Also the time of one batch's gather (index_select into the reused
    buffer) beside the epoch's."""
    import dataclasses

    import torch

    import scso_tpu_torch as st
    from scso_tpu_torch.ops.cuda import counters

    method = st.ProxGGNSCORE(**F32_CG)
    sm = st.PHuberSmootherL1L2(1.0)
    run = lambda capture, meth=method, **kw: st.iterate(
        meth, prob_t, "l1", sm, _capture=capture, **dict(BATCH_KW, **kw))
    s, secs, caps, lc = solve_pair("mini-batches", run)
    m = prob_t.A.shape[0]
    nb, rem = divmod(m, BATCH_SIZE)
    steps = s.epochs * (nb + (1 if rem else 0))
    path_line("mini-batches, fused", secs, s.epochs, lc, caps)
    if not (lc["glm_prep"] == lc["score_update"] == steps
            and lc["normal_matvec"] >= steps and lc["glm_prep_pair"] == 0):
        fail(f"mini-batches: {steps} batch steps, launches {lc}")
    check_launches(lc, UNCACHED_KERNELS, "mini-batch")
    if not float(s.obj[-1]) < float(s.obj[0]):
        fail(f"mini-batches: objective {float(s.obj[-1]):.9e} not below "
             f"x0's {float(s.obj[0]):.9e}")
    run(True, mode="timed")  # warm-up: its captures
    counters.reset()
    t0 = time.perf_counter()
    t = run(True, mode="timed")
    torch.cuda.synchronize()
    path_line("mini-batches, timed mode", time.perf_counter() - t0,
              t.epochs, counters.snapshot(), 0)
    same_solution("mini-batches: fused vs timed", s, t)
    kern = run(True, shuffle_batch=False)
    plain = run(True, dataclasses.replace(method, kernels="torch"),
                shuffle_batch=False)
    rel = abs(float(kern.obj[-1]) - float(plain.obj[-1])) / abs(
        float(plain.obj[-1]))
    if not rel <= E2E_RTOL:
        fail(f"mini-batches unshuffled: kernels {float(kern.obj[-1]):.9e} "
             f"vs torch {float(plain.obj[-1]):.9e} (rel {rel:.2e})")
    rows = torch.randperm(m, device=prob_t.device)[:BATCH_SIZE]
    buf = prob_t.A.new_empty((BATCH_SIZE, prob_t.A.shape[1]))
    gather = time_ms(lambda: torch.index_select(prob_t.A, 0, rows, out=buf))
    log(f"  objective {float(s.obj[0]):.9e} at x0, {float(s.obj[-1]):.9e} "
        f"after {s.epochs} epochs ({steps} batch steps); unshuffled "
        f"kernels vs torch rel diff {rel:.2e} (tolerance {E2E_RTOL:g}); "
        f"one batch's gather {gather:.4f} ms (CUDA events), "
        f"{secs / s.epochs * 1e3:.2f} ms an epoch")
    return dict(seconds=secs, epochs=s.epochs, batch_steps=steps,
                launches=lc, captures=caps, gather_ms=gather, rel=rel,
                obj=float(s.obj[-1]))


def phase_no_data(prob_t):
    """Phase 17: problems without data — example 04's box QP at n = 8192
    (float32, ProxNSCORE: Newton-CG on the jvp of the closed-form
    gradient, 'indbox', each of the three box smoothers): x in the box,
    K3 launched; example 01's Rosenbrock (float64, ProxLQNSCORE(m=10)):
    x ≈ [1, 1] within 1e-6, K4 and K3; phase 3's problem with the
    out_fn hooks and no GLM spec (the generic GGN-CG branch, J by jvp
    and vjp), 6 epochs: K3 and no K1 or K2. Each captured solve against
    its eager form, bitwise."""
    import numpy as np
    import torch

    import scso_tpu_torch as st
    from scso_tpu_torch._src.struct import replace
    from scso_tpu_torch.models import losses, synthetic

    out = {}
    Q, c, x0 = synthetic.make_box_qp(BOX_QP_N, seed=1234, dtype=np.float32)
    qp = st.Problem(Q, c, x0, losses.qp_f, 1e-4, grad_fx=losses.qp_grad,
                    hess_fx=losses.qp_hess, C_set=[-1.0, 1.0],
                    dtype=torch.float32, device="cuda")
    for name, cls in (("PHuber", st.PHuberSmootherIndBox),
                      ("Exponential", st.ExponentialSmootherIndBox),
                      ("LogExp", st.LogExpSmootherIndBox)):
        sm = cls(-1.0, 1.0, 0.6)
        # each smoother's solve captures its graph (its seconds include
        # the capture); the first is also held against its eager form
        s, secs, caps, lc = solve_pair(f"box QP {name}", lambda c: st.iterate(
            st.ProxNSCORE(), qp, "indbox", sm, alpha=0.8, max_epoch=200,
            verbose=0, _capture=c), warm=False, eager=name == "PHuber")
        path_line(f"box QP n={BOX_QP_N} ({name})", secs, s.epochs, lc, caps)
        inside = bool(((s.x >= -1.0) & (s.x <= 1.0)).all())
        # x0 lies outside the box: the first record's g (the indicator)
        # is infinite, as in the JAX package
        if not (inside and lc["score_update"] > 0
                and bool(torch.isfinite(s.obj[1:]).all())
                and float(s.obj[-1]) <= float(s.obj[1])):
            fail(f"box QP {name}: x in the box {inside}, objectives "
                 f"{float(s.obj[1]):.6e} → {float(s.obj[-1]):.6e}, "
                 f"launches {lc}")
        out[f"box_qp_{name}"] = dict(seconds=secs, epochs=s.epochs,
                                     obj=float(s.obj[-1]), launches=lc)
    del qp, Q
    rb = st.Problem(np.array([0.2, -0.5]), losses.rosenbrock, 1e-8,
                    dtype=torch.float64, device="cuda")
    s, secs, caps, lc = solve_pair("Rosenbrock", lambda c: st.iterate(
        st.ProxLQNSCORE(m=10), rb, "l1", st.PHuberSmootherL1L2(1.0),
        max_epoch=2000, x_tol=1e-10, f_tol=1e-10, verbose=0, _capture=c))
    path_line("Rosenbrock (L-BFGS, f64)", secs, s.epochs, lc, caps)
    err = float((s.x - 1.0).abs().max())
    cpu = st.iterate(st.ProxLQNSCORE(m=10), replace(
        rb, x0=rb.x0.cpu(), lam=rb.lam.cpu(), x_star=rb.x_star.cpu(),
        device=torch.device("cpu")), "l1", st.PHuberSmootherL1L2(1.0),
        max_epoch=2000, x_tol=1e-10, f_tol=1e-10, verbose=0)
    dcpu = float((s.x.cpu() - cpu.x).abs().max())
    # the method's fixed point lies 3.55e-6 from [1, 1] (λ·∂g_μ shifts
    # it), on the CPU and in the JAX package alike
    if not (err <= ROSENBROCK_ATOL and dcpu <= SMALL_RTOL
            and s.epochs == cpu.epochs and lc["two_loop"] > 0
            and lc["score_update"] > 0):
        fail(f"Rosenbrock: max|x - 1| {err:.2e}, vs the CPU {dcpu:.2e} "
             f"({s.epochs} / {cpu.epochs} epochs), launches {lc}")
    log(f"  Rosenbrock: x = {s.x.tolist()}, max|x - 1| {err:.2e} (limit "
        f"{ROSENBROCK_ATOL:g}), the CPU's x to {dcpu:.2e}")
    out["rosenbrock"] = dict(seconds=secs, epochs=s.epochs, err=err,
                             launches=lc)
    gen = replace(prob_t, glm=None, out_fn=losses.sigmoid_out,
                  grad_fy=losses.logistic_ggn_residual,
                  hess_fy_diag=losses.logistic_ggn_qdiag,
                  loss_fn=losses.logistic_loss_01)
    s, secs, caps, lc = solve_pair("generic GGN-CG", lambda c: st.iterate(
        st.ProxGGNSCORE(**F32_CG), gen, "l1", st.PHuberSmootherL1L2(1.0),
        max_epoch=6, x_tol=1e-12, f_tol=1e-12, verbose=0, alpha=1.0,
        _capture=c))
    path_line("generic GGN-CG (jvp/vjp of out_fn)", secs, s.epochs, lc,
              caps)
    check_launches(lc, ("score_update",), "generic GGN-CG")
    if not (bool(torch.isfinite(s.obj).all())
            and float(s.obj[-1]) < float(s.obj[0])):
        fail(f"generic GGN-CG: objectives {s.obj.tolist()}")
    out["generic_ggn"] = dict(seconds=secs, epochs=s.epochs,
                              cg_iters=(s.cg_info or {}).get(
                                  "total_cg_iters", 0), launches=lc)
    return out


def test_set_problem(prob_t):
    """Phase 3's problem with a test set of TEST_ROWS rows from the same
    generator with another seed (padded like A)."""
    import numpy as np
    import torch

    from scso_tpu_torch._src.struct import replace
    from scso_tpu_torch.models import synthetic

    At, yt, _, _ = synthetic.make_sparse_logreg_data(
        TEST_ROWS, MAIN_SHAPE[1], density=0.05, n_active=64, seed=SEED + 1,
        dtype=np.float32, label01=True)
    n = prob_t.A.shape[1]
    Atest = torch.zeros((TEST_ROWS, n), dtype=torch.float32, device="cuda")
    Atest[:, :At.shape[1]] = torch.from_numpy(At).cuda()
    return replace(prob_t, Atest=Atest, ytest=torch.from_numpy(yt).cuda())


def test_mse(prob, x):
    """The metric of phase 18: the test set's mean squared error of the
    sigmoid output."""
    import torch

    return torch.mean((torch.sigmoid(prob.Atest @ x) - prob.ytest) ** 2)


def phase_resume(prob_t, best):
    """Phase 18: metrics, a test set and resume on phase 3's problem: an
    8-epoch solve saved with save_state to a .npz, loaded with load_state
    and resumed to the 1e-6 gap, against the uninterrupted solve — x and
    every history (fvaltest and the metric included) bitwise — in fused
    mode (the resume capturing no graph) and in timed mode; then
    static_precond (with_col_sumsq) to the gap, and one chunk of
    curvature_rows=65536, each within E2E_RTOL of its kernels='torch'
    solve."""
    import dataclasses
    import tempfile

    import torch

    import scso_tpu_torch as st
    from scso_tpu_torch.ops.cuda import counters, graph
    from scso_tpu_torch.utils import load_state, save_state

    prob = test_set_problem(prob_t)
    method = st.ProxGGNSCORE(**F32_CG)
    sm = st.PHuberSmootherL1L2(1.0)
    out = {}
    for mode in ("fused", "timed"):
        run = lambda max_epoch, resume=None: st.iterate(
            method, prob, "l1", sm, metrics={"test_mse": test_mse},
            resume_state=resume, mode=mode,
            **dict(CHUNK_KW, max_epoch=max_epoch))
        run(CHUNK)  # warm-up: the captures
        t0 = time.perf_counter()
        full = run(CHUNK)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        part = run(RESUME_AT)
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "state.npz")
            save_state(path, part.state)
            state = load_state(path, template=part.state)
        graph.reset_stats()
        counters.reset()
        res = run(CHUNK, state)
        caps = graph.STATS["captures"]
        same_solution(f"resume ({mode})", full, res)
        if caps:
            fail(f"resume ({mode}): {caps} new captures")
        if not (len(res.fvaltest) == len(res.obj)
                and bool(torch.isfinite(res.metricvals["test_mse"]).all())):
            fail(f"resume ({mode}): fvaltest / metric records missing")
        path_line(f"uninterrupted solve ({mode})", secs, full.epochs,
                  counters.snapshot(), caps)
        log(f"  resume ({mode}): {part.epochs} epochs, saved, loaded, "
            f"resumed to {res.epochs} epochs: x and every history bitwise "
            f"the uninterrupted solve's; fvaltest {float(res.fvaltest[-1]):.6e}, "
            f"test_mse {float(res.metricvals['test_mse'][-1]):.6e}; "
            f"captures in the resume {caps}")
        out[f"resume_{mode}"] = dict(seconds=secs, epochs=full.epochs,
                                     resumed_at=part.epochs, captures=caps)
    del prob
    meth = st.ProxGGNSCORE(**F32_CG, static_precond=True)
    p = st.with_col_sumsq(prob_t)
    solve_chunk(meth, p)  # warm-up: the capture
    counters.reset()
    kern = timed_chain(meth, p, best)
    lc = counters.snapshot()
    path_line("static_precond chain", kern["seconds"], kern["epochs"], lc,
              kern["loop"]["captures"])
    check_launches(lc, UNCACHED_KERNELS, "static_precond")
    plain_m = dataclasses.replace(meth, kernels="torch")
    solve_chunk(plain_m, p)
    plain = timed_chain(plain_m, p, best)
    rel = abs(kern["obj"] - plain["obj"]) / abs(plain["obj"])
    if not (kern["gap"] <= GAP * 1.05 and rel <= E2E_RTOL):
        fail(f"static_precond: gap {kern['gap']:.3e}, kernels vs torch rel "
             f"{rel:.2e}")
    log(f"  static_precond: gap {kern['gap']:.3e}, {kern['cg_iters']} CG "
        f"iterations; kernels='torch' {plain['seconds']:.4f} s, "
        f"{plain['epochs']} epochs; rel diff {rel:.2e} (tolerance "
        f"{E2E_RTOL:g})")
    out["static_precond"] = dict(seconds=kern["seconds"],
                                 epochs=kern["epochs"],
                                 cg_iters=kern["cg_iters"], launches=lc,
                                 rel=rel)
    del p
    # subsampled curvature stalls short of the 1e-6 gap on this problem
    # (a gap of 1.1e-2 after 720 epochs), as the JAX package's does at a
    # third of the rows (PERF.md): one chunk from x0, kernels against
    # kernels='torch'
    meth = st.ProxGGNSCORE(**F32_CG, curvature_rows=CURVATURE_ROWS)
    s, secs, caps, lc = solve_pair("curvature_rows", lambda c: solve_chunk(
        meth, prob_t, capture=c))
    check_launches(lc, UNCACHED_KERNELS, "curvature_rows")
    plain = solve_chunk(dataclasses.replace(meth, kernels="torch"), prob_t)
    rel = abs(float(s.obj[-1]) - float(plain.obj[-1])) / abs(
        float(plain.obj[-1]))
    gap = float(s.obj[-1]) / best - 1.0
    path_line("curvature_rows, one chunk", secs, s.epochs, lc, caps)
    if not (rel <= E2E_RTOL and float(s.obj[-1]) < float(s.obj[0])):
        fail(f"curvature_rows: kernels vs torch rel {rel:.2e}, objective "
             f"{float(s.obj[0]):.6e} → {float(s.obj[-1]):.6e}")
    log(f"  curvature_rows={CURVATURE_ROWS}: {s.epochs} epochs, gap "
        f"{gap:.3e} to phase 3's anchor; kernels='torch' rel diff "
        f"{rel:.2e} (tolerance {E2E_RTOL:g})")
    out["curvature_rows"] = dict(seconds=secs, epochs=s.epochs, gap=gap,
                                 launches=lc, rel=rel)
    return out


def phase_continuation(prob_t, best):
    """Phase 19: iterate_continuation on phase 3's problem — μ over
    [16, 4, 1] and λ over [0.04, 0.02, 0.01], stage_epochs 6, each run to
    its float32 fixed point (CONT_KW) — against the direct solve: the
    same fixed point (x within example 10's atol 1e-6, scaled by
    max(1, max|x|)), at most one capture for the non-final stages (none
    after the first stage, none in the timed runs: the λ homotopy
    replays the direct solve's graph), the captured homotopy the eager
    one bitwise; each stage's epochs and seconds."""
    import torch

    import scso_tpu_torch as st
    from scso_tpu_torch.ops.cuda import graph

    method = st.ProxGGNSCORE(**F32_CG)
    sm = st.PHuberSmootherL1L2(1.0)
    kw = CONT_KW
    direct = st.iterate(method, prob_t, "l1", sm, **kw)
    out = {}
    for name, sched in (("mu", dict(mu_schedule=[16.0, 4.0, 1.0])),
                        ("lam", dict(lam_schedule=[0.04, 0.02, 0.01]))):
        run = lambda c: st.iterate_continuation(
            method, prob_t, "l1", sm, stage_epochs=6, _capture=c,
            **sched, **kw)
        graph.reset_stats()
        warm = run(True)
        stages = warm.cg_info["stages"]
        # the first stage may capture (none where an earlier solve of
        # the same key did: the direct solve's graph for λ alone), the
        # next non-final stages replay its graph
        nonfinal = sum(st_["captures"] for st_ in stages[:-1])
        later = sum(st_["captures"] for st_ in stages[1:-1])
        t0 = time.perf_counter()
        c = run(True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        again = sum(st_["captures"] for st_ in c.cg_info["stages"])
        same_solution(f"continuation ({name}): captured vs eager", c,
                      run(False))
        dx = float((c.x - direct.x).abs().max())
        lim = CONT_XTOL * max(1.0, float(direct.x.abs().max()))
        log(f"  continuation ({name}): {secs:.4f} s, {c.epochs} epochs; "
            f"stages " + json.dumps(c.cg_info["stages"]) + f"; captures "
            f"for the non-final stages {nonfinal}, in the timed run "
            f"{again}; max|x - direct x| {dx:.3e} (limit {lim:.3e}; direct "
            f"{direct.epochs} epochs)")
        if nonfinal > 1 or later or again or not dx <= lim:
            fail(f"continuation ({name}): captures {nonfinal} / {again}, "
                 f"max|dx| {dx:.3e}")
        out[name] = dict(seconds=secs, epochs=c.epochs,
                         stages=c.cg_info["stages"], dx=dx,
                         nonfinal_captures=nonfinal)
    return out


# ---------------------------------------------------------------------------
# phases 20 and 21: the instance-parallel layer (sweep, federated rounds)
# ---------------------------------------------------------------------------

SWEEP_SHAPE = (2048, 128)   # bench.py family_sweep(big=True)
SWEEP_B = 4096
SWEEP_KW = dict(max_epoch=60, verbose=0, stats_every=4, x_tol=1e-6)
SWEEP_CHECKED = 8           # instances held against scalar solves
FED_KW = dict(n_clients=8, comm_rounds=8, local_epochs=4, f_tol=1e-8)


def sweep_problem(device):
    import numpy as np
    import torch

    import scso_tpu_torch as st
    from scso_tpu_torch.models import losses, synthetic

    A, y, x0, _ = synthetic.make_sparse_logreg_data(
        *SWEEP_SHAPE, density=0.1, n_active=16, seed=SEED,
        dtype=np.float32, label01=True)
    return st.Problem(A, y, x0, losses.logistic01_f, 0.01,
                      grad_fx=losses.logistic01_grad,
                      hvp_w=losses.logistic01_hvp_w,
                      glm=losses.LOGISTIC01_GLM, dtype=torch.float32,
                      device=device)


def on_card(what, res):
    bad = [f for f, v in vars(res).items()
           if hasattr(v, "device") and v.device.type != "cuda"]
    if bad:
        fail(f"{what}: result tensors {bad} are not on the card")


def sweep_summary(res, secs, captures):
    from scso_tpu_torch.ops.cuda import graph

    g = graph.last_graphs().get("solve")
    B = res.batch_size
    return dict(seconds=secs, solves_per_s=B / secs,
                converged_frac=float((res.epochs < SWEEP_KW["max_epoch"])
                                     .float().mean()),
                mean_epochs=float(res.epochs.float().mean()),
                max_epochs=int(res.epochs.max()), captures=captures,
                capture_s=None if g is None else g.seconds,
                nodes=None if g is None else g.nodes)


def against_scalar(prob, lam, res, picks, meth, sm, offset=0):
    """The instances ``picks`` of the sweep result ``res`` (whose first
    instance is ``offset`` of the grid ``lam``) against the scalar fused
    solve at their λ, run to its own stop: (rows where both converged,
    rows at the epoch cap in one run only). A row's ``rel`` is the
    relative difference of the final objectives."""
    import torch

    import scso_tpu_torch as st
    from scso_tpu_torch._src.struct import replace

    cap = SWEEP_KW["max_epoch"]
    checked, edge = [], []
    for i in picks:
        p = replace(prob, lam=torch.tensor(float(lam[offset + i]),
                                           dtype=torch.float32,
                                           device=prob.device))
        ref = st.iterate(meth, p, "l1", sm, **SWEEP_KW)
        got, want = float(res.obj[i]), float(ref.obj[-1])
        row = dict(i=int(offset + i), lam=float(lam[offset + i]),
                   epochs=int(res.epochs[i]), scalar_epochs=ref.epochs,
                   obj=got, scalar_obj=want, rel=abs(got - want) / abs(want))
        if row["epochs"] < cap and ref.epochs < cap:
            checked.append(row)
        elif row["epochs"] < cap or ref.epochs < cap:
            edge.append(row)   # at the epoch cap in one run only: reported
    return checked, edge


def phase_sweep():
    """Phase 20 (see the module docstring): both plans timed on their
    second call (the first captures), the checks, and the counters: no
    K1–K5 launch in any sweep."""
    import importlib

    import numpy as np
    import torch

    import scso_tpu_torch as st
    from scso_tpu_torch.ops.cuda import counters, graph
    from scso_tpu_torch.parallel import sweep

    swp = importlib.import_module("scso_tpu_torch.parallel.sweep")
    prob = sweep_problem("cuda")
    lam = np.logspace(-3, -0.5, SWEEP_B).astype(np.float32)
    meth = st.ProxNSCORE(solver="cg", ss_type=3)
    sm = st.PHuberSmootherL1L2(1.0)
    opts = st.Options(**SWEEP_KW)
    run_t = lambda capture=True: sweep(meth, prob, "l1", sm, lam_grid=lam,
                                       opts=opts, plan="throughput",
                                       _capture=capture)

    def run_q():
        w = sweep(meth, prob, "l1", sm, lam_grid=lam, opts=opts,
                  plan="quality")
        return w, sweep(meth, prob, "l1", sm, lam_grid=lam, opts=opts,
                        x0_grid=w.x)

    out = {}
    counters.reset()
    for name, run in (("throughput", run_t), ("quality", run_q)):
        graph.reset_stats()
        run()
        first = graph.STATS["captures"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        again = graph.STATS["captures"] - first
        if name == "quality":
            waves, res = res
            on_card("sweep (quality plan's waves)", waves)
        on_card(f"sweep ({name} plan)", res)
        out[name] = sweep_summary(res, secs, again)
        out[name]["first_call_captures"] = first
        if name == "quality":
            out[name]["wave_mean_epochs"] = float(waves.epochs.float().mean())
        else:
            thr = res
        log(f"  sweep, {name} plan: " + json.dumps(out[name]))
        if again:
            fail(f"sweep ({name}): {again} captures in the timed call")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager = run_t(False)
    torch.cuda.synchronize()
    eager_secs = time.perf_counter() - t0
    launched = {k: v for k, v in counters.snapshot().items() if v}
    if launched:
        fail(f"sweep: kernels launched {launched} (the batched solve runs "
             "kernels='torch' by design)")
    same_bits("sweep: eager against captured (x, obj, epochs)",
              [eager.x, eager.obj, eager.epochs],
              [thr.x, thr.obj, thr.epochs])
    # eight instances against the scalar fused solve at their λ
    picks = np.linspace(0, SWEEP_B - 1, SWEEP_CHECKED).round().astype(int)
    checked, edge = against_scalar(prob, lam, thr, picks, meth, sm)
    for row in checked:
        if not row["rel"] <= E2E_RTOL:
            fail(f"sweep instance {row['i']}: objective {row['obj']} "
                 f"against the scalar solve's {row['scalar_obj']} (rel "
                 f"{row['rel']:.3e} > {E2E_RTOL})")
    if not checked:
        fail("sweep: no checked instance converged in both runs")
    # reported, not gated: the same instances solved 1024 at a time (the
    # share of a rank of four): in float32 the products of another batch
    # width round differently, and an instance whose x_tol test fires on
    # a step Armijo shrank stops at another point
    share = SWEEP_B // 4
    part = torch.cat([sweep(meth, prob, "l1", sm,
                            lam_grid=lam[k * share:(k + 1) * share],
                            opts=opts, plan="throughput").obj
                      for k in range(4)])
    cap = SWEEP_KW["max_epoch"]
    rel = ((part - thr.obj).abs() / thr.obj.abs()).double()
    conv = thr.epochs < cap
    q = torch.quantile(rel[conv], torch.tensor(
        [0.5, 0.9, 0.99, 1.0], dtype=torch.float64, device="cuda")).tolist()
    out["width_spread"] = dict(
        share=share, converged=int(conv.sum()),
        rel_obj_quantiles_50_90_99_100=q,
        beyond_e2e_rtol=int((rel[conv] > E2E_RTOL).sum()),
        exactly_equal=int((rel[conv] == 0).sum()))
    log(f"  sweep: the {SWEEP_B} instances solved {share} at a time, "
        f"against the {SWEEP_B}-wide sweep: "
        + json.dumps(out["width_spread"]))
    # plan='auto': the latency it weighs is measured once a process, so
    # the same call picks the same plan; beside it the rule's estimate
    # of a wave's epoch and the epoch the throughput plan took (all
    # 4096 instances, its seconds over its epochs)
    latency = swp._dispatch_latency_s(prob.device)
    auto = swp._resolve_plan("auto", prob, SWEEP_B, opts, 1)
    if swp._resolve_plan("auto", prob, SWEEP_B, opts, 1) != auto:
        fail("sweep: plan='auto' picks another plan on a second call")
    wave = swp._wave_s(prob, SWEEP_B // swp._largest_wave_count(SWEEP_B))
    out.update(checked=checked, edge=edge, launch_latency_s=latency,
               auto_plan=dict(path_waves=auto[0], wave_max_epoch=auto[1],
                              rule_wave_s=wave,
                              rule_threshold_s=4.0 * latency,
                              rule_epoch_s=wave / swp._PLAN_WARM_EPOCHS,
                              measured_full_width_epoch_s=(
                                  out["throughput"]["seconds"]
                                  / out["throughput"]["max_epochs"])),
               eager_seconds=eager_secs)
    log(f"  sweep: {len(checked)} instances within {E2E_RTOL} of their "
        f"scalar solves, {len(edge)} at the epoch cap in one run only "
        f"{json.dumps(edge)}; plan='auto' picks {auto} at a measured "
        f"launch latency of {latency * 1e6:.2f} us; no K1-K5 launch")
    return out


def phase_federated():
    """Phase 21 (see the module docstring)."""
    import numpy as np
    import torch

    import scso_tpu_torch as st
    from scso_tpu_torch.models import losses, synthetic
    from scso_tpu_torch.ops.cuda import graph
    from scso_tpu_torch.parallel import federated_solve

    A, y, x0, _ = synthetic.make_sparse_logreg_data(
        1024, 32, density=0.2, n_active=8, seed=3, dtype=np.float64)

    def run(device):
        prob = st.Problem(A, y, x0, losses.logistic_f, 1e-2,
                          grad_fx=losses.logistic_grad,
                          hess_fx=losses.logistic_hess, dtype=torch.float64,
                          device=device)
        return federated_solve(st.ProxNSCORE(solver="dense", ss_type=3),
                               prob, "l1", st.PHuberSmootherL1L2(1.0),
                               **FED_KW)

    graph.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fed = run("cuda")   # its one capture included
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    captures = graph.STATS["captures"]
    cpu = run("cpu")
    # the per-round objectives and epochs are host values, read a round
    for f in ("x", "client_x"):
        if getattr(fed, f).device.type != "cuda":
            fail(f"federated: {f} is not on the card")
    if fed.rounds != cpu.rounds:
        fail(f"federated: {fed.rounds} rounds on the card, {cpu.rounds} on "
             "the CPU")
    rel = float(((fed.obj - cpu.obj).abs() / cpu.obj.abs()).max())
    if not rel <= SMALL_RTOL:
        fail(f"federated: round objectives {rel:.3e} from the CPU's "
             f"(> {SMALL_RTOL})")
    if not torch.equal(fed.client_epochs, cpu.client_epochs):
        fail("federated: local epochs differ from the CPU's")
    if captures != 1:
        fail(f"federated: {captures} captures (one graph serves every "
             "round)")
    out = dict(seconds=secs, captures=captures, rounds=fed.rounds,
               obj=fed.obj.tolist(), max_rel_to_cpu=rel)
    log("  federated: " + json.dumps(out))
    return out



# ---------------------------------------------------------------------------
# phase 23: meshes of two axes
# ---------------------------------------------------------------------------

MESH2D_LAMS = (1e-3, 1e-1, 16)  # np.logspace's (start, stop, num), exponents
MESH2D_KW = dict(max_epoch=60, verbose=0, stats_every=4, x_tol=1e-6)
MESH_WORKERS = 4


def mesh2d_lams():
    import numpy as np

    lo, hi, num = MESH2D_LAMS
    return np.logspace(np.log10(lo), np.log10(hi), num).astype(np.float32)


def small_mesh_cases():
    """Phase 23(b)'s float64 cases: name → (kind, build(device) →
    problem, method, kwargs). ``sweep`` cases run on a 2×2 ('batch',
    'data') mesh, ``cols`` cases on a 2×2 ('data', 'model') one."""
    import torch

    import scso_tpu_torch as st

    logreg = lambda lam: (lambda dev: build_problem(512, 200, dev,
                                                    torch.float64, lam=lam))
    mglm = lambda dev: build_mglm_problem(512, 64, 4, dev, torch.float64,
                                          lam=1e-2)
    ggn = lambda **k: st.ProxGGNSCORE(solver="cg", greedy_alpha=False, **k)
    # 12 epochs a single solve, 12 a sweep, 20 a fleet (20, 20 and 30
    # before phase 25 took its share of the run's time)
    kw = dict(CHUNK_KW, max_epoch=12, stats_every=1)
    return {
        "sweep": ("sweep", logreg(0.01), ggn(), dict(plan="throughput")),
        "waves": ("sweep", logreg(0.01), ggn(), dict(path_waves=2)),
        # batches of 512 rows of 128 features: well conditioned, so that
        # float64 parity holds (thinner ones amplify last-ulp differences)
        "sweep_batches": ("sweep", lambda dev: build_problem(
            2048, 96, dev, torch.float64, lam=0.05), ggn(),
            dict(plan="throughput", batch_size=512)),
        "fleet": ("fleet", logreg(0.01), ggn(), {}),
        # λ = 0.1: each client's 128 rows of 256 features at 0.01 turn a
        # one-ulp change of A into 2e-10 of x in three rounds
        "federated": ("federated", logreg(0.1), ggn(), {}),
        "cached": ("cols", logreg(0.01), ggn(), kw),
        "uncached": ("cols", logreg(0.01), ggn(epoch_cache=False), kw),
        "newton_cg": ("cols", logreg(0.1), st.ProxNSCORE(
            solver="cg", greedy_alpha=False), kw),
        "lbfgs": ("cols", logreg(0.01), st.ProxLQNSCORE(),
                  dict(x_tol=0.0, f_tol=0.0, max_epoch=12, verbose=0)),
        "mglm": ("cols", mglm, ggn(), kw),
        "test_set": ("cols", small_test_problem, ggn(epoch_cache=False),
                     kw),
    }


def small_mesh_run(kind, build, method, kw, device, mesh=None):
    """One case of `small_mesh_cases` on ``device``: unsharded without
    ``mesh``, else on it (gloo: the batched solves' bodies eagerly, the
    single solves in timed mode). Returns {field: numpy array}."""
    import numpy as np

    import scso_tpu_torch as st
    from scso_tpu_torch.parallel import (
        federated_solve, shard_problem, shard_problem_features,
        solve_fleet, stack_problems, sweep)

    sm = st.PHuberSmootherL1L2(1.0)
    prob = build(device)
    # from 1e-2: at 1e-3 this problem turns a one-ulp change of A into
    # 1e-6 of x within 20 epochs (measured on the CPU)
    lam = np.logspace(-2, -1, 8)
    eager = dict(_capture=False) if mesh is not None else {}
    rows = (lambda p: shard_problem(p, mesh)) if mesh is not None else (
        lambda p: p)
    bmesh = mesh
    if kind == "sweep":
        kw = dict(kw)
        bs = kw.pop("batch_size", None)
        opts = st.Options(max_epoch=12, verbose=0, batch_size=bs)
        r = sweep(method, rows(prob), "l1", sm, lam_grid=lam, opts=opts,
                  mesh=bmesh, rng_seed=3, **kw, **eager)
        return dict(x=r.x, obj=r.obj, epochs=r.epochs)
    if kind == "fleet":
        from scso_tpu_torch._src.struct import replace

        probs = [rows(replace(prob, lam=prob.lam * s))
                 for s in (1.0, 2.0, 4.0, 8.0)]
        r = solve_fleet(method, stack_problems(probs), "l1", sm,
                        opts=st.Options(max_epoch=20, verbose=0),
                        mesh=bmesh, **eager)
        return dict(x=r.x, obj=r.obj, epochs=r.epochs)
    if kind == "federated":
        r = federated_solve(method, rows(prob), "l1", sm, n_clients=4,
                            comm_rounds=3, local_epochs=4, mesh=bmesh,
                            **eager)
        return dict(x=r.x, obj=r.obj, epochs=r.client_epochs)
    if mesh is not None:
        prob = shard_problem_features(rows(prob), mesh)
    s = st.iterate(method, prob, "l1", sm,
                   **dict(kw, mode="timed" if mesh is not None else "fused"))
    return dict(x=s.x, obj=s.obj, fvaltest=s.fvaltest,
                epochs=np.asarray(s.epochs))


def mesh_worker(port, rank, workdir):
    """One of phase 23(b)'s four ranks (``--mesh-worker``): every case of
    `small_mesh_cases` on a 2×2 gloo mesh on the card; save."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from scso_tpu_torch.parallel import distributed_init, make_mesh

    rank = int(rank)
    torch.set_num_threads(1)
    if distributed_init("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=MESH_WORKERS, rank=rank) != MESH_WORKERS:
        fail(f"rank {rank}: the {MESH_WORKERS}-rank gloo group did not form")
    meshes = {"batch": make_mesh((2, 2), ("batch", "data")),
              "model": make_mesh((2, 2), ("data", "model"))}
    out = {}
    for name, (kind, build, method, kw) in small_mesh_cases().items():
        mesh = meshes["model" if kind == "cols" else "batch"]
        for f, v in small_mesh_run(kind, build, method, kw, "cuda",
                                   mesh).items():
            out[f"{name}.{f}"] = torch.as_tensor(v).cpu().numpy()
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


def free_graphs() -> float:
    """Drop every cached capture and return its memory to the card; the
    GB still allocated."""
    import gc

    import torch

    from scso_tpu_torch.ops.cuda import graph

    graph.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 1e9


def phase_mesh2d(prob_t, best, kern):
    """Phase 23 (see the module docstring)."""
    import numpy as np
    import torch

    import scso_tpu_torch as st
    from scso_tpu_torch.ops.cuda import counters
    from scso_tpu_torch.parallel import (
        make_mesh, shard_problem, shard_problem_features, sweep)

    out = {}
    lam = mesh2d_lams()
    meth = st.ProxGGNSCORE(**F32_CG)
    sm = st.PHuberSmootherL1L2(1.0)
    opts = st.Options(**MESH2D_KW)
    bd = make_mesh((1, 1), ("batch", "data"))
    runs, secs = {}, {}
    log(f"  card memory before: {free_graphs():.2f} GB allocated once the "
        "earlier phases' captures are dropped")
    for name, prob, mesh in (("no_mesh", prob_t, None),
                             ("batch_data", shard_problem(prob_t, bd), bd)):
        run = lambda: sweep(meth, prob, "l1", sm, lam_grid=lam, opts=opts,
                            plan="throughput", mesh=mesh)
        run()  # the capture
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name] = run()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        free_graphs()  # a capture at this width holds A-sized temporaries
    a, b = runs["no_mesh"], runs["batch_data"]
    same_bits("phase 23 sweep: 1x1 ('batch', 'data') against no mesh "
              "(x, obj, epochs)", [b.x, b.obj, b.epochs],
              [a.x, a.obj, a.epochs])
    out["sweep"] = dict(instances=len(lam), seconds=secs["batch_data"],
                        no_mesh_seconds=secs["no_mesh"],
                        epochs=b.epochs.tolist(),
                        obj=b.obj.tolist())
    log("  sweep on a 1x1 ('batch', 'data') mesh: bitwise the sweep on no "
        "mesh; " + json.dumps(out["sweep"]))
    free_graphs()
    dm = make_mesh((1, 1), ("data", "model"))
    cp = shard_problem_features(shard_problem(prob_t, dm), dm)
    solve_chunk(meth, cp)  # warm-up: the capture
    counters.reset()
    ch = timed_chain(meth, cp, best)
    launches = counters.snapshot()
    rel = abs(ch["obj"] - kern["obj"]) / abs(kern["obj"])
    log(f"  cached chain on a 1x1 ('data', 'model') mesh (the products "
        f"route): {ch['seconds']:.4f} s (phase 3: {kern['seconds']:.4f} "
        f"s), {ch['epochs']} epochs, {ch['cg_iters']} CG iterations, obj "
        f"{ch['obj']:.9e} (rel to phase 3 {rel:.2e}), gap "
        f"{ch['gap']:.3e}, launches {launches}")
    if not (rel <= E2E_RTOL and ch["gap"] <= GAP * 1.05):
        fail(f"phase 23 column shard: obj rel {rel:.2e} to phase 3, gap "
             f"{ch['gap']:.3e}")
    check_launches(launches, ("score_update",), "column-sharded cached")
    ch.pop("first_info")
    out["cols_chain"] = dict(ch, rel_to_phase3=rel, launches=launches)

    # (b) four gloo ranks on the one card against the CPU
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        port = free_port()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-worker",
             str(port), str(r), work], cwd=ROOT)
            for r in range(MESH_WORKERS)]
        # the CPU's references while the ranks run
        refs = {name: {f: torch.as_tensor(v).cpu().numpy() for f, v in
                       small_mesh_run(kind, build, method, kw,
                                      "cpu").items()}
                for name, (kind, build, method, kw)
                in small_mesh_cases().items()}
        wait_all(procs, 600)
        codes = [p.returncode for p in procs]
        if any(codes):
            fail(f"phase 23(b): the mesh workers exited with {codes}")
        got = [dict(np.load(os.path.join(work, f"rank{r}.npz")))
               for r in range(MESH_WORKERS)]
    worst, bad = 0.0, []
    for name, ref in refs.items():
        for f, want in ref.items():
            for r in range(MESH_WORKERS):
                if not np.array_equal(got[r][f"{name}.{f}"],
                                      got[0][f"{name}.{f}"]):
                    bad.append(f"{name}.{f}: rank {r} differs from rank 0")
            have = got[0][f"{name}.{f}"]
            if f == "epochs":
                if not np.array_equal(have, want):
                    bad.append(f"{name}: epochs {have.tolist()} on the "
                               f"mesh, {want.tolist()} on the CPU")
                continue
            if have.shape != want.shape or not np.all(np.isfinite(have)):
                bad.append(f"{name}.{f}: shape {have.shape} against "
                           f"{want.shape}, or not finite")
                continue
            d = float(np.max(np.abs(have - want) / np.maximum(
                1.0, np.abs(want)))) if want.size else 0.0
            worst = max(worst, d)
            log(f"  23(b) {name}.{f}: {d:.3e} from the CPU")
            if not d <= SMALL_RTOL:
                bad.append(f"{name}.{f}: {d:.3e} from the CPU "
                           f"(> {SMALL_RTOL})")
    if bad:
        fail("phase 23(b): " + "; ".join(bad))
    out["four_gloo_ranks"] = dict(cases=len(small_mesh_cases()),
                                  max_rel_to_cpu=worst,
                                  seconds=time.perf_counter() - t0)
    log(f"  four gloo ranks on the card, 2x2 meshes: "
        f"{len(small_mesh_cases())} cases within {worst:.2e} of the CPU "
        f"(<= {SMALL_RTOL}), every rank bitwise alike "
        f"({out['four_gloo_ranks']['seconds']:.1f} s)")
    return out, launches

# ---------------------------------------------------------------------------
# phase 24: profiling, sanitize, serving and export, the native generator,
# the examples
# ---------------------------------------------------------------------------

#: the kernel-name fragments that mark one launch of each kernel in a
#: trace (chip_profile.py's GROUPS hold all of each kernel's names): K1's
#: partial sums, K2's and K2s's finalize (every form ends with it), and
#: K3's cluster kernel or its grid form's apply
TRACE_MARKS = {"normal_matvec": ("normal_matvec_partial",),
               "glm_prep": ("glm_finalize",),
               "score_update": ("score_update_cluster", "score_apply")}
SANITIZE_SHAPE = (4096, 500)


def launches_of(fn, total):
    """(fn(), seconds, the launches it made: counters reset before);
    the launches are added to ``total`` too."""
    import torch

    from scso_tpu_torch.ops.cuda import counters

    counters.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    lc = counters.snapshot()
    for k, c in lc.items():
        total[k] += c
    return out, secs, lc


def trace_counts(trace_dir):
    """Kernel launches in the Chrome trace under ``trace_dir``, by
    TRACE_MARKS' kernel."""
    import glob

    paths = glob.glob(os.path.join(trace_dir, "trace_*.json"))
    if len(paths) != 1:
        fail(f"profile_solve wrote {len(paths)} traces, expected one")
    with open(paths[0]) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {k: sum(any(m in n for m in marks) for n in names)
            for k, marks in TRACE_MARKS.items()}, len(names)


def phase_native():
    """Phase 24(d): the fresh data of 24(a), made by the native
    generator, and its seconds against numpy's."""
    import numpy as np

    from scso_tpu_torch import _native
    from scso_tpu_torch.models import synthetic

    if not _native.available():
        fail("the native generator did not build or load (g++ -fopenmp)")
    kw = dict(density=0.05, n_active=64, seed=SEED + 1, dtype=np.float32,
              label01=True)
    t0 = time.perf_counter()
    data = synthetic.make_sparse_logreg_data(*MAIN_SHAPE, backend="native",
                                             **kw)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = synthetic.make_sparse_logreg_data(*MAIN_SHAPE, **kw)
    numpy_s = time.perf_counter() - t0
    del ref
    if not all(np.isfinite(a).all() for a in data):
        fail("the native generator made non-finite data")
    out = dict(native_s=native_s, numpy_s=numpy_s, threads=_native.threads())
    log(f"  native generator {MAIN_SHAPE[0]}x{MAIN_SHAPE[1]}: "
        f"{native_s:.3f} s ({out['threads']} OpenMP threads), numpy "
        f"{numpy_s:.3f} s")
    return data, out


def same_served(what, got, sol):
    """Fail unless a served (x, epochs, obj) is ``sol``'s bit for bit."""
    import torch

    x, k, obj = got
    if int(k) != sol.epochs or not torch.equal(x, sol.x) \
            or float(obj) != float(sol.obj[-1]):
        fail(f"{what}: served epochs {int(k)}, obj {float(obj)!r} against "
             f"iterate's {sol.epochs}, {float(sol.obj[-1])!r}, or x differs")


def chain_template(prob_t):
    """(phase 3's problem with the chain's L = 1/alpha, the chain's
    Options): what serving and export bake in of phase 3's solve."""
    import torch

    import scso_tpu_torch as st
    from scso_tpu_torch._src.struct import replace

    kw = dict(CHUNK_KW)
    alpha = kw.pop("alpha")
    return (replace(prob_t, L=torch.full((), 1.0 / alpha,
                                         dtype=prob_t.dtype,
                                         device=prob_t.device)),
            st.Options(**kw))


def phase_serving(prob_t, data, total):
    """Phase 24(a) (see the module docstring)."""
    import numpy as np
    import torch

    import scso_tpu_torch as st
    from scso_tpu_torch._src.struct import replace
    from scso_tpu_torch.models import losses
    from scso_tpu_torch.ops.cuda import graph
    from scso_tpu_torch.utils import make_serving_fn

    meth, sm = st.ProxGGNSCORE(**F32_CG), st.PHuberSmootherL1L2(1.0)
    tpl, opts = chain_template(prob_t)
    out = {}

    def call(name, serve, args, ref):
        graph.reset_stats()
        got, secs, lc = launches_of(lambda: serve(*args), total)
        same_served(f"phase 24(a) {name}", got, ref)
        check_launches(lc, LOGISTIC_KERNELS, f"phase 24(a) {name}")
        out[name] = dict(seconds=secs, epochs=ref.epochs,
                         captures=graph.STATS["captures"],
                         capture_s=graph.STATS["capture_s"],
                         launches={k: lc[k] for k in LOGISTIC_KERNELS})
        log(f"  {name}: {secs:.4f} s, {ref.epochs} epochs, "
            f"{graph.STATS['captures']} captures "
            f"({graph.STATS['capture_s']:.3f} s), launches "
            f"{out[name]['launches']}")

    serve = make_serving_fn(meth, tpl, "l1", sm, opts)
    ref1 = solve_chunk(meth, prob_t)
    call("served call 1 (phase 3's data)", serve,
         (prob_t.A, prob_t.y, prob_t.x0), ref1)
    A2, y2, x02, _ = data
    fresh = st.Problem(A2, y2, x02, losses.logistic01_f, prob_t.lam,
                       grad_fx=losses.logistic01_grad,
                       glm=losses.LOGISTIC01_GLM,
                       sol=prob_t.x_star[: prob_t.n_true].cpu().numpy(),
                       dtype=torch.float32, device="cuda", pad_features=True)
    ref2 = solve_chunk(meth, fresh)
    call("served call 2 (fresh data)", serve, (A2, y2, x02), ref2)
    if out["served call 2 (fresh data)"]["captures"]:
        fail("phase 24(a): the second served call captured anew")
    out["fresh_obj"] = float(ref2.obj[-1])
    del serve, fresh
    if not np.isfinite(out["fresh_obj"]):
        fail("phase 24(a): non-finite objective on the fresh data")
    return out, (A2, y2, x02, ref2)


def phase_sanitize(total):
    """Phase 24(c) (see the module docstring)."""
    import torch

    import scso_tpu_torch as st
    from scso_tpu_torch._src.struct import replace
    from scso_tpu_torch.models import losses
    from scso_tpu_torch.utils import sanitize

    prob = build_problem(*SANITIZE_SHAPE, "cuda", torch.float32)
    meth, sm = st.ProxGGNSCORE(**F32_CG), st.PHuberSmootherL1L2(1.0)
    ref = solve_chunk(meth, prob)
    with sanitize(nans=True):
        s, secs, lc = launches_of(lambda: solve_chunk(meth, prob), total)
    if s.epochs != ref.epochs or not torch.equal(s.x, ref.x):
        fail("phase 24(c): the sanitized solve differs from the fused one")
    check_launches(lc, LOGISTIC_KERNELS, "phase 24(c) sanitized")

    def nan_f(A, y, x):
        return torch.log(losses.logistic01_f(A, y, x) - 10.0)

    bad = replace(prob, f=nan_f)
    try:
        with sanitize(nans=True):
            st.iterate(st.ProxLQNSCORE(), bad, "l1", sm, max_epoch=5,
                       verbose=0)
    except FloatingPointError as e:
        raised = str(e)
    else:
        fail("phase 24(c): a NaN loss did not raise under sanitize")
    if "log" not in raised:
        fail(f"phase 24(c): the error does not name the op: {raised}")
    log(f"  sanitized {SANITIZE_SHAPE[0]}x{SANITIZE_SHAPE[1]} cached solve: "
        f"{secs:.3f} s, {s.epochs} epochs, fused bits, launches "
        f"{ {k: lc[k] for k in LOGISTIC_KERNELS} }; NaN loss: {raised!r}")
    return dict(seconds=secs, epochs=s.epochs, raised=raised,
                launches={k: lc[k] for k in LOGISTIC_KERNELS})


def phase_examples(total):
    """Phase 24(e): each example of examples/torch once on the card, in
    this process, after the earlier phases (phase 12's dense solves made
    example 04's capture fail before C14's repair)."""
    import importlib.util

    import torch

    out = {}
    for path in sorted(os.listdir(os.path.join(ROOT, "examples", "torch"))):
        if not path[:2].isdigit():
            continue
        spec = importlib.util.spec_from_file_location(
            f"torch_example_{path[:-3]}",
            os.path.join(ROOT, "examples", "torch", path))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        res, secs, lc = launches_of(lambda: mod.main(device="cuda"),
                                    total)
        # a Solution's objective history (its first record may be +inf:
        # the box QP's x0 lies outside the box), or a sweep's objectives
        obj = torch.as_tensor(res.obj)
        final = obj if res.x.dim() == 2 else obj[-1:]
        if res.x.device.type != "cuda" or not bool(
                torch.isfinite(final).all()):
            fail(f"phase 24(e) {path}: not on the card, or non-finite")
        out[path[:-3]] = dict(seconds=secs, obj=float(obj[-1]),
                              launches={k: c for k, c in lc.items() if c})
        log(f"  example {path}: {secs:.2f} s, final objective "
            f"{float(obj[-1]):.8g}, launches {out[path[:-3]]['launches']}")
    return out


def phase_profile(prob_t, total):
    """Phase 24(b) (see the module docstring)."""
    import torch

    import scso_tpu_torch as st
    from scso_tpu_torch.utils import device_memory_stats, profile_solve

    meth = st.ProxGGNSCORE(**F32_CG)
    with tempfile.TemporaryDirectory() as d:
        (sol, prof), secs, lc = launches_of(lambda: profile_solve(
            meth, prob_t, "l1", st.PHuberSmootherL1L2(1.0), trace_dir=d,
            **CHUNK_KW), total)
        counts, kernels = trace_counts(d)
    want = {"normal_matvec": lc["normal_matvec"],
            "glm_prep": lc["glm_prep"] + lc["glm_prep_pair"],
            "score_update": lc["score_update"]}
    if counts != want or not all(want.values()):
        fail(f"phase 24(b): the trace shows {counts} launches, the counters "
             f"{want}")
    check_launches(lc, UNCACHED_KERNELS, "phase 24(b) profile_solve")
    ref = solve_chunk(meth, prob_t, mode="timed")
    if sol.epochs != ref.epochs or not torch.equal(sol.x, ref.x):
        fail("phase 24(b): profile_solve differs from the timed solve")
    mem = device_memory_stats(prob_t.device)
    log(f"  profile_solve: {secs:.3f} s, {prof['epochs']} epochs, mean "
        f"epoch {prof['mean_epoch_s']:.4f} s; the trace's {kernels} kernels "
        f"hold K1, K2s, K3 as {counts} (the counters' launches); "
        f"device_memory_stats {mem}")
    return dict(seconds=secs, epochs=prof["epochs"],
                mean_epoch_s=prof["mean_epoch_s"], trace=counts,
                trace_kernels=kernels, memory=mem,
                memory_before=prof["memory_before"],
                memory_after=prof["memory_after"])


def phase_utilities(prob_t):
    """Phase 24: (d), (a), (c), (e), then (b) (see the module
    docstring); the launches of all its solves; and 24(a)'s fresh data
    with ``iterate``'s solution on it (A, y, x0, solution), for phase
    25(a)."""
    from scso_tpu_torch.ops.cuda import counters

    total = dict.fromkeys(counters.KERNEL_LAUNCHES, 0)
    out = {"gb_after_free": free_graphs()}
    log(" (d) the native generator")
    data, out["native"] = phase_native()
    log(" (a) make_serving_fn, export_solver and load_solver")
    out["serving"], fresh = phase_serving(prob_t, data, total)
    del data
    free_graphs()
    log(" (c) sanitize")
    out["sanitize"] = phase_sanitize(total)
    log(" (e) the examples")
    out["examples"] = phase_examples(total)
    free_graphs()
    log(" (b) profile_solve (last: the profiler slows later replays)")
    out["profile"] = phase_profile(prob_t, total)
    return out, total, fresh


# ---------------------------------------------------------------------------
# phase 25: the exported solver, and a fused solve over gloo
# ---------------------------------------------------------------------------

EXPORT_SMALL_SHAPE = (4096, 500)   # phase 25(c)'s artifacts
OP_SHAPE = (4096, 1000)            # phase 25(d): K1, K2, K2s
OP_MGLM = [(4096, 128, 8, "float32"), (1031, 77, 3, "float64")]
OP_N = 10112                       # phase 25(d): K3 and K4 (m = 10)
EXPORT_RTOL = 1e-6   # x of the loaded program where export rewrote an op

#: the torch-only loader of phase 25(c), run in a process of its own
LOADER = r"""
import base64, io, json, os, sys, tempfile, zipfile
import numpy as np
import torch

out = {}
for name in sys.argv[1:]:
    blob = open(name + ".pt2", "rb").read()
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        lib = [n for n in z.namelist() if n.endswith("extra/scso_ops.so.b64")]
        if lib and not hasattr(torch.ops.scso, "normal_matvec"):
            path = os.path.join(tempfile.mkdtemp(), "libscso_ops.so")
            with open(path, "wb") as f:
                f.write(base64.b64decode(z.read(lib[0])))
            torch.ops.load_library(path)
    serve = torch.export.load(io.BytesIO(blob)).module()
    data = np.load(name + "_data.npz")
    args = [torch.from_numpy(data[v]).cuda() for v in ("A", "y", "x0")]
    x, k, obj = serve(*args)
    np.save(name + "_x.npy", x.cpu().numpy())
    out[name] = [int(k), float(obj)]
leaked = [m for m in sys.modules if m.startswith("scso_tpu")]
assert not leaked, leaked
print(json.dumps(out))
"""


def op_checks(gen):
    """Phase 25(d): each custom op (``torch.ops.scso.*``, the wrappers
    under ``launch.via_ops``) against its plain version, with the
    tolerances of phase 2, and against the ctypes launch of the same
    kernel in the same form: the same bits. {op: max abs err}."""
    import torch

    from scso_tpu_torch.models.losses import (
        LOGISTIC01_GLM, LSQ_GLM, POISSON_GLM, multinom_mglm)
    from scso_tpu_torch.ops.cuda import glm_prep as k2
    from scso_tpu_torch.ops.cuda import launch
    from scso_tpu_torch.ops.cuda import mglm_matvec as k5
    from scso_tpu_torch.ops.cuda import score_update as k3
    from scso_tpu_torch.ops.cuda import two_loop as k4
    from scso_tpu_torch.ops.cuda.matvec import (
        normal_matvec, normal_matvec_torch)

    errs = {}

    def check(name, run, plain, tol):
        got = run()
        with launch.via_ops():
            op = run()
        got, op = ([t] if isinstance(t, torch.Tensor) else list(t)
                   for t in (got, op))
        for i, (u, v) in enumerate(zip(got, op)):
            if not torch.equal(u, v):
                fail(f"phase 25(d) {name}: the op's output {i} differs "
                     "from the ctypes launch's")
        want = plain()
        want = [want] if isinstance(want, torch.Tensor) else list(want)
        err = max(compare(f"phase 25(d) {name}", u, w, tol)
                  for u, w in zip(op, want))
        errs[name] = max(errs.get(name, 0.0), err)

    m, n = OP_SHAPE
    for dn in ("float32", "float64"):
        dt = getattr(torch, dn)
        r = lambda *s: torch.randn(s, generator=gen, device="cuda",
                                   dtype=dt)
        A, v = r(m, n), r(n)
        w = torch.rand((m,), generator=gen, device="cuda", dtype=dt)
        y = (torch.rand((m,), generator=gen, device="cuda") < 0.5).to(dt)
        xt, xd = r(n) * 0.05, r(n) * 0.05
        A_lp = A.to(torch.bfloat16)
        check("normal_matvec", lambda: normal_matvec(A, w, v),
              lambda: normal_matvec_torch(A, w, v), dn)
        check("normal_matvec_bf16", lambda: normal_matvec(A_lp, w, v),
              lambda: normal_matvec_torch(A_lp, w, v), dn)
        for glm, tag in ((LOGISTIC01_GLM, ""), (LSQ_GLM, "_lsq"),
                         (POISSON_GLM, "_poisson"),
                         (least_squares_glm(), "_split")):
            yy = y if glm is not LSQ_GLM else r(m)
            for flavour, name in (("ggn", "glm_prep_pair"),
                                  ("newton", "glm_prep_pair_newton")):
                check(name + tag, lambda: k2.glm_prep_pair(
                    A, yy, xt, xd, glm, flavour=flavour),
                    lambda: k2.glm_prep_pair_torch(A, yy, xt, xd, glm,
                                                   flavour=flavour), dn)
            check("glm_prep" + tag, lambda: k2.glm_prep(A, yy, xt, glm),
                  lambda: k2.glm_prep_torch(A, yy, xt, glm)[:3], dn)
        check("glm_prep_pair_bf16", lambda: k2.glm_prep_pair(
            A_lp, y, xt, xd, LOGISTIC01_GLM),
            lambda: k2.glm_prep_pair_torch(A_lp, y, xt, xd,
                                           LOGISTIC01_GLM), dn)
        check("glm_prep_bf16", lambda: k2.glm_prep(A_lp, y, xt,
                                                   LOGISTIC01_GLM),
              lambda: k2.glm_prep_torch(A_lp, y, xt, LOGISTIC01_GLM)[:3],
              dn)
        for reg in ("l1", "indbox"):
            args = score_update_inputs(OP_N, reg, dt, gen)
            check("score_update", lambda: k3.score_update(*args),
                  lambda: k3.score_update_torch(*args), dn)
        mem, g = two_loop_inputs(OP_N, 10, 7, dt, gen)
        check("two_loop", lambda: k4.two_loop(mem, g),
              lambda: k4.two_loop_torch(mem, g), dn)
    for mm, p, k, dn in OP_MGLM:
        dt = getattr(torch, dn)
        A, y, Z, V = mglm_inputs(mm, p, k, dt, gen)
        tol = "k5" if dn == "float32" else dn
        for spec in (multinom_mglm(k), squared_moglm(k)):
            check("mglm_matvec", lambda: k5.mglm_matvec(A, y, Z, V, spec),
                  lambda: k5.mglm_matvec_torch(A, y, Z, V, spec), tol)
        if dn == "float32":
            A_lp = A.to(torch.bfloat16)
            check("mglm_matvec_bf16", lambda: k5.mglm_matvec(
                A_lp, y, Z, V, multinom_mglm(k)),
                lambda: k5.mglm_matvec_torch(A_lp, y, Z, V,
                                             multinom_mglm(k)), tol)
    return errs


def route_host_times(gen):
    """Phase 25(d): the host time a call of K3 (l1) and of K4 takes,
    float32 at n = OP_N, through the ctypes launch and through its custom
    op (`launch.via_ops`), `host_ms` measured ctypes, op, op, ctypes:
    {kernel: {route: [ms, ms]}}."""
    import contextlib

    import torch

    from scso_tpu_torch.ops.cuda import launch
    from scso_tpu_torch.ops.cuda import score_update as k3
    from scso_tpu_torch.ops.cuda import two_loop as k4

    args = score_update_inputs(OP_N, "l1", torch.float32, gen)
    mem, g = two_loop_inputs(OP_N, 10, 7, torch.float32, gen)
    fns = {"score_update": lambda: k3.score_update(*args),
           "two_loop": lambda: k4.two_loop(mem, g)}
    out = {}
    for name, fn in fns.items():
        out[name] = {"ctypes": [], "op": []}
        for route in ("ctypes", "op", "op", "ctypes"):
            with (launch.via_ops() if route == "op"
                  else contextlib.nullcontext()):
                out[name][route].append(host_ms(fn))
    return out


def loaded_solve(serve, args, reps=2):
    """(the loaded program's (x, epochs, obj) on the data ``args`` (A,
    y, x0), the seconds of each of ``reps`` calls)."""
    import torch

    secs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = serve(*args)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return got, secs


def same_as_iterate(what, got, sol):
    """The loaded program's (x, epochs, obj) against ``iterate``'s: the
    same epochs, and x and the objective bit for bit, else within
    EXPORT_RTOL (reported). Returns the largest relative difference."""
    import torch

    x, k, obj = got
    if int(k) != sol.epochs:
        fail(f"{what}: {int(k)} epochs, iterate's {sol.epochs}")
    if torch.equal(x, sol.x) and float(obj) == float(sol.obj[-1]):
        return 0.0
    rel = float((x - sol.x).abs().max() / sol.x.abs().max().clamp_min(1e-30))
    if not rel <= EXPORT_RTOL:
        fail(f"{what}: x differs from iterate's by {rel:.3e} relative")
    log(f"  {what}: x within {rel:.3e} of iterate's (not bitwise)")
    return rel


def phase_export(prob_t, serve_s, fresh, sols22, ops_build, total):
    """Phase 25 (see the module docstring)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    import scso_tpu_torch as st
    from scso_tpu_torch.ops.cuda import build, graph
    from scso_tpu_torch.parallel import (
        distributed_init, make_mesh, shard_problem)
    from scso_tpu_torch.utils import export_solver, load_solver

    out = {"gb_after_free": free_graphs()}
    meth, sm = st.ProxGGNSCORE(**F32_CG), st.PHuberSmootherL1L2(1.0)
    tpl, opts = chain_template(prob_t)
    t0 = time.perf_counter()
    build.load_ops()  # built in the background since phase 1
    ops_wait = time.perf_counter() - t0
    log(f"  the op library: built in {ops_build.get('seconds', 0.0):.2f} s "
        f"beside phases 2-24, {ops_wait:.2f} s waited for it here")
    log(" (a) export phase 3's solve, load it, solve")
    ref, _, lc = launches_of(lambda: solve_chunk(meth, prob_t), total)
    want = {"normal_matvec": lc["normal_matvec"],
            "glm_prep": lc["glm_prep"] + lc["glm_prep_pair"],
            "score_update": lc["score_update"]}
    t0 = time.perf_counter()
    blob = export_solver(meth, tpl, "l1", sm, opts)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    serve = load_solver(blob, "cuda")
    load_s = time.perf_counter() - t0
    got, secs = loaded_solve(serve, (prob_t.A, prob_t.y, prob_t.x0))
    rel = same_as_iterate("phase 25(a) the loaded program", got, ref)
    # the data of 24(a)'s second served call: what the program derives
    # from its data (the padding, diag(AᵀA), the epoch cache at x0) comes
    # from the call's
    A2, y2, x02, ref2 = fresh
    got2, secs2 = loaded_solve(serve, (A2, y2, x02), reps=1)
    same_served("phase 25(a) the loaded program on fresh data", got2, ref2)
    del got2
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        parts = {i.filename: i.file_size for i in z.infolist()}
    lib = sum(v for k, v in parts.items() if k.endswith("scso_ops.so.b64"))
    out["main"] = dict(export_s=export_s, artifact_bytes=len(blob),
                       ops_library_b64_bytes=lib,
                       program_json_bytes=sum(
                           v for k, v in parts.items()
                           if k.endswith("model.json")),
                       load_s=load_s, solve_s=secs, served_s=serve_s,
                       epochs=ref.epochs, rel_x=rel, launches=want,
                       fresh_solve_s=secs2[0], fresh_epochs=ref2.epochs,
                       ops_build_s=ops_build.get("seconds"),
                       ops_wait_s=ops_wait)
    log(f"  export {export_s:.2f} s, {len(blob)} bytes ({lib} of them the "
        f"op library in base64), load {load_s:.2f} s,"
        f" loaded solve {secs} s ({ref.epochs} epochs; iterate's bits: "
        f"{rel == 0.0}) against phase 24's served call {serve_s:.4f} s; "
        f"on 24(a)'s fresh data {secs2[0]:.4f} s, {ref2.epochs} epochs, "
        "iterate's bits")
    log(" (b) a profiler trace of the loaded solve")
    with tempfile.TemporaryDirectory() as d:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # a kernel ahead of the solve's: one trace of this session,
            # the process's second (after 24(b)'s), held K2 20 times
            # against the counters' 21, the loaded solve giving
            # iterate's x and epochs
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            serve(prob_t.A, prob_t.y, prob_t.x0)
            torch.cuda.synchronize()
        prof.export_chrome_trace(os.path.join(d, "trace_loaded.json"))
        counts, kernels = trace_counts(d)
    if counts != want or not all(want.values()):
        fail(f"phase 25(b): the loaded solve's trace shows {counts}, "
             f"iterate's counters {want}")
    out["main"]["trace"], out["main"]["trace_kernels"] = counts, kernels
    log(f"  the trace's {kernels} kernels hold K1, K2, K3 as {counts}: "
        "iterate's counters")
    del serve, blob, got
    log(" (c) a process with torch and numpy alone loads 4096x500 "
        "artifacts (cached GGN-CG; L-BFGS, K4) with their op library")
    small = build_problem(*EXPORT_SMALL_SHAPE, "cuda", torch.float32)
    cases = {"cached": (meth, LOGISTIC_KERNELS),
             "lbfgs": (st.ProxLQNSCORE(m=10), LBFGS_KERNELS)}
    sopts = st.Options(max_epoch=60, verbose=0)
    with tempfile.TemporaryDirectory() as d:
        here = {}
        for name, (method, kernels) in cases.items():
            sol, _, slc = launches_of(lambda: st.iterate(
                method, small, "l1", sm, max_epoch=60, verbose=0), total)
            check_launches(slc, kernels, f"phase 25(c) {name} iterate")
            blob = export_solver(method, small, "l1", sm, sopts)
            if name == "lbfgs" and b"scso.two_loop" not in blob:
                with zipfile.ZipFile(io.BytesIO(blob)) as z:
                    text = b"".join(z.read(f) for f in z.namelist()
                                    if f.endswith(".json"))
                if b"two_loop" not in text:
                    fail("phase 25(c): the L-BFGS program holds no K4 op")
            got, _ = loaded_solve(load_solver(blob, "cuda"),
                                  (small.A, small.y, small.x0), reps=1)
            same_as_iterate(f"phase 25(c) {name}", got, sol)
            here[name] = got
            with open(os.path.join(d, name + ".pt2"), "wb") as f:
                f.write(blob)
            np.savez(os.path.join(d, name + "_data.npz"),
                     A=small.A.cpu().numpy(), y=small.y.cpu().numpy(),
                     x0=small.x0.cpu().numpy())
        with open(os.path.join(d, "loader.py"), "w") as f:
            f.write(LOADER)
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "loader.py", *cases], cwd=d,
                             env=env, capture_output=True, text=True,
                             timeout=600)
        sub_s = time.perf_counter() - t0
        if run.returncode != 0:
            fail(f"phase 25(c): the torch-only loader failed:\n"
                 f"{run.stderr[-4000:]}")
        res = json.loads(run.stdout.strip().splitlines()[-1])
        for name, (x, k, obj) in here.items():
            xs = torch.from_numpy(np.load(os.path.join(d, name + "_x.npy")))
            if (res[name] != [int(k), float(obj)]
                    or not torch.equal(xs, x.cpu())):
                fail(f"phase 25(c) {name}: the torch-only process gave "
                     f"{res[name]} against {[int(k), float(obj)]}, or x "
                     "differs")
    out["subprocess"] = dict(seconds=sub_s, solves=res)
    log(f"  the torch-only process: {sub_s:.2f} s, {res}, this process's "
        "bits; scso_tpu_torch never imported there")
    del small
    log(" (d) each custom op against its plain version and its ctypes "
        "launch")
    build.load_ops()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 25)
    out["ops"] = op_checks(gen)
    log(f"  custom ops, max abs err against the plain versions "
        f"(the ctypes launches' bits): {out['ops']}")
    out["route_host_ms"] = route_host_times(gen)
    log(f"  host ms a call, float32 n={OP_N}, ctypes against the op "
        f"(measured ctypes, op, op, ctypes): {out['route_host_ms']}")
    log(" (e) a fused solve over a one-rank gloo group on the card")
    with tempfile.TemporaryDirectory() as d:
        size = distributed_init("gloo", init_method=f"file://{d}/rdv",
                                world_size=1, rank=0)
        if size != 1 or dist.get_backend() != "gloo":
            fail("phase 25(e): the one-rank gloo group did not form")
        want_sol = sols22["uncached"]
        uncached = st.ProxGGNSCORE(**F32_CG, epoch_cache=False)
        graph.reset_stats()
        s, secs, glc = launches_of(lambda: solve_chunk(
            uncached, shard_problem(prob_t, make_mesh())), total)
        dist.destroy_process_group()
    same_solution("phase 25(e) fused over gloo vs phase 22's one NCCL "
                  "rank", want_sol, s)
    if graph.STATS["captures"]:
        fail("phase 25(e): the fused solve over gloo captured")
    check_launches(glc, UNCACHED_KERNELS + ("normal_matvec_sharded",),
                   "phase 25(e) gloo")
    out["gloo"] = dict(seconds=secs, epochs=s.epochs,
                       host_reads=graph.STATS["host_reads"],
                       launches={k: glc[k] for k in UNCACHED_KERNELS})
    log(f"  uncached GGN-CG over gloo, uncaptured: {secs:.3f} s, "
        f"{s.epochs} epochs, {graph.STATS['host_reads']} host reads, "
        f"phase 22's one-NCCL-rank bits; launches {out['gloo']['launches']}")
    return out


def start_ops_build() -> dict:
    """Build the op library (phase 25) in a thread while the phases
    before it run, on the host's spare cores; phase 25's `build.load_ops`
    waits for it, and raises with the compilers' output if it failed.
    Joined at exit, so that no compiler outlives the script. {'seconds':
    the build's, once done}."""
    import atexit
    import threading

    from scso_tpu_torch.ops.cuda import build

    out = {}

    def run():
        t0 = time.perf_counter()
        try:
            build.build_ops()
        except Exception:  # raised again in phase 25, with the output
            return
        out["seconds"] = time.perf_counter() - t0

    t = threading.Thread(target=run, daemon=True)
    t.start()
    atexit.register(t.join)
    return out


T_START = time.perf_counter()


def main():
    if not os.path.isdir(os.path.join(ROOT, "scso_tpu_torch")):
        fail("scso_tpu_torch not found beside chip_smoke.py: run it from "
             "the root of a checkout")
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script measures "
             "the GPU and does not run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:2] == ["--rank-worker"]:
        return rank_worker(*sys.argv[2:])
    if sys.argv[1:2] == ["--mesh-worker"]:
        return mesh_worker(*sys.argv[2:])
    import torch.distributed as dist

    import scso_tpu_torch as st
    from scso_tpu_torch.ops.cuda import build

    log("phase 1: card and build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    log(card)
    res = build.build()
    build.load()
    log(f"  kernels built in {res.seconds:.2f} s -> {res.path} "
        "(nvcc's report: build.log beside it)")
    ops_build = start_ops_build()

    mesh = one_rank_nccl()
    log("phase 2: kernels against their plain versions")
    errs, times, work, split = phase_kernels(mesh)

    log("phase 3/4: sparse-logistic path at full width, and cross-checks")
    kern, plain, launches, prob_t, best = phase_main_path(timed_mode=True)
    phase_small_f64(st.ProxGGNSCORE(solver="cg", greedy_alpha=False),
                    "GGN-CG")

    log("phase 5: multinomial path at full width, and cross-checks")
    mkern, mplain, mlaunches, mprob_t, mbest = phase_multinomial()

    log("phase 6: L-BFGS path at full width, and cross-checks")
    lkern, lplain, llaunches = phase_lbfgs(prob_t)

    log("phase 7: uncached GGN-CG path at full width, and cross-checks")
    ukern, uplain, ulaunches = phase_uncached(prob_t, best)

    log("phase 8: the row-sharded cached GGN-CG path")
    log(" (a) one rank over NCCL, full width")
    skern, slaunches = phase_sharded_one_rank(mesh, prob_t, best, kern,
                                              launches)
    torch.cuda.empty_cache()
    log(" (b) two ranks on the one card over gloo")
    two = phase_sharded_two_ranks()

    log(f"phase 9: the cached GGN-CG path at {NARROW_SHAPE[0]}x"
        f"{NARROW_SHAPE[1]} (the JAX bench's secondary shape)")
    nkern, nplain, nlaunches, nprob_t, nbest = phase_main_path(NARROW_SHAPE)

    log("phase 10: phase 3's problem with kind=None in its GLM spec, "
        "under kernels='auto'")
    kkern, kplain, klaunches = phase_kind_none(prob_t, best)

    log("phase 11: the cached chain with a bfloat16 copy of A "
        "(auto_lp=True) against A in float32")
    lp, lplaunches = phase_lp((prob_t, best, kern["obj"]),
                              (nprob_t, nbest, nkern["obj"]))
    del nprob_t
    torch.cuda.empty_cache()

    log("phase 12: the Newton-CG path (ProxNSCORE) at full width, and "
        "the small Newton and dense GGN solves")
    ekern, eplain, elaunches, nwprob_t = phase_newton(prob_t, best)

    log("phase 13: iterate_mixed (the coarse phase with A in bfloat16) and "
        "the cached multinomial chain with a bfloat16 copy")
    mixed, xlaunches = phase_mixed(
        (prob_t, best, kern["obj"], ukern["obj"]),
        (nwprob_t, ekern["anchor_obj"], ekern["obj"]),
        (mprob_t, mbest, mkern["obj"]))
    del nwprob_t
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log("phase 14: the sparse-group-lasso path (least squares, 'gl') at "
        "full width, and small float64 group-lasso solves")
    gl, glaunches = phase_gl_path()
    log(f"  phase 14: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    log("phase 15: the Poisson l1 path at the main path's shape, and small "
        "float64 Poisson solves")
    pkern, pplain, plaunches = phase_poisson()
    log(f"  phase 15: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    log("phase 16: mini-batches at full width")
    batches = phase_minibatch(prob_t)
    log(f"  phase 16: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    log("phase 17: problems without data (box QP, Rosenbrock) and the "
        "generic GGN-CG branch")
    nodata = phase_no_data(prob_t)
    log(f"  phase 17: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    log("phase 18: metrics, a test set and resume; static_precond and "
        "curvature_rows")
    resume = phase_resume(prob_t, best)
    log(f"  phase 18: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    log("phase 19: mu/lambda continuation")
    cont = phase_continuation(prob_t, best)
    log(f"  phase 19: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    log("phase 20: the lambda sweep (bench.py family_sweep(big=True)) as one "
        "batched solve")
    swept = phase_sweep()
    log(f"  phase 20: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    log("phase 21: federated rounds (examples/09_federated.py)")
    fed = phase_federated()
    log(f"  phase 21: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    log("phase 22: every single-instance method on a row shard over one "
        "NCCL rank, captured, against its unsharded fused solve")
    sharded22, s22launches, sols22 = phase_sharded_methods(mesh, prob_t,
                                                           mprob_t)
    log(f"  phase 22: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    log("phase 23: meshes of two axes: a sweep on ('batch', 'data'), the "
        "cached chain on ('data', 'model'), four gloo ranks on 2x2 meshes")
    mesh23, m23launches = phase_mesh2d(prob_t, best, kern)
    dist.destroy_process_group()
    log(f"  phase 23: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    log("phase 24: the native generator, serving and export, sanitize, the "
        "examples and profile_solve")
    utils24, u24launches, fresh24 = phase_utilities(prob_t)
    log(f"  phase 24: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    log("phase 25: the exported solver (torch.export, K1-K5 as custom ops) "
        "and a fused solve over gloo")
    from scso_tpu_torch.ops.cuda import counters

    u25launches = dict.fromkeys(counters.KERNEL_LAUNCHES, 0)
    export25 = phase_export(
        prob_t, utils24["serving"]["served call 1 (phase 3's data)"][
            "seconds"], fresh24, sols22, ops_build, u25launches)
    del fresh24
    log(f"  phase 25: {time.perf_counter() - t0:.1f} s")
    new_paths = [batches["launches"], resume["static_precond"]["launches"],
                 resume["curvature_rows"]["launches"], s22launches,
                 m23launches, u24launches, u25launches]
    new_paths += [v["launches"] for v in nodata.values()]
    launches = {k: launches[k] + mlaunches[k] + llaunches[k] + ulaunches[k]
                + slaunches[k] + nlaunches[k] + klaunches[k] + lplaunches[k]
                + elaunches[k] + xlaunches[k] + glaunches[k] + plaunches[k]
                + sum(lc[k] for lc in new_paths)
                for k in launches}

    # every module of the port is imported by now (the new ones of
    # phases 16-19 too): none may have brought in JAX or scso_tpu
    import importlib
    import pkgutil

    for mod in pkgutil.walk_packages(st.__path__, "scso_tpu_torch."):
        importlib.import_module(mod.name)
    leaked = [m for m in sys.modules
              if m == "jax" or m.startswith("jax.") or m == "scso_tpu"
              or m.startswith("scso_tpu.")]
    if leaked:
        fail(f"the port imported {leaked}")

    log("main path: " + json.dumps({"card": card, "kernels": kern,
                                    "torch": plain}))
    log("multinomial path: " + json.dumps({"card": card, "kernels": mkern,
                                           "torch": mplain}))
    log("L-BFGS path: " + json.dumps({"card": card, "kernels": lkern,
                                      "torch": lplain}))
    log("uncached GGN-CG path: " + json.dumps({"card": card,
                                               "kernels": ukern,
                                               "torch": uplain}))
    log("sharded path: " + json.dumps({"card": card, "one_rank": skern,
                                       **two}))
    log("sharded methods: " + json.dumps({"card": card, **sharded22}))
    log("secondary cached path: " + json.dumps({"card": card,
                                                "kernels": nkern,
                                                "torch": nplain}))
    log("kind=None path: " + json.dumps({"card": card, "auto": kkern,
                                         "torch": kplain}))
    log("lp path: " + json.dumps({"card": card, **lp}))
    log("Newton-CG path: " + json.dumps({"card": card, "kernels": ekern,
                                         "torch": eplain}))
    log("mixed path: " + json.dumps({"card": card, **mixed}))
    log("group-lasso path: " + json.dumps({"card": card, **gl}))
    log("Poisson path: " + json.dumps({"card": card, "kernels": pkern,
                                       "torch": pplain}))
    log("new paths: " + json.dumps({"card": card, "mini_batches": batches,
                                    "no_data": nodata, "resume": resume,
                                    "continuation": cont}))
    log("instance-parallel paths: " + json.dumps({"card": card,
                                                  "sweep": swept,
                                                  "federated": fed}))
    log("meshes of two axes: " + json.dumps({"card": card, **mesh23}))
    log("utilities: " + json.dumps({"card": card, **utils24}))
    log("exported solver: " + json.dumps({"card": card, **export25}))
    log(f"whole run: {time.perf_counter() - T_START:.1f} s")
    rows = []
    for k, (src, rep) in KERNELS.items():
        bound_ms, bound_by = bound(*work[k], k)
        rows.append({"name": k, "route": "cuda", "source": src,
                     "replaces": rep, "launches": launches[k],
                     "max_abs_err": errs[k], "ms": times[k][0],
                     "plain_ms": times[k][1], "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None})
        if k in split:
            rows[-1]["device_ms"], rows[-1]["host_ms"] = split[k]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
