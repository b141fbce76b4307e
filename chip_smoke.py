#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--reference-kernel DIR]

Run from the root of the repository on a machine with a CUDA GPU.  It
imports only ``rapidnet_tpu_torch``, torch and numpy, and in order:

1. builds the kernels from ``rapidnet_tpu_torch/csrc`` with nvcc;
2. builds the Barcelona-scale problem (nx=63 tanks, nu=114 actuators,
   nd=88 demands, ne=17 junctions, horizon 24, branching [5, 5]: 556
   nodes, 25 scenarios; seeds 42; auto-tuned; 500 APG iterations);
3. holds the whole-solve kernel to its plain PyTorch version on one
   step's solve (control, u, x and the infeasibility trace within
   1e-3 * max(|plain|, 1)), and checks that a tolerance solve stops at
   the same iteration on both.  From a state above the tank bounds it
   compares them directly over 50 iterations, and over the full 500
   against a float64 witness (the plain version in float64);
4. runs a 4-step closed loop through ``SmpcController(device="cuda")``
   and checks that every solve launched the kernel, that the controls
   and KPIs are finite and that they agree with the plain backend;
5. times the kernel and the plain version (median of 7 solves each,
   inputs staged on the device, synchronised around each solve); prints
   the variant the source picks for the Barcelona problem
   (``apg_solve.variant``: slot clusters of C CTAs, prefix clusters of
   Cp, staged matrices per phase), which must be ``apg_solve.pick``'s
   and clustered and staged in every phase; with ``--reference-kernel
   DIR``, DIR's ``apg_solve.cu`` and this one in turns (APG_AB_SOLVES a
   turn, 8 solves each), both medians and each one's device µs an
   iteration per phase kernel.

Then the batched kernel, at B = 32 instances whose states are
x0 * (1 + 0.02 N(0, 1)) (numpy seed 7, as bench.py:133-136):

6a. holds every instance of a batched call, in the shared-forecast form
    (uhat and e read by every instance) and in the stacked form, to the
    single-solve kernel on that instance's step: control, u, x, y and
    the trace within 1e-6 * max(|single|, 1), and says whether they are
    equal bit for bit, as they should be;
6b. holds all 32 instances to the plain batched version at 500
    iterations (1e-3 bound, as phase 3), and checks that under a
    tolerance every instance of a batched call stops at the plain
    version's iteration for it;
6c. holds the batched entry at B = 1 (compiled with the per-instance
    offsets) to the single solve (compiled without them), bit for bit;
    with ``--reference-kernel DIR`` (the ``csrc`` directory of an earlier
    checkout) also the single solve to that source's kernel (and, in 16,
    the streaming APG solve to its kernels, in 15 one K1 and one K2
    pass; in 12a the single FBE and NAMA solves to its ``qn_solve.cu``
    by 9a's TRACK rule and 9b's tail rule, since this source's flat
    passes sum the dual space in another order; and in 5, 8, 11, 14 and
    18 it times the APG solve, the B = 32 APG call, the QN solves, the B
    = 32 QN calls and the streaming solve on that source's kernels in
    turns with these);
7.  runs 3-step batched closed loops through
    ``BatchedSmpcController(device="cuda")`` with a shared forecaster,
    cold and warm-started: one kernel call per step, finite controls and
    KPIs, and instance 0's controls agree with a single-instance
    ``SmpcController(device="cuda")`` from the same state;
8.  times it: batch-32 solves/s (median of 5 batched 500-iteration
    solves), the pipelined rate (4 batched solves enqueued back to back,
    one synchronise, median of 3 rounds), the plain batched version
    (median of 3), and the batched solve's peak device memory; prints
    the variant the source picks at B = 32, which must be
    ``apg_solve.pick``'s with a staged prefix cluster (its slot phases
    fill the card at C = 1, where staging leaves fewer blocks resident:
    measured slower, so they run unstaged); with ``--reference-kernel
    DIR``, DIR's batched calls and these in turns (APG_AB_CALLS a turn,
    6 calls each), as in 5.

Then the whole-solve FBE/NAMA kernel (``csrc/qn_solve.cu``), for each of
the two algorithms, at the same problem with an L-BFGS buffer of 5
(bench.py:179-206):

9a. short-horizon parity: the kernel and its plain version over the
    first QN_TRACK_MAX iterations.  TRACK, printed, is the largest
    number of leading iterations over which tau, the FBE value and the
    infeasibility stay within the JAX package's bounds between two
    implementations (tests/test_pallas_qn.py:59-70) and after which the
    control stays within rtol 1e-3 / atol 1e-4 and u within 2e-3 *
    max(|u|, 1), the JAX package's bounds on its synthetic and its
    full-size problem (:85-87, :131-138); it must be at least the
    buffer size plus QN_TRACK_SPARE, so that the kernel's L-BFGS ring
    has wrapped (col = 1 + col % size, the two-loop's visits to the zero
    column) within the iterations held to the plain version.  Over TRACK
    the kernel's counts of line-search trials and of rejected curvature
    pairs equal the plain version's, and more pairs were accepted than
    the buffer holds.  Whether u also holds the synthetic problem's rtol
    1e-3 / atol 1e-3 is printed.
    (The line search branches on value comparisons, so two float32
    solves part after a while.)
9b. 500 iterations: the kernel's median |infeasibility| over the last 20
    iterations within 10 times the plain version's, the control within
    the physical bounds, and two calls equal bit for bit; printed beside
    them, the plain version's residual magnitudes;
9c. the tolerance exit, from tanks at 10 % of their maximum: of the
    tolerances that, by the plain version's residual magnitudes, stop it
    at an iteration past the first over which the traces agree and
    after which the solutions do (as 9a), the one farthest from the
    edges of its exit; the kernel stops at the same iteration, its
    control agrees (as 9a) and its traces are zero past the exit.  (From
    the nominal state the magnitude first falls below its first value
    only where the two float32 solves have parted: 9b prints where, and
    where the two stop under the tolerance the plain version's
    magnitudes suggest there, without gating on it.);
10. 4-step closed loops through ``SmpcController(backend="cuda")``, cold
    and warm-started: one kernel launch per step, finite controls and
    KPIs, the KPIs beside the APG loop's of phase 4 (recorded, not
    gated) and the mean ms per step;
11. timing: the median wall ms of 7 kernel solves (inputs staged,
    synchronised around each; the plain version's time is 9b's), the
    host's enqueue ms, the launches per iteration and the bound (its
    line-search trials as the kernel counted them); with
    ``--reference-kernel DIR``, DIR's ``qn_solve.cu`` and this one in
    turns (reference, these, these, reference; QN_AB_SOLVES solves a
    turn), both medians, and each one's device µs an iteration per phase
    kernel over a PROFILE_ITER-iteration solve (``torch.profiler``).

Then the batched FBE/NAMA kernel (the batch axis of ``csrc/qn_solve.cu``)
at B = 32, the states of phase 6, buffer 5, for each algorithm:

12a. one 500-iteration batched call in the shared-forecast form and one
     in the stacked form: every instance equal to the single-solve
     kernel on that instance's step bit for bit (control, u, x, y, the
     three traces, iterations, line-search trials, rejected pairs; the
     largest difference printed); the batched entry at B = 1 (compiled
     with the batch axis) equal to the single solve (compiled without
     it); with ``--reference-kernel DIR`` the single solve held to the
     kernel of DIR's ``qn_solve.cu`` by 9a's rules (TRACK >= buffer size
     + QN_TRACK_SPARE, equal trial and rejection counts over it) and
     9b's tail rule at 500 iterations, the largest control difference
     at 500 printed (the two sources sum the dual space in another
     order, so they are not bit-equal);
12b. instances 0-3 of a batched call against the plain batched version
     with 9a's rules: TRACK >= buffer size + QN_TRACK_SPARE, the counts of
     line-search trials and rejected pairs equal over TRACK, the ring
     wrapped, control and u within 9a's bounds;
12c. tolerance exits from tanks at LOW_FILL of their maximum, states
     scaled by 1 + 0.02 N(0, 1), under 9c's tolerance: every instance
     stops where its single-kernel solve stops, instances 0-3 where the
     plain version stops, and the traces are zero past each exit;
13.  3-step ``BatchedSmpcController(device="cuda")`` loops, shared
     forecast cold and warm, and stacked (one forecaster per instance):
     one kernel call per step, finite controls and KPIs; in the stacked
     form instance 0's controls equal a single-instance
     ``SmpcController(device="cuda")``'s from the same state bit for bit
     (the shared form's gap to it is printed, not gated: its root
     correction rounds differently);
14.  timing: batch-32 solves/s (median of 5 calls, inputs staged,
     synchronised around each), the host's enqueue ms, the launches per
     iteration, the peak device memory above what was held before, the
     plain batch's time on instances 0-3 of the last call over
     QN_TRACK_MAX iterations (its JSON entry says how many instances and
     iterations: all 32 at 500 would take many minutes) and the bound
     (the instances' operations, each with its own trial count, against
     the bytes); with ``--reference-kernel DIR``, DIR's batched calls and
     these in turns (QN_AB_CALLS a turn), both medians and each one's
     per-phase device µs an iteration as in 11.

Then the streaming APG kernels (``csrc/apg_stream.cu``) at BASELINE
config 5 (bench_ladder.py:47: the same widths and horizon over branching
[8, 8, 4, 4], 20,809 nodes, 1024 scenarios; seeds 42, auto-tuned, 500
iterations), a tree past the whole-solve kernels' limits:

15. one K1 pass and one K2 pass, from the state after PASS_ITER plain
    iterations from tanks at 1.2 times their maximum (nonzero duals),
    with shrinks PASS_SHRINKS, each output within PASS_FACTOR *
    max(|plain|, 1) of the plain halves (``k1_plain``, ``k2_plain``);
16. the 500-iteration solve against the plain APG solve
    (``apg.make_apg``): control, u, x, v, y and the trace within 1e-3 *
    max(|plain|, 1), or, where that fails, the float64 witness rule of
    phase 3; a warm start likewise; two calls equal bit for bit; and on
    the Barcelona problem the streaming kernels against the whole-solve
    kernel within 1e-3 * max(|kernel|, 1), two independent kernels;
17. 4-step closed loops through ``SmpcController(device="cuda")`` with
    backends ``auto``, ``stream`` and ``torch``: ``auto`` routes to the
    streaming kernels, each of the first two launches them once per
    step and no other kernel, their controls are equal bit for bit and
    within 1e-3 * max(|plain|, 1) of the plain loop's;
18. timing: the median wall ms of 7 solves (inputs staged, synchronised
    around each) and µs per iteration, the device µs per iteration of
    K1, K2, the scalar phase and the tail (``torch.profiler``), the
    plain version's time (``apg_stream_plain``), the peak device memory
    above what was held, the bound (``stream_bound``), and the variant
    the source picks for K1, K2 and the fused kernel
    (``apg_stream.staged``), which must be the staged one (matrices and
    a stage's operands in shared memory) for all three at config 5.

Then the streaming FBE/NAMA path (``solver/qn_stream.py`` over the sweeps
of ``csrc/stream_qn.cu`` and the history passes of ``csrc/lbfgs.cu``) at
config 5, L-BFGS buffer 5, 500 iterations:

19. one S1 and one S2 pass in each variant (solve step, Hessian oracle)
    from the duals of phase 15's stressed state, within PASS_FACTOR *
    max(|plain|, 1) of ``s1_plain`` / ``s2_plain``, and the kernels'
    variant (``stream_qn.staged``: staged at config 5, matrices and a
    stage's operands in shared memory); with ``--reference-kernel DIR``,
    both passes equal to DIR's ``stream_qn.cu`` bit for bit; one dots and one
    combine pass over a full history (seeded, column 0 zero) in float32
    and in bfloat16 storage, the dots within 1e-5 of the rep-weighted sum
    of the products' magnitudes, combine within 1e-6 * max(|plain|, 1);
20. per algorithm: TRACK (as 9a) between the kernels' solve and the
    plain QN solve (``quasi_newton.make_solver``), at least the JAX
    package's strict horizon (3 FBE, 2 NAMA); the 500-iteration solve
    with no host sync (``torch.cuda.set_sync_debug_mode('error')``), its
    residual tail within 10 times the plain version's, the control
    within the physical bounds, two calls equal bit for bit; a warm
    start from the plain solve's duals held as 9a; the bf16 history's
    control within 1e-1 * max(|f32|, 1) of the float32 one (the
    deviation printed); and on the Barcelona problem TRACK between the
    streaming solve and the whole-solve QN kernel;
21. per algorithm, 3-step loops (STREAM_QN_LOOP_STEPS, cut from 4 to fit
    the time limit) through ``SmpcController(device="cuda")``
    with backends ``auto`` (it must route to the streaming solve),
    ``stream`` and ``stream`` with ``stream_lbfgs_dtype="bfloat16"``: the
    S1, S2, dots and combine wrapper calls of every solve and no other
    kernel, finite controls and KPIs, ``auto`` and ``stream`` equal bit
    for bit; then a 2-step loop through ``torch`` (the plain solve), FBE,
    its gap to the streaming loop printed;
22. timing per algorithm and history storage: the median wall ms of 3
    solves (STREAM_QN_REPEATS, cut from 7; inputs staged), the host's
    enqueue ms, the peak device memory above what was held, the device µs
    per iteration of S1, S2, the dots, combine and the PyTorch glue with
    the idle share
    (``torch.profiler``, a PROFILE_ITER-iteration solve), the bound; and
    each kernel's ms per call at the main path's shapes beside its plain
    version's and its bound; the profiled solves must run the dots'
    vector body (``dots_vec_kernel``) with the bf16 history and the
    one-value body with the float32 one; with ``--reference-kernel DIR``, S1's and
    S2's ms per call, an FBE solve of STREAM_QN_AB_ITER iterations (cut
    from 500), and each history pass (dots and combine, float32 and
    bfloat16) on DIR's ``stream_qn.cu`` and ``lbfgs.cu`` and these in
    turns.

Then the scenario-sharded streaming solves (``ops/apg_stream_sharded.py``,
``solver/qn_stream.py`` with ``mesh=``; the per-shard K1/K2 and S1/S2 of
``csrc/apg_stream.cu`` and ``csrc/stream_qn.cu`` and the partial parent
block of ``csrc/stream_sharded.cu``) at config 5 over MESH_RANKS = 2
ranks: two processes, spawned once the kernels are built, share card 0
over a gloo group (NCCL refuses two ranks on one card).  Both ranks run
every phase; rank 0 prints:

23. one K1a pass (K1 over the rank's slots and stages N-1 .. s_hi, then
    the partial parent block), one partial parent block, one K2 pass on
    the block, and one sharded S1 pass (with its all-reduce and
    root-side stages) and one S2 pass on the block in each variant, from
    phase 15's stressed state, each within PASS_FACTOR * max(|plain|, 1)
    of the plain halves on the same card; with ``--reference-kernel
    DIR``, the partial parent block equal to DIR's ``stream_sharded.cu``
    bit for bit on both ranks;
24. the 500-iteration sharded APG solve against the single-device
    streaming solve (phase 16's kernels): control, u, x and the trace
    within 1e-3 * max(|ref|, 1) or under the float64 witness rule; a warm
    start likewise; two calls equal bit for bit;
25. FBE and NAMA: TRACK (as 9a) between the sharded and the single-device
    streaming solves, at least QN_SHORT; the MESH_QN_ITER-iteration
    (cut from 500) solve's residual tail within 10 times the
    single-device solve's; two calls equal bit for bit; the bf16
    history's control within 1e-1 * max(|f32|, 1); MESH_QN_REPEATS
    solves per algorithm and history storage, timed; a
    DOTS_BODY_ITER-iteration solve of each profiled on rank 0, whose
    dots must run the vector body with the bf16 history and the
    one-value body with the float32 one;
26. the main path: MESH_LOOP_STEPS-step loops (cut from 4 to keep the
    run inside its limit on slower hosts) through ``SmpcController(mesh=...,
    backend="auto")`` for APG (500 iterations) and FBE and NAMA
    (MESH_LOOP_ITER iterations a step, cut from 500 to fit the time
    limit): the route, every sharded wrapper's calls and no other
    kernel's, finite controls and KPIs, no leak; each against the
    single-device ``auto`` path (APG: the loop's controls within 1e-3 *
    max(|ref|, 1); FBE/NAMA: every step's solve, from the sharded loop's
    own step and warm start, held by 25's rule to the single-device auto
    solve of those inputs: TRACK at least QN_SHORT and the residual tail
    within 10 times);
27. timing: the median ms of 7 sharded APG solves and of 25's QN solves,
    rank 0's profile over PROFILE_ITER iterations (device µs per
    iteration of each kernel and of the glue, host µs in the collectives,
    idle share), each sharded kernel's ms per pass on rank 0's block
    (rank 1 idle) beside its plain half's and its bound, the partial
    parent block and its library call, ``x_Cp @ carry``, in turns
    (``in_turns``: ms a call by events over MAX_ITER calls, device µs a
    call by ``torch.profiler``), the peak memory of each rank; with
    ``--reference-kernel DIR``, the sharded S1
    (``s1a_call``) and S2 on rank 0's block equal to DIR's
    ``stream_qn.cu`` bit for bit (solve step and oracle), and their and
    the partial parent block's ms per pass on both sources in turns.

Then this slice's kernels and its main path:

28. the fused streaming APG kernel (``apg_stream_fused``: one
    cooperative launch an iteration, ``fused_kernel`` of
    ``csrc/apg_stream.cu``) on phase 15's config-5 problem: one fused
    iteration (``fused_call``) from phase 15's stressed state against
    ``fused_iteration_plain`` (``k1_plain`` then ``k2_plain``) within
    PASS_FACTOR * max(|plain|, 1); the 500-iteration solve against the
    two-kernel solve (the same stage bodies in the same order: bit for
    bit, else within SAME_FACTOR * max(|ref|, 1)) and against
    ``apg.make_apg`` by phase 16's rule; a warm start against the
    two-kernel warm start; two calls equal bit for bit; the device
    kernels of a PROFILE_ITER-iteration solve by ``torch.profiler`` (one
    ``fused_kernel`` an iteration, no K1 or K2; up to PROFILE_TRIES
    solves traced until one records a launch of either, since a trace
    may hold none of the graph-replayed cooperative launches) and the
    idle share; the
    median ms of 7 solves with the two-kernel solve timed in turns beside
    it, the peak memory, the bound;
29. the whole-solve FBE/NAMA kernel with its L-BFGS history in bf16
    (``lbfgs_dtype="bfloat16"``, the knob's main path
    ``make_qn_kernel``/``make_qn_kernel_batch``) at Barcelona scale, per
    algorithm: the first iteration (no history yet) equal to the float32
    history's; TRACK (as 9a) against the plain version with the same bf16
    round trip, at least QN_SHORT; at 500 iterations the control within
    0.1 * max(|f32|, 1) of the float32 history's (the JAX test's bound),
    the residual tail within 10 times the float32 history's, the physical
    bounds, bit-equal repeats; instance 0 of a B = 32 call bit for bit
    against the single solve (12a's rule); single solves timed in turns
    with the float32 history, B = 32 solves/s, memory, the bound; the
    plain version timed over QN_TRACK_MAX iterations;
30. the main path of this slice: the port's config ladder
    (``rapidnet_tpu_torch.bench_ladder --repeats 2``, rows 1-5 of
    BASELINE.md, written to ladder_out/LADDER_chip_smoke.json), every
    count zeroed just before it: every row without an error and
    launching its route's wrapper (the fused row the fused kernel; the
    bf16z row and the shardmap row, the plain sharded APG on a mesh of
    one rank, none); its document is printed on a line of its own;
31. the closed-loop CLI on the card: phase 2's problem written by the
    port's ``export_problem`` (with the engine's L and Lhat) into a
    temporary directory and read back bit for bit by the port's readers;
    ``rapidnet_tpu_torch.cli.main`` (what ``python -m
    rapidnet_tpu_torch.cli`` runs) in this process, CLI_STEPS = 2 steps
    with ``--device cuda``, with ``--profile-dir`` on the APG config and
    without it on an FBE config written by ``config_to_json``, every
    count zeroed just before each run: each returns 0 with the four KPI
    lines, finite KPIs and finite controls inside the physical bounds,
    and launches its whole-solve kernel (``apg_solve``, ``qn_solve``)
    once a step and no other (the JSON entries' ``cli_launches``); the
    trace names a kernel of ``csrc/apg_solve.cu``; step 0 of an
    in-process warm APG controller equals the CLI's control0, and,
    checkpointed after it (``utils/checkpoint.py``), the controller
    resumes step 1 bit for bit with the uninterrupted warm loop; so do
    warm FBE and NAMA controllers on the whole-solve kernel (route
    ``kernel``) and warm APG, FBE and NAMA controllers on the streaming
    route at config 5 (``auto``, route ``stream``) at RESUME_STREAM_ITER
    iterations a step;
32. (run by phases 23-27's two ranks, after them) the plain sharded
    solves (``parallel.make_sharded_apg``, ``make_sharded_quasi_newton``)
    through ``SmpcController(mesh=..., backend="auto")`` on the Barcelona
    network over branching [5, 2] (10 scenarios, 5 a rank; seeds 42,
    auto-tuned): APG under the tolerance PLAIN_MESH_TOL and FBE at
    PLAIN_MESH_QN_ITER iterations, PLAIN_MESH_STEPS-step loops, every
    count zeroed just before each: the route 'plain' and no kernel
    launched; the two ranks' step-0 controls equal bit for bit; the APG
    control within 1e-3 * max(|single|, 1) of the single-device plain
    solve on the card and FBE held to it by 9a's TRACK rule, with the
    same stopping iteration; the ms per solve printed beside the card's
    name and power limit;
33. the single-device examples on the card (``examples_phase``), in
    process through their ``main`` with ``--device cuda``, every count
    zeroed just before each: ``barcelona_scale --steps 2`` (route
    ``kernel``, ``apg_solve`` once a step), ``batched_monte_carlo --batch
    8 --steps 2`` (``apg_solve_batch`` once a step),
    ``large_tree_streaming`` at its defaults (64 scenarios; route
    ``stream``, ``apg_stream`` once a step) and ``epanet_to_controller``
    into a temporary directory (``apg_solve`` once a step), each with no
    other kernel, finite controls inside the physical bounds and finite
    KPIs, its wall s printed (the JSON entries' ``example_launches``);
34. the 2-D mesh, the dry run and the mesh resume (``run_mesh_2d_phase``):
    MESH2D_RANKS = 4 spawned ranks share card 0 over a gloo group, every
    rank running: 34a ``examples.dryrun.dryrun_multichip(4)`` (the plain
    sharded APG, the sharded streaming APG within 1e-3 of it, 3 sharded
    streaming FBE iterations, the 2-D mesh at B = 4), every count zeroed
    just before it: rows 7 (K1a, K2), 8 (the sharded S1, S2) and the
    partial parent block launched as phases 23-27 count them (the JSON
    entries' ``dryrun_launches``); 34b 2-step
    ``BatchedSmpcController(mesh=make_mesh_2d(2, 2))`` loops at B = 4 on
    the Barcelona network over MESH2D_BRANCHING, APG and FBE (a shared
    forecaster), route ``plain`` and no kernel launched, the ranks'
    controls equal bit for bit and within 2e-4 (rtol and atol, the JAX
    package's bound, tests/test_batch.py:189-190) of the single-device
    plain batched loop; 34c ``multichip_sharded --devices 4 --iterations
    40`` (finite controls, no kernel); 34d a warm save after step 0 and a
    resume of step 1 on the 1-D mesh of each row (``SmpcController(mesh=
    ...)``, 2 ranks, the plain route), bit for bit against the
    uninterrupted run.

Each phase prints its own line.  The last lines are the card's name and
power limit, one JSON line describing each kernel (with its bound: the
larger of its FP32 operations over 67 TFLOP/s and its bytes, each input
read once and each output written once, over 3.35 TB/s), and the result
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before
the result line, as does a machine without a CUDA GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import ctypes
import gc
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPEATS = 7
MAX_ITER = 500
STRESS_ITER = 50
TOL_FACTOR = 1e-3     # the JAX package's bound between two
                      # implementations of this solve
                      # (__graft_entry__.py:108-110)
WITNESS_FACTOR = 4.0  # the kernel may stray from the float64 witness
                      # at most this many times as far as the plain
                      # float32 version does: two float32 solves that
                      # sum in another order drift alike
BATCH = 32            # bench.py:32
SAME_FACTOR = 1e-6    # batched against single kernel: the same code on
                      # the same inputs, expected equal bit for bit
BATCH_REPEATS = 5     # bench.py:138-147
PIPELINE_DEPTH, PIPELINE_ROUNDS = 4, 3     # bench.py:161-171
FP32_FLOPS = 67e12    # H100 SXM, FP32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
KERNELS = ("apg_solve", "qn_solve", "apg_stream", "stream_qn",
           "lbfgs", "stream_sharded")       # sources under csrc/
BARCELONA_BRANCHING = (5, 5)        # bench.py:42-65: 556 nodes, ns 25
CONFIG5_BRANCHING = (8, 8, 4, 4)    # BASELINE config 5 (bench_ladder.py:47):
                                    # 20,809 nodes, ns 1024
PASS_FACTOR = 1e-4    # one K1 or K2 pass against its plain half: the same
                      # arithmetic in another order, one pass deep
PASS_ITER = 20        # phase 15's state: this many plain iterations
PASS_SHRINKS = (0.25, 0.5)   # phase 15's k1f, k2f: at these penalties
                             # (thresholds ~2.9e8 and ~2.9e6) the solves
                             # never shrink, so the pass is given shrinks
STREAM_LOOP_STEPS = 4
QN_ALGORITHMS = {"fbe": "globalFbeAlgorithm", "nama": "namaAlgorithm"}
QN_TRACK_MAX = 30     # the short budget of phases 9a and 9c
LOW_FILL = 0.1        # phase 9c's tanks, as a share of their maximum
QN_TRACK_SPARE = 3    # TRACK >= buffer size + 3: iterations 1 .. size + 2
                      # each offer a curvature pair, and the ring wraps at
                      # the (size + 1)-th accepted one, a rejection to spare
QN_TRACES = ("tau", "value_fbe", "primal_infeasibility")
QN_U_FACTOR = 2e-3    # u within 2e-3 * max(|u|, 1): the JAX package's bound
                      # on its full-size problem (tests/test_pallas_qn.py:131)
QN_LOOP_STEPS = 4
QN_SHORT = {"fbe": 3, "nama": 2}   # the JAX package's strict horizons between
                                   # its streaming and XLA QN solves
                                   # (tests/test_qn_stream.py:47-84)
PLAIN_LOOP_STEPS = 2  # phase 21's plain FBE loop at config 5
STREAM_QN_LOOP_STEPS = 3   # phase 21's streaming QN loops (cut from 4 to
                           # fit the time limit)
STREAM_QN_REPEATS = 3      # phase 22's timed solves per algorithm and
                           # history storage (cut from REPEATS = 7)
PROFILE_ITER = 50     # phase 22's profiled solves
STREAM_QN_AB_ITER = 200    # phase 22 with --reference-kernel: the FBE
                           # solve's iterations in turns (cut from 500)
PROFILE_TRIES = 3     # phase 28's traced solves at most
PLAIN_INSTANCES = 4   # phase 12b-c: the instances held to the plain batch
APG_AB_SOLVES = 4     # phase 5 with --reference-kernel: solves a turn
APG_AB_CALLS = 3      # phase 8 with --reference-kernel: B = 32 calls a turn
QN_AB_SOLVES = 3      # phase 11 with --reference-kernel: solves a turn
QN_AB_CALLS = 2       # phase 14 with --reference-kernel: B = 32 calls a turn
BATCH_LOOP_STEPS = 3
APG_KEYS = ("control", "u", "x", "primal_infeasibility", "y.xi", "y.psi")
QN_KEYS = APG_KEYS + ("value_fbe", "tau")
QN_INT_KEYS = ("iterations", "line_search_trials", "lbfgs_skips")
KPI_KEYS = ("economicKpi", "smoothKpi", "safetyKpi", "networkKpi")


class SmokeFailure(Exception):
    pass


def check_close(name, got, ref, factor=TOL_FACTOR):
    """|got - ref|_max <= factor * max(|ref|_max, 1) (factor 1e-3 by
    default); returns the error."""
    import torch
    got = got.detach().double().cpu()
    ref = ref.detach().double().cpu()
    if got.shape != ref.shape:
        raise SmokeFailure(f"{name}: shape {tuple(got.shape)} != "
                           f"{tuple(ref.shape)}")
    if not (torch.isfinite(got).all() and torch.isfinite(ref).all()):
        raise SmokeFailure(f"{name}: non-finite values")
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    bound = factor * max(float(ref.abs().max()) if ref.numel() else 0.0,
                         1.0)
    print(f"[compare] {name:22s} max_abs_err {err:.6g}  bound {bound:.6g}")
    if not err <= bound:
        raise SmokeFailure(f"{name}: kernel and plain version disagree "
                           f"({err:.6g} > {bound:.6g})")
    return err


def witness_check(name, kern, plain, wit):
    """The kernel's distance from a float64 witness against the plain
    float32 version's: kernel <= max(WITNESS_FACTOR * plain,
    1e-3 * max(|witness|, 1)).  Returns both distances."""
    import torch
    kern, plain, wit = (t.detach().double().cpu() for t in (kern, plain, wit))
    if not (torch.isfinite(kern).all() and torch.isfinite(plain).all()):
        raise SmokeFailure(f"{name}: non-finite values")
    e_k = float((kern - wit).abs().max())
    e_p = float((plain - wit).abs().max())
    scale = float(wit.abs().max())
    bound = max(WITNESS_FACTOR * e_p, TOL_FACTOR * max(scale, 1.0))
    print(f"[witness] {name:22s} kernel-f64 {e_k:.6g}  plain32-f64 "
          f"{e_p:.6g}  bound {bound:.6g}  max|f64| {scale:.6g}")
    if not e_k <= bound:
        raise SmokeFailure(f"{name}: kernel strays from the float64 "
                           f"witness ({e_k:.6g} > {bound:.6g})")
    return e_k, e_p


def instance(d, b):
    """Instance b of a batched dict of tensors (nested dicts too)."""
    return {k: instance(v, b) if isinstance(v, dict) else v[b].contiguous()
            for k, v in d.items()}


def compare_instances(name, got, refs, keys=APG_KEYS,
                      int_keys=("iterations",)):
    """Instance b of the batched outputs ``got`` against ``refs[b]``, on
    ``keys`` (control, u, x, y and the trace): max |error| within
    SAME_FACTOR * max(|ref|, 1), and ``int_keys`` equal.  Returns (max
    error, whether all were bit-equal)."""
    import torch

    def leaf(out, k):
        return out["y"][k[2:]] if k.startswith("y.") else out[k]

    worst, equal = 0.0, True
    for k in keys:
        err, scale = 0.0, 0.0
        for b, ref in enumerate(refs):
            g, r = leaf(got, k)[b], leaf(ref, k)
            if not (torch.isfinite(g).all() and torch.isfinite(r).all()):
                raise SmokeFailure(f"{name}.{k}[{b}]: non-finite values")
            equal &= bool(torch.equal(g, r))
            err = max(err, float((g.double() - r.double()).abs().max()))
            scale = max(scale, float(r.abs().max()))
        bound = SAME_FACTOR * max(scale, 1.0)
        print(f"[batch] {name}.{k:22s} max_abs_err {err:.6g} over "
              f"{len(refs)} instances  bound {bound:.6g}")
        if not err <= bound:
            raise SmokeFailure(f"{name}.{k}: batched and single kernel "
                               f"disagree ({err:.6g} > {bound:.6g})")
        worst = max(worst, err)
    for k in int_keys:
        for b, ref in enumerate(refs):
            if int(got[k][b]) != int(ref[k]):
                raise SmokeFailure(f"{name}: instance {b}'s {k} differ")
    return worst, equal


def solve_bound(kc, tensors, outputs, iterations, prefix_stages):
    """The least time (ms) the card could take for a solve and what
    sets it: the FP32 operations of its five products per row and the
    prefix aggregations, over 67 TFLOP/s, against the bytes of its
    inputs (each distinct buffer once, a batch-stride-0 view once) and
    outputs over 3.35 TB/s.  Elementwise work (~5% of the operations)
    is left out.  Returns (bound_ms, bound_by, flops, bytes)."""
    fa = kc["fa"]
    N, ns, nx = fa["d1"].shape
    nu = fa["g"].shape[-1]
    nv = fa["invWbar"].shape[0]
    per_row = 2 * (nu * nv + nx * nv + nv * nv + nv * nu + nu * nx)
    n_agg = sum(1 for s in prefix_stages if s > 0)
    B = outputs["u"].shape[0] if outputs["u"].dim() == 4 else 1
    flops = iterations * B * (N * ns * per_row +
                              2 * n_agg * ns * ns * (nx + nv))
    storages = {}
    for t in tensors:
        st = t.untyped_storage()
        storages[st.data_ptr()] = st.nbytes()
    nbytes = sum(storages.values()) + sum(
        t.numel() * t.element_size() for t in
        (outputs["x"], outputs["u"], outputs["y"]["xi"],
         outputs["y"]["psi"], outputs["primal_infeasibility"],
         outputs["iterations"], outputs["control"]))
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def within(got, ref, rtol, atol):
    """Whether |got - ref| <= atol + rtol |ref| everywhere."""
    got = got.detach().double().cpu()
    ref = ref.detach().double().cpu()
    return bool(((got - ref).abs() <= atol + rtol * ref.abs()).all())


def check_allclose(name, got, ref, rtol, atol):
    """Elementwise |got - ref| <= atol + rtol |ref|; returns max |error|."""
    import torch
    got = got.detach().double().cpu()
    ref = ref.detach().double().cpu()
    if got.shape != ref.shape:
        raise SmokeFailure(f"{name}: shape {tuple(got.shape)} != "
                           f"{tuple(ref.shape)}")
    if not (torch.isfinite(got).all() and torch.isfinite(ref).all()):
        raise SmokeFailure(f"{name}: non-finite values")
    diff = (got - ref).abs()
    err = float(diff.max()) if got.numel() else 0.0
    worst = float((diff - rtol * ref.abs()).max()) if got.numel() else 0.0
    print(f"[compare] {name:22s} max_abs_err {err:.6g}  (rtol {rtol:g}, "
          f"atol {atol:g}: worst excess {worst - atol:.6g})")
    if not worst <= atol:
        raise SmokeFailure(f"{name}: kernel and plain version disagree")
    return err


def qn_horizon(kern, plain, n):
    """The number of leading iterations over which the kernel's traces
    stay within the JAX package's bounds of the plain version's (tau
    rtol 1e-4 / atol 1e-6, value 2e-3 / 2e-4 max(|value|, 1),
    infeasibility 2e-3 / 1e-4; tests/test_pallas_qn.py:59-70)."""
    k = {key: kern[key].double().cpu().numpy() for key in QN_TRACES}
    p = {key: plain[key].double().cpu().numpy() for key in QN_TRACES}
    vscale = max(float(abs(p["value_fbe"][:n]).max()), 1.0)
    bounds = {"tau": (1e-4, 1e-6), "value_fbe": (2e-3, 2e-4 * vscale),
              "primal_infeasibility": (2e-3, 1e-4)}
    h = 0
    while h < n and all(abs(k[key][h] - p[key][h]) <= atol +
                        rtol * abs(p[key][h])
                        for key, (rtol, atol) in bounds.items()):
        h += 1
    return h


def solutions_agree(kern, plain):
    """Whether the kernel's control is within rtol 1e-3 / atol 1e-4 of
    the plain version's and its u within QN_U_FACTOR * max(|u|, 1).
    Returns (agree, u's atol)."""
    u_atol = QN_U_FACTOR * max(float(plain["u"].abs().max()), 1.0)
    return (within(kern["control"], plain["control"], 1e-3, 1e-4) and
            within(kern["u"], plain["u"], 0.0, u_atol)), u_atol


def reference_qn(ref_libs, kq, steps, qkw, batch=None):
    """One solve (``batch`` None) or batched call of the reference
    source's ``qn_solve.cu`` (--reference-kernel) on these inputs,
    through this checkout's ``qn_solve._launch``: its argument list is
    the reference's, and at these sizes its buffers hold the
    reference's (no pads in the dual layout, partial buffers at least
    the reference's per-slot ones).  Returns the wrapper's outputs."""
    import torch
    from rapidnet_tpu_torch.ops import qn_solve as Q
    from rapidnet_tpu_torch.solver import solve_step as ss
    N, ns, nx, nu, _ = Q._dims(kq)
    lay, per = Q.layout(N, ns, nx, nu), Q.partials(N, ns, nx, nu, 1)
    slots = {"norm_part": 2, "val_part": 4, "dot_part": 4, "pp": 2,
             "champ_part": 6}
    if (lay["XP"] != lay["XI"] or lay["D"] != lay["XI"] + lay["PS"] or
            any(per[k] < n * ns for k, n in slots.items())):
        raise SmokeFailure("the reference kernel's buffers do not fit this "
                           "checkout's layout at these sizes")
    strides = (0, 0, 0)
    if batch is not None:
        strides = Q._check_batch_inputs(kq, steps, None)[1]
    with torch.cuda.device(kq["fa"]["d1"].device):
        out = Q._launch(ref_libs["qn_solve"],
                        torch.cuda.current_stream().cuda_stream, kq, steps,
                        None, batch=batch, strides=strides,
                        **dict(qkw, tolerance=None))
    lo, hi = ss.root_control_bounds(kq["fa"])
    out["control"] = torch.clamp(
        out["u"][0, 0] if batch is None else out["u"][:, 0, 0], lo, hi)
    return out


def phase_us(run, n_it):
    """Device µs per iteration of every kernel of one ``run()`` of n_it
    iterations, by base name (template arguments merged: the
    ``..._kernel`` in its name, else its name up to the first ``<`` or
    ``(``, as for a library's kernel), by ``torch.profiler``; None where
    the trace holds no device time."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    us = {}
    for e in prof.key_averages():
        dt = getattr(e, "device_time_total", None)
        if dt is None:
            dt = getattr(e, "cuda_time_total", 0)
        name = re.search(r"\w+_kernel", e.key)
        if name:
            name = name.group()
        elif str(getattr(e, "device_type", "")).endswith("CUDA"):
            name = library_kernel(e.key)
        if dt > 0 and name:
            us[name] = us.get(name, 0.0) + dt / n_it
    return dict(sorted(us.items(), key=lambda kv: -kv[1])) or None


def library_kernel(key):
    """A library kernel's name without its templates, return type and
    parameters (``internal::gemvx::kernel`` for cuBLAS's gemv)."""
    import re
    while True:
        bare = re.sub(r"<[^<>]*>", "", key)
        if bare == key:
            break
        key = bare
    head = key.split("(")[0].strip()
    return head.split()[-1] if "::" in head else head


def apg_variant(tag, dims, B, need):
    """Phases 5 and 8: the variant the source picks for a launch of B at
    ``dims`` on this card (``apg_solve.variant``), printed; it must be
    ``apg_solve.pick``'s for the card's limits and pass ``need``."""
    import torch
    from rapidnet_tpu_torch.ops import apg_solve as K
    props = torch.cuda.get_device_properties(0)
    got = K.variant(*dims, B)
    want = K.pick(*dims, B, sm_count=props.multi_processor_count,
                  smem_limit=props.shared_memory_per_block_optin,
                  smem_per_sm=getattr(props, "shared_memory_per_multiprocessor",
                                      K.H100_SMEM_PER_SM))
    print(f"[variant] {tag}: B {B}: slot clusters of {got['cluster']}, "
          f"prefix clusters of {got['prefix_cluster']}, staged "
          f"{got['staged']} (apg_solve_variant, code {K.encode(got):#x})")
    if got != want:
        raise SmokeFailure(f"{tag}: the source picks {got}, apg_solve.pick "
                           f"{want}")
    if not need(got):
        raise SmokeFailure(f"{tag}: {got} is not the variant the Barcelona "
                           "problem should take")


def in_turns(tag, runs, per_turn, clock=None):
    """Ms of ``runs['reference']`` and ``runs['these']`` in turns
    (reference, these, these, reference; per_turn calls a turn, each
    taken by ``clock(fn)``, the ms of one fn(): by default the wall
    clock, synchronised around it) and each one's per-phase device µs an
    iteration over a PROFILE_ITER-iteration call (``runs[k](n)`` runs n
    iterations); prints both and returns the two medians."""
    import numpy as np
    clock = clock or (lambda fn: timed(fn)[0])
    times = {"reference": [], "these": []}
    for which in ("reference", "these", "these", "reference"):
        for _ in range(per_turn):
            times[which].append(clock(lambda: runs[which](MAX_ITER)))
    med = {k: float(np.median(v)) for k, v in times.items()}
    print(f"[timing] {tag} in turns: these {med['these']:.3f} ms "
          f"({', '.join(f'{t:.3f}' for t in times['these'])}), the "
          f"reference source's {med['reference']:.3f} ms "
          f"({', '.join(f'{t:.3f}' for t in times['reference'])})")
    for which in ("reference", "these"):
        us = phase_us(lambda: runs[which](PROFILE_ITER), PROFILE_ITER)
        shown = ("no device time in the trace" if us is None else
                 ", ".join(f"{k} {v:.3f}" for k, v in us.items()))
        print(f"[phase] {tag} {which}: device us an iteration over "
              f"{PROFILE_ITER} iterations: {shown}")
    return med


def source_runs(ref_libs, name, fn):
    """``in_turns``' runs of n calls of fn(): on the reference source's
    ``name`` kernels (--reference-kernel) and on this checkout's."""
    def these(n):
        for _ in range(n):
            fn()

    def reference(n):
        with reference_kernel(ref_libs, name):
            these(n)
    return {"reference": reference, "these": these}


def qn_solve_bound(kq, step, out, algorithm, prefix_stages):
    """The least time (ms) the card could take for one FBE/NAMA solve, or
    a batch of them, and what sets it.  Operations: the products of the
    tree sweeps (one at the first iteration, two for FBE; three at every
    later one) and of the FBE values' smoothing cost du W' (the one
    before the search and one per line-search trial that ran, as the
    kernel counts them), summed over the instances, over 67 TFLOP/s;
    elementwise work and the L-BFGS dots are left out.  Bytes: the
    inputs read once (each distinct buffer once, a batch-stride-0 view
    once) and the outputs written once, over 3.35 TB/s.  Returns
    (bound_ms, bound_by, flops, bytes, trials)."""
    from rapidnet_tpu_torch.ops import qn_solve as Q
    fa = kq["fa"]
    N, ns, nx = fa["d1"].shape
    nu = fa["g"].shape[-1]
    nv = fa["invWbar"].shape[0]
    per_row = 2 * (nu * nv + nx * nv + nv * nv + nv * nu + nu * nx)
    n_agg = sum(1 for s in prefix_stages if s > 0)
    sweep = N * ns * per_row + 2 * n_agg * ns * ns * (nx + nv)
    value = N * ns * 2 * nu * nu
    its = out["iterations"].reshape(-1).tolist()
    trials = out["line_search_trials"].reshape(-1).tolist()
    first = 2 if algorithm == QN_ALGORITHMS["fbe"] else 1
    flops = sum(first * sweep + (it - 1) * (3 * sweep + value) + tr * value
                for it, tr in zip(its, trials) if it)
    tensors = ([fa[k] for k in Q.ROW_KEYS] + [kq[k] for k in Q.MATRIX_KEYS]
               + [step[k] for k in ("beta", "uhat", "e", "alpha_price",
                                    "x0", "prev_u", "prev_uhat")])
    storages = {}
    for t in tensors:
        st = t.untyped_storage()
        storages[st.data_ptr()] = st.nbytes()
    nbytes = sum(storages.values()) + sum(
        t.numel() * t.element_size() for t in
        (out["x"], out["u"], out["y"]["xi"], out["y"]["psi"],
         out["primal_infeasibility"], out["value_fbe"], out["tau"],
         out["iterations"], out["line_search_trials"], out["control"]))
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes,
            sum(trials))


def wrappers():
    """Each kernel wrapper, by the name its launches are counted under."""
    from rapidnet_tpu_torch.ops import apg_solve as K
    from rapidnet_tpu_torch.ops import apg_stream as S
    from rapidnet_tpu_torch.ops import apg_stream_sharded as SS
    from rapidnet_tpu_torch.ops import lbfgs as LB
    from rapidnet_tpu_torch.ops import qn_solve as Q
    from rapidnet_tpu_torch.ops import stream_qn as SQ
    return {"apg_solve": K.apg_solve, "apg_solve_batch": K.apg_solve_batch,
            "qn_solve": Q.qn_solve, "qn_solve_batch": Q.qn_solve_batch,
            "apg_stream": S.apg_stream, "apg_stream.k1": S.k1_call,
            "apg_stream.k2": S.k2_call,
            "apg_stream_fused": S.apg_stream_fused,
            "apg_stream.fused": S.fused_call, "stream_qn.s1": SQ.s1_call,
            "stream_qn.s2": SQ.s2_call, "lbfgs.dots": LB.dots,
            "lbfgs.combine": LB.combine,
            "apg_stream_sharded.k1a": SS.k1a_call,
            "apg_stream_sharded.k2": SS.k2_local,
            "stream_sharded.partial_parents": SS.partial_parents,
            "stream_qn.s1a": SQ.s1a_call}


def zero_counts():
    """Every kernel wrapper's launch count set to 0."""
    for fn in wrappers().values():
        fn.launches = 0


def count_launches(tag, name, expected):
    """The launches counted since ``zero_counts()``: wrapper ``name``'s
    must be ``expected`` and every other wrapper's none.  Returns
    ``name``'s count."""
    counts = {k: fn.launches for k, fn in wrappers().items()}
    n = counts.pop(name)
    if n != expected or any(counts.values()):
        raise SmokeFailure(f"{tag}: {n} {name} launches for {expected} "
                           f"solves; the other kernels' {counts}")
    return n


def forecaster(net):
    """The Barcelona-scale problem's forecaster, new."""
    from rapidnet_tpu_torch.model.forecaster import synthetic_forecaster
    return synthetic_forecaster(N=24, nd=net.nd, nu=net.nu, sim_horizon=4,
                                seed=42)


def perturbed(x0, rng, n=BATCH):
    """n states x0 * (1 + 0.02 N(0, 1)) (bench.py:133-136)."""
    import numpy as np
    return (x0 * (1.0 + 0.02 * rng.standard_normal((n, x0.size)))
            ).astype(np.float32)


def timed(fn):
    """fn() with the device synchronised before and after: (wall ms, the
    host's enqueue ms, fn's result)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, (t1 - t0) * 1e3, res


def batched_loops(tag, cfg, net, tree, x0s, runs, name):
    """Phases 7 and 13: 3-step ``BatchedSmpcController(device="cuda")``
    loops from states ``x0s``, one for each (label, forecaster or one per
    instance, warm start) of ``runs``, every launch count zeroed just
    before each.  Each step calls the batched kernel ``name`` once and no
    other kernel, and controls and KPIs are finite.  Returns the logs by
    label, the batched calls of all the loops, and the controls of a
    single-instance ``SmpcController(device="cuda")`` from x0s[0]."""
    import numpy as np
    from rapidnet_tpu_torch.solver.batch import BatchedSmpcController
    from rapidnet_tpu_torch.solver.controller import SmpcController

    logs, calls = {}, 0
    for label, fcs, warm in runs:
        ctrl = BatchedSmpcController(copy.deepcopy(cfg), net, tree, fcs, x0s,
                                     warm_start=warm, device="cuda")
        ctrl.initialise()
        zero_counts()
        t0 = time.perf_counter()
        log = ctrl.closed_loop(BATCH_LOOP_STEPS)
        loop_ms = (time.perf_counter() - t0) * 1e3 / BATCH_LOOP_STEPS
        calls += count_launches(f"{tag}.{label}", name, BATCH_LOOP_STEPS)
        print(f"[batched_loop] {tag}.{label}: {BATCH_LOOP_STEPS} steps of B "
              f"{BATCH}, one {name} call each and no other kernel; solve ms "
              f"per step "
              f"{', '.join(f'{m:.3f}' for m in log['solve_times_ms'])}; "
              f"whole step {loop_ms:.3f} ms")
        kpis = {k: log[k] for k in KPI_KEYS}
        if not (np.isfinite(log["controls"]).all() and
                all(np.isfinite(v).all() for v in kpis.values())):
            raise SmokeFailure(f"{tag}.{label}: non-finite controls or KPIs")
        print(f"[batched_loop] {tag}.{label} kpis of instance 0: " +
              json.dumps({k: float(v[0]) for k, v in kpis.items()}))
        logs[label] = log
    c0 = copy.deepcopy(cfg)
    c0.set_current_state(x0s[0])
    slog = SmpcController(c0, network=net, tree=tree,
                          forecaster=forecaster(net), backend="cuda",
                          device="cuda").closed_loop(BATCH_LOOP_STEPS)
    single = np.array([slog[f"control{t}"] for t in range(BATCH_LOOP_STEPS)],
                      np.float32)
    return logs, calls, single


def batch_timing(tag, run, make_steps):
    """Phases 8 and 14: the median wall ms of BATCH_REPEATS batched
    solves ``run(steps)``, each on inputs ``make_steps()`` staged on the
    device before it, and the peak device memory of one more call above
    what was held before it.  Returns (median ms, the last steps, their
    outputs)."""
    import numpy as np
    import torch
    times, enqueue = [], []
    for _ in range(BATCH_REPEATS):
        steps = make_steps()
        ms, enq, out = timed(lambda: run(steps))
        times.append(ms)
        enqueue.append(enq)
        if not bool(torch.isfinite(out["control"]).all()):
            raise SmokeFailure(f"{tag}: non-finite batched control")
    med = float(np.median(times))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    run(steps)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"[timing] {tag} batched kernel, B {BATCH}, {MAX_ITER} "
          f"iterations: median {med:.3f} ms of {BATCH_REPEATS} ("
          f"{', '.join(f'{t:.3f}' for t in times)}): "
          f"{BATCH * 1e3 / med:.3f} solves/s; host enqueue "
          f"{', '.join(f'{t:.3f}' for t in enqueue)} ms")
    print(f"[memory] {tag} batched solve: peak {peak / 2**20:.3f} MiB "
          f"allocated, {(peak - held) / 2**20:.3f} MiB above the "
          f"{held / 2**20:.3f} MiB held before it")
    return med, steps, out


def qn_phases(ref_libs, cfg, net, tree, fa, make_step, hyper, prefix,
              apg_kpis):
    """Phases 9a-11 for FBE and NAMA; returns their JSON entries and, per
    algorithm, 9c's tolerance (the batch's phase 12c reuses it).
    ``ref_libs``: the reference sources' libraries, or None."""
    import numpy as np
    import torch
    from rapidnet_tpu_torch.ops import qn_solve as Q
    from rapidnet_tpu_torch.solver import quasi_newton as qn_mod
    from rapidnet_tpu_torch.solver.controller import SmpcController

    kq = Q.kernel_constants(fa, prefix_stages=prefix)
    bs = int(cfg.lbfgs_buffer_size)
    track_min = bs + QN_TRACK_SPARE
    step = make_step(cfg.current_x)
    lo, hi = fa["umin_phys"], fa["umax_phys"]
    entries, tols = [], {}
    for short, algorithm in QN_ALGORITHMS.items():
        qkw = dict(hyper, algorithm=algorithm, lbfgs_buffer_size=bs)

        def kern(n=MAX_ITER, step=step, **kw):
            return Q.qn_solve(kq, step, None, **dict(qkw, max_iterations=n,
                                                     **kw))

        def plain(n=MAX_ITER, step=step, **kw):
            return Q.qn_solve_plain(kq, step, None,
                                    **dict(qkw, max_iterations=n, **kw))

        # 9a. short-horizon parity.  TRACK: the most leading iterations
        # over which the traces agree and after which control and u do
        k_s, p_s = kern(QN_TRACK_MAX), plain(QN_TRACK_MAX)
        traced = qn_horizon(k_s, p_s, QN_TRACK_MAX)
        shown = min(traced + 2, QN_TRACK_MAX)     # to where they part
        for key in QN_TRACES:
            for name, out in (("kernel", k_s), ("plain ", p_s)):
                vals = np.array2string(out[key][:shown].cpu().numpy(),
                                       precision=7, max_line_width=400)
                print(f"[qn] 9a.{short}.{key:20s} {name} {vals}")
        track = traced
        while track >= track_min:
            k_t, p_t = kern(track), plain(track)
            agree, u_atol = solutions_agree(k_t, p_t)
            if agree:
                break
            track -= 1
        print(f"[qn] 9a.{short}: TRACK {track} (the traces agree within the "
              f"JAX bounds over the first {traced} of {QN_TRACK_MAX} "
              f"iterations, control and u after the first {track})")
        if track < track_min:
            raise SmokeFailure(f"{short}: the kernel tracks the plain "
                               f"version over {track} iterations, fewer "
                               f"than {track_min}")
        trials = (int(k_t["line_search_trials"]),
                  int(p_t["line_search_trials"]))
        skips = (int(k_t["lbfgs_skips"]), int(p_t["lbfgs_skips"]))
        print(f"[qn] 9a.{short}: over the first {track} iterations, "
              f"line-search trials: kernel {trials[0]}, plain {trials[1]}; "
              f"rejected curvature pairs: kernel {skips[0]}, plain "
              f"{skips[1]}")
        if trials[0] != trials[1] or skips[0] != skips[1]:
            raise SmokeFailure(f"{short}: the kernel's counts of trials and "
                               f"rejected pairs differ from the plain "
                               f"version's")
        if not track - 1 - skips[1] > bs:
            raise SmokeFailure(f"{short}: the L-BFGS ring did not wrap "
                               f"within the {track} iterations held")
        check_allclose(f"9a.{short}.control", k_t["control"],
                       p_t["control"], 1e-3, 1e-4)
        err_u = check_allclose(f"9a.{short}.u", k_t["u"], p_t["u"], 0.0,
                               u_atol)
        print(f"[qn] 9a.{short}.u within the synthetic problem's bound "
              f"(rtol 1e-3, atol 1e-3): "
              f"{within(k_t['u'], p_t['u'], 1e-3, 1e-3)}")

        # 9b. 500 iterations: quality, bounds, determinism
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_full = qn_mod.make_solver(prefix_stages=prefix,
                                    trace_magnitude=True, **qkw)(fa, step)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        k_full, again = kern(), kern()
        same = all(torch.equal(again[k], k_full[k]) for k in
                   ("x", "u", "iterations", "line_search_trials",
                    "lbfgs_skips") +
                   QN_TRACES) and all(
            torch.equal(again["y"][k], k_full["y"][k]) for k in ("xi", "psi"))
        tail_k = float(np.median(
            k_full["primal_infeasibility"].abs().cpu().numpy()[-20:]))
        tail_p = float(np.median(
            p_full["primal_infeasibility"].abs().cpu().numpy()[-20:]))
        u0 = k_full["control"]
        inside = bool(((u0 >= lo - 1e-5) & (u0 <= hi + 1e-5)).all())
        print(f"[qn] 9b.{short}: {MAX_ITER} iterations, median "
              f"|infeasibility| of the last 20: kernel {tail_k:.6g}, plain "
              f"{tail_p:.6g}; control within the physical bounds: {inside};"
              f" two calls equal bit for bit: {same}; plain solve "
              f"{plain_ms:.3f} ms")
        if not (int(k_full["iterations"]) == MAX_ITER and
                bool(torch.isfinite(k_full["u"]).all())):
            raise SmokeFailure(f"{short}: the 500-iteration solve failed")
        if not tail_k < 10 * max(tail_p, 1e-6):
            raise SmokeFailure(f"{short}: residual tail {tail_k:.6g} above "
                               f"10 x the plain version's {tail_p:.6g}")
        if not inside:
            raise SmokeFailure(f"{short}: control outside the bounds")
        if not same:
            raise SmokeFailure(f"{short}: the kernel does not repeat itself")
        # where a tolerance could stop a solve from this state (recorded,
        # not gated: past TRACK the two solves part)
        mags = p_full["residual_magnitude"].cpu().numpy()
        below = np.flatnonzero(mags[1:] < mags[0])
        print(f"[qn] 9b.{short}: residual magnitude of the first 3 "
              f"iterations {np.array2string(mags[:3], precision=6)}; "
              f"first below the first at iteration "
              f"{int(below[0]) + 2 if below.size else None}")
        nominal = qn_mod.exit_tolerances(mags, MAX_ITER - 1)
        if nominal:
            tol_n, it_n, _ = nominal[0]
            it_kn = int(kern(tolerance=tol_n)["iterations"])
            print(f"[qn] 9b.{short}: tol {tol_n:.6g} stops the plain version"
                  f" at {it_n}, the kernel at {it_kn}")

        # 9c. the tolerance exit.  The residual magnitude of these solves
        # rises after the first iteration and, from the nominal state,
        # first falls below its first value where the two float32 solves
        # have parted (9b prints where); from nearly empty tanks it falls
        # within the iterations over which they track
        step_low = make_step((LOW_FILL * net.xmax).astype(np.float32))
        k_low = kern(QN_TRACK_MAX, step=step_low)
        p_low = qn_mod.make_solver(
            prefix_stages=prefix, trace_magnitude=True,
            **dict(qkw, max_iterations=QN_TRACK_MAX))(fa, step_low)
        traced_low = qn_horizon(k_low, p_low, QN_TRACK_MAX)
        # the widest-ranged exit within the traces' horizon after which
        # control and u agree too (as 9a's TRACK)
        for tol, it_want, ratio in qn_mod.exit_tolerances(
                p_low["residual_magnitude"].cpu().numpy(), traced_low):
            if solutions_agree(kern(it_want, step=step_low),
                               plain(it_want, step=step_low))[0]:
                break
        else:
            raise SmokeFailure(f"{short}: no tolerance stops the plain "
                               f"version within {traced_low} iterations "
                               "where the solutions agree")
        p_tol = plain(step=step_low, tolerance=tol)
        k_tol = kern(step=step_low, tolerance=tol)
        it_p, it_k = int(p_tol["iterations"]), int(k_tol["iterations"])
        print(f"[qn] 9c.{short}: tanks at {LOW_FILL:g} of their maximum: "
              f"traces agree over {traced_low}; tol {tol:.6g} (exit "
              f"{it_want}, its "
              f"range of tolerances spans a factor {ratio:.4g}): plain "
              f"stops at {it_p}, kernel at {it_k} of {MAX_ITER}")
        if not it_p == it_k == it_want:
            raise SmokeFailure(f"{short}: tolerance exits differ")
        check_allclose(f"9c.{short}.control", k_tol["control"],
                       p_tol["control"], 1e-3, 1e-4)
        for key in QN_TRACES:
            if bool((k_tol[key][it_k:] != 0).any()):
                raise SmokeFailure(f"{short}: {key} not zero past the exit")

        # 10. the closed loops (the main path), cold and warm-started
        loop_launches = 0
        for warm in (False, True):
            c = copy.deepcopy(cfg)
            c.algorithm = algorithm
            ctrl = SmpcController(c, network=net, tree=tree,
                                  forecaster=forecaster(net), backend="cuda",
                                  device="cuda", warm_start=warm)
            ctrl.initialise()
            zero_counts()
            t0 = time.perf_counter()
            log = ctrl.closed_loop(QN_LOOP_STEPS)
            loop_ms = (time.perf_counter() - t0) * 1e3 / QN_LOOP_STEPS
            label = "warm" if warm else "cold"
            n = count_launches(f"10.{short}.{label}", "qn_solve",
                               QN_LOOP_STEPS)
            ms = [log[f"time{t}"][0] for t in range(QN_LOOP_STEPS)]
            print(f"[qn] 10.{short}.{label}: {QN_LOOP_STEPS} steps, kernel "
                  f"launches {n}, solve ms per step "
                  f"{', '.join(f'{m:.3f}' for m in ms)}; whole step "
                  f"{loop_ms:.3f} ms")
            loop_launches += n
            kpis = {k: log[k] for k in KPI_KEYS}
            controls = np.array([log[f"control{t}"]
                                 for t in range(QN_LOOP_STEPS)])
            if not (np.isfinite(controls).all() and
                    np.isfinite(list(kpis.values())).all()):
                raise SmokeFailure(f"{short}: non-finite controls or KPIs")
            if "memoryLeakWarning" in log:
                raise SmokeFailure(log["memoryLeakWarning"])
            print(f"[qn] 10.{short}.{label} kpis {json.dumps(kpis)}")
            rel = {k: (v - apg_kpis[k]) / max(abs(apg_kpis[k]), 1e-30)
                   for k, v in kpis.items()}
            print(f"[qn] 10.{short}.{label} kpis relative to the APG loop "
                  f"of phase 4 {json.dumps(rel)}")

        # 11. timing, inputs staged on the device
        staged = [make_step(x) for x in perturbed(
            cfg.current_x, np.random.default_rng(7), REPEATS)]
        times, enqueue = [], []
        for st in staged:
            ms, enq, out = timed(lambda: kern(step=st))
            times.append(ms)
            enqueue.append(enq)
            if not bool(torch.isfinite(out["control"]).all()):
                raise SmokeFailure(f"{short}: non-finite control")
        med = float(np.median(times))
        per_it = Q.launches_per_iteration(algorithm, bs, kq["fp"])
        bound = qn_solve_bound(kq, step, k_full, algorithm, prefix)
        print(f"[timing] {short} kernel {MAX_ITER}-iteration solve: median "
              f"{med:.3f} ms of {REPEATS} "
              f"({', '.join(f'{t:.3f}' for t in times)}); host enqueue "
              f"{', '.join(f'{t:.3f}' for t in enqueue)} ms; "
              f"{per_it} launches per iteration after the first; plain "
              f"{plain_ms:.3f} ms")
        print(f"[bound] {short}: {bound[2] / 1e9:.3f} GFLOP, "
              f"{bound[3] / 1e6:.3f} MB: {bound[0]:.6f} ms, set by "
              f"{bound[1]}; {bound[4]} line-search trials in "
              f"{MAX_ITER - 1} searches (the kernel's count)")
        ref_ms = None
        if ref_libs:
            ref_ms = in_turns(f"11.{short} single solve", {
                "reference": lambda n: reference_qn(
                    ref_libs, kq, staged[0], dict(qkw, max_iterations=n)),
                "these": lambda n: kern(n, step=staged[0])},
                QN_AB_SOLVES)["reference"]
        entries.append(
            {"name": f"qn_solve_{short}", "route": "cuda",
             "source": "rapidnet_tpu_torch/csrc/qn_solve.cu",
             "replaces": "rapidnet_tpu/ops/pallas_qn.py:94",
             "launches": loop_launches, "max_abs_err": err_u, "ms": med,
             "plain_ms": plain_ms, "bound_ms": bound[0],
             "bound_by": bound[1], "library_ms": None,
             "reference_ms": ref_ms})
        tols[short] = tol
    return entries, tols


def reference_track(short, kq, step, single, qkw, ref_libs, kern_1,
                    track_min):
    """Phase 12a with --reference-kernel: the single solve of ``step``
    against the reference source's by 9a's rules (TRACK at least
    ``track_min``, equal counts of trials and rejected pairs over it, the
    ring wrapped) and, at MAX_ITER iterations (``single``), 9b's tail
    rule; the largest control difference printed."""
    import numpy as np

    def ref(n):
        return reference_qn(ref_libs, kq, step, dict(qkw, max_iterations=n))

    k_s, r_s = kern_1(step, QN_TRACK_MAX), ref(QN_TRACK_MAX)
    traced = qn_horizon(k_s, r_s, QN_TRACK_MAX)
    track = traced
    while track >= track_min:
        k_t, r_t = kern_1(step, track), ref(track)
        if solutions_agree(k_t, r_t)[0]:
            break
        track -= 1
    counts = {k: (int(k_t[k]), int(r_t[k]))
              for k in ("line_search_trials", "lbfgs_skips")}
    r_full = ref(MAX_ITER)
    tails = [float(np.median(o["primal_infeasibility"].abs().cpu()
                             .numpy()[-20:])) for o in (single, r_full)]
    gap = float((single["control"] - r_full["control"]).abs().max())
    print(f"[qn_batch] 12a.{short}: the single solve against the "
          f"reference kernel (qn_solve.cu of --reference-kernel): TRACK "
          f"{track} (traces over {traced} of {QN_TRACK_MAX}); over it "
          f"trials {counts['line_search_trials']}, rejected pairs "
          f"{counts['lbfgs_skips']} (these, reference); at {MAX_ITER} "
          f"iterations median |infeasibility| of the last 20: these "
          f"{tails[0]:.6g}, reference {tails[1]:.6g}; largest control "
          f"difference {gap:.6g}; bit for bit: "
          f"{outputs_equal(single, r_full, ('x', 'u') + QN_TRACES + QN_INT_KEYS)}")
    if track < track_min:
        raise SmokeFailure(f"{short}: the single solve tracks the "
                           f"reference kernel over {track} iterations, "
                           f"fewer than {track_min}")
    if any(a != b for a, b in counts.values()):
        raise SmokeFailure(f"{short}: the counts of trials and rejected "
                           f"pairs differ from the reference kernel's")
    if not track - 1 - counts["lbfgs_skips"][1] > int(qkw["lbfgs_buffer_size"]):
        raise SmokeFailure(f"{short}: the L-BFGS ring did not wrap within "
                           f"the {track} iterations held")
    if not tails[0] < 10 * max(tails[1], 1e-6):
        raise SmokeFailure(f"{short}: residual tail {tails[0]:.6g} above "
                           f"10 x the reference kernel's {tails[1]:.6g}")


def outputs_equal(got, ref, keys):
    """Whether two solves' outputs ``keys`` and dual y are equal bit for
    bit."""
    import torch
    return all(torch.equal(got[k], ref[k]) for k in keys) and all(
        torch.equal(got["y"][k], ref["y"][k]) for k in ("xi", "psi"))


def qn_batch_phases(ref_libs, cfg, net, tree, fa, make_batch, hyper, prefix,
                    tols):
    """Phases 12a-14, the batched FBE/NAMA kernel at B = 32; ``tols``:
    9c's tolerance per algorithm.  Returns their JSON entries."""
    import numpy as np
    import torch
    from rapidnet_tpu_torch.ops import qn_solve as Q

    kq = Q.kernel_constants(fa, prefix_stages=prefix)
    bs = int(cfg.lbfgs_buffer_size)
    track_min = bs + QN_TRACK_SPARE
    P = PLAIN_INSTANCES
    x0 = cfg.current_x
    rng = np.random.default_rng(7)
    x0s = perturbed(x0, rng)
    steps_sh = make_batch(x0s)
    steps_st = make_batch(x0s, shared=False)
    steps_low = make_batch(perturbed((LOW_FILL * net.xmax).astype(np.float32),
                                     np.random.default_rng(7)))

    entries = []
    for short, algorithm in QN_ALGORITHMS.items():
        qkw = dict(hyper, algorithm=algorithm, lbfgs_buffer_size=bs)

        def kern_b(steps, n=MAX_ITER, **kw):
            return Q.qn_solve_batch(kq, steps, None,
                                    **dict(qkw, max_iterations=n, **kw))

        def kern_1(step, n=MAX_ITER, **kw):
            return Q.qn_solve(kq, step, None,
                              **dict(qkw, max_iterations=n, **kw))

        def plain_b(steps, n=MAX_ITER, **kw):
            """The plain batch on instances 0 .. P-1."""
            return Q.qn_solve_batch_plain(
                kq, {k: v[:P] for k, v in steps.items()}, None,
                **dict(qkw, max_iterations=n, **kw))

        # 12a. every instance against the single-solve kernel, bit for bit
        for form, steps in (("shared", steps_sh), ("stacked", steps_st)):
            kb = kern_b(steps)
            singles = [kern_1(instance(steps, b)) for b in range(BATCH)]
            err, equal = compare_instances(f"12a.{short}.{form}", kb,
                                           singles, QN_KEYS, QN_INT_KEYS)
            print(f"[qn_batch] 12a.{short}.{form}: all {BATCH} instances "
                  f"equal to the single-solve kernel bit for bit: {equal} "
                  f"(largest difference {err:.6g}); iterations "
                  f"{sorted(set(kb['iterations'].tolist()))}, line-search "
                  f"trials {kb['line_search_trials'].tolist()}")
            if not equal:
                raise SmokeFailure(f"{short}.{form}: a batched instance "
                                   "differs from its single solve")
            del singles
        one = {k: v[:1] for k, v in steps_sh.items()}
        b1, s1 = kern_b(one), kern_1(instance(steps_sh, 0))
        _, eq1 = compare_instances(f"12a.{short}.B=1", b1, [s1], QN_KEYS,
                                   QN_INT_KEYS)
        print(f"[qn_batch] 12a.{short}: B = 1 equals the single solve bit "
              f"for bit: {eq1}")
        if not eq1:
            raise SmokeFailure(f"{short}: B = 1 differs from the single "
                               "solve")
        if ref_libs:
            reference_track(short, kq, instance(steps_sh, 0), s1, qkw,
                            ref_libs, kern_1, track_min)

        # 12b. instances 0 .. P-1 against the plain batch, 9a's rules
        k_s, p_s = kern_b(steps_sh, QN_TRACK_MAX), plain_b(steps_sh,
                                                           QN_TRACK_MAX)
        traced = min(qn_horizon(instance(k_s, b), instance(p_s, b),
                                QN_TRACK_MAX) for b in range(P))
        track = traced
        while track >= track_min:
            k_t, p_t = kern_b(steps_sh, track), plain_b(steps_sh, track)
            agree = [solutions_agree(instance(k_t, b), instance(p_t, b))
                     for b in range(P)]
            if all(a for a, _ in agree):
                break
            track -= 1
        print(f"[qn_batch] 12b.{short}: TRACK {track} (instances 0-{P - 1}: "
              f"the traces agree within the JAX bounds over the first "
              f"{traced} of {QN_TRACK_MAX} iterations, control and u after "
              f"the first {track})")
        if track < track_min:
            raise SmokeFailure(f"{short}: the batched kernel tracks the "
                               f"plain batch over {track} iterations, fewer "
                               f"than {track_min}")
        counts = {k: (k_t[k][:P].tolist(), p_t[k].tolist())
                  for k in ("line_search_trials", "lbfgs_skips")}
        print(f"[qn_batch] 12b.{short}: over the first {track} iterations, "
              f"line-search trials: kernel {counts['line_search_trials'][0]}"
              f", plain {counts['line_search_trials'][1]}; rejected pairs: "
              f"kernel {counts['lbfgs_skips'][0]}, plain "
              f"{counts['lbfgs_skips'][1]}")
        if any(kc_ != pc for kc_, pc in counts.values()):
            raise SmokeFailure(f"{short}: the batched kernel's counts of "
                               "trials and rejected pairs differ from the "
                               "plain batch's")
        if not all(track - 1 - sk > bs for sk in counts["lbfgs_skips"][1]):
            raise SmokeFailure(f"{short}: the L-BFGS ring did not wrap "
                               f"within the {track} iterations held")
        err_u = 0.0
        for b, (_, u_atol) in enumerate(agree):
            kb_i, pb_i = instance(k_t, b), instance(p_t, b)
            check_allclose(f"12b.{short}.control[{b}]", kb_i["control"],
                           pb_i["control"], 1e-3, 1e-4)
            err_u = max(err_u, check_allclose(f"12b.{short}.u[{b}]",
                                              kb_i["u"], pb_i["u"], 0.0,
                                              u_atol))

        # 12c. tolerance exits from nearly empty tanks, 9c's tolerance
        tol = tols[short]
        kt = kern_b(steps_low, tolerance=tol)
        its_k = kt["iterations"].tolist()
        its_1 = [int(kern_1(instance(steps_low, b), tolerance=tol)
                     ["iterations"]) for b in range(BATCH)]
        its_p = plain_b(steps_low, tolerance=tol)["iterations"].tolist()
        print(f"[qn_batch] 12c.{short}: tanks at {LOW_FILL:g} of their "
              f"maximum, tol {tol:.6g}: batched kernel exits {its_k}; "
              f"single kernel {'the same' if its_1 == its_k else its_1}; "
              f"plain version (instances 0-{P - 1}) {its_p}")
        if its_k != its_1 or its_k[:P] != its_p:
            raise SmokeFailure(f"{short}: batched tolerance exits differ")
        for b, it in enumerate(its_k):
            for key in QN_TRACES:
                if bool((kt[key][b, it:] != 0).any()):
                    raise SmokeFailure(f"{short}: instance {b}'s {key} not "
                                       "zero past its exit")

        # 13. batched closed loops (the main path): shared forecast cold
        # and warm, and stacked (one forecaster per instance)
        c = copy.deepcopy(cfg)
        c.algorithm = algorithm
        logs, loop_launches, single = batched_loops(
            f"13.{short}", c, net, tree, x0s,
            (("shared.cold", forecaster(net), False),
             ("shared.warm", forecaster(net), True),
             ("stacked.cold", [forecaster(net) for _ in range(BATCH)],
              False)), "qn_solve_batch")
        gaps = {label: float(np.abs(logs[label]["controls"][:, 0] -
                                    single).max())
                for label in ("stacked.cold", "shared.cold")}
        same = np.array_equal(logs["stacked.cold"]["controls"][:, 0], single)
        print(f"[qn_batch] 13.{short}: instance 0 against a single-instance "
              f"SmpcController from its state: stacked equal bit for bit: "
              f"{same} (gap {gaps['stacked.cold']:.6g}); shared gap "
              f"{gaps['shared.cold']:.6g} (recorded, not gated)")
        if not same:
            raise SmokeFailure(f"{short}: the stacked batch's instance 0 "
                               "differs from the single closed loop")

        # 14. timing, inputs staged on the device; the plain batch on the
        # first P instances of the last call over QN_TRACK_MAX iterations
        # (all 32 at 500 would take many minutes; 4 at 500, ~45 s)
        med, steps_r, out = batch_timing(
            short, kern_b, lambda: make_batch(perturbed(x0, rng)))
        per_it = Q.launches_per_iteration(algorithm, bs, kq["fp"])
        plain_ms = timed(lambda: plain_b(steps_r, QN_TRACK_MAX))[0]
        print(f"[timing] {short}: {per_it} launches per iteration after the "
              f"first, whatever B; plain batch of instances 0-{P - 1}, "
              f"{QN_TRACK_MAX} iterations: {plain_ms:.3f} ms "
              f"({plain_ms / P:.3f} ms per instance)")
        ref_ms = None
        if ref_libs:
            ref_ms = in_turns(f"14.{short} B = {BATCH}", {
                "reference": lambda n: reference_qn(
                    ref_libs, kq, steps_r, dict(qkw, max_iterations=n),
                    batch=BATCH),
                "these": lambda n: kern_b(steps_r, n)},
                QN_AB_CALLS)["reference"]
        bound = qn_solve_bound(kq, steps_r, out, algorithm, prefix)
        print(f"[bound] {short} batched: {bound[2] / 1e9:.3f} GFLOP, "
              f"{bound[3] / 1e6:.3f} MB: {bound[0]:.6f} ms, set by "
              f"{bound[1]}; {bound[4]} line-search trials in {BATCH} x "
              f"{MAX_ITER - 1} searches (the kernel's count)")
        entries.append(
            {"name": f"qn_solve_batch_{short}", "route": "cuda",
             "source": "rapidnet_tpu_torch/csrc/qn_solve.cu",
             "replaces": "rapidnet_tpu/ops/pallas_qn.py:686",
             "launches": loop_launches, "max_abs_err": err_u, "ms": med,
             "plain_ms": plain_ms, "plain_instances": P,
             "plain_iterations": QN_TRACK_MAX,
             "bound_ms": bound[0], "bound_by": bound[1],
             "library_ms": None, "reference_ms": ref_ms})
    return entries


def solve_inputs(kc, step):
    """Every tensor a solve reads: the constants and the step."""
    from rapidnet_tpu_torch.ops import apg_solve as K
    return ([kc["fa"][k] for k in K.ROW_KEYS] +
            [kc[k] for k in K.MATRIX_KEYS] +
            [step[k] for k in ("beta", "uhat", "e", "x0", "prev_u",
                               "prev_uhat")])


def as_f64(d):
    """A copy of a dict of tensors (nested dicts too) in float64."""
    return {k: as_f64(v) if isinstance(v, dict) else v.double()
            for k, v in d.items()}


def build_problem(device, branching=BARCELONA_BRANCHING):
    """The port's copy of bench.py:42-65 (Barcelona-scale synthetic);
    with ``branching=CONFIG5_BRANCHING`` the same network and horizon
    over BASELINE config 5's tree (bench_ladder.py:47)."""
    import numpy as np
    from rapidnet_tpu_torch.convert import (factor_arrays, factor_tensors,
                                            shared_step_tensors,
                                            stacked_step_tensors, step_arrays,
                                            step_tensors)
    from rapidnet_tpu_torch.model.config import synthetic_config
    from rapidnet_tpu_torch.model.forecaster import synthetic_forecaster
    from rapidnet_tpu_torch.model.network import synthetic_network
    from rapidnet_tpu_torch.model.scenario_tree import generate_tree
    from rapidnet_tpu_torch.solver.apg import expand_shared_step
    from rapidnet_tpu_torch.solver.tuning import auto_tune

    nx, nu, nd, ne = 63, 114, 88, 17
    net = synthetic_network(nx=nx, nu=nu, nd=nd, ne=ne, seed=42)
    tree = generate_tree(N=24, branching=list(branching), nd=nd, nu=nu,
                         seed=42)
    fc = synthetic_forecaster(N=24, nd=nd, nu=nu, sim_horizon=4, seed=42)
    cfg0 = synthetic_config(net, tree, max_iterations=MAX_ITER)
    cfg, eng = auto_tune(net, tree, cfg0, device=device)
    fc.predict_demand(0)
    fc.predict_prices(0)
    fa = factor_tensors(factor_arrays(eng), device)

    def make_step(x0):
        return step_tensors(step_arrays(eng.prepare_step(
            fc.nominal_demand, fc.nominal_prices, x0, cfg.prev_u,
            cfg.prev_demand)), device)

    def make_batch(x0s, shared=True):
        """B instances from states x0s: assembled on the device from the
        shared base (uhat and e with batch stride 0), or stacked from B
        single steps."""
        B = len(x0s)
        if not shared:
            return stacked_step_tensors([step_arrays(eng.prepare_step(
                fc.nominal_demand, fc.nominal_prices, x0, cfg.prev_u,
                cfg.prev_demand)) for x0 in x0s], device)
        base, inst = shared_step_tensors(*eng.prepare_step_shared(
            fc.nominal_demand, fc.nominal_prices, x0s,
            np.tile(cfg.prev_u, (B, 1)), np.tile(cfg.prev_demand, (B, 1))),
            device)
        return expand_shared_step(base, **inst)

    return cfg, eng, net, tree, fa, make_step, make_batch


def apg_phases(ref_libs, device, cfg, net, tree, fa, make_step, make_batch,
               prefix, hyper, kc):
    """Phases 3-8, the APG kernel single and batched; returns their JSON
    entries and the KPIs of phase 4's closed loop.  ``ref_libs``: the
    kernels of an earlier checkout's sources, or None."""
    import numpy as np
    import torch
    from rapidnet_tpu_torch.ops import apg_solve as K
    from rapidnet_tpu_torch.solver.controller import SmpcController

    # 3. kernel against its plain version on one step's solve.  Then a
    # state above the tank bounds, which makes the state-box and safety
    # penalties active, over STRESS_ITER iterations: past ~100 such
    # iterations float32 rounding compounds past the direct bound, so
    # the full budget there is held to a float64 witness instead.
    errs = {}
    x_hot = (1.2 * net.xmax).astype(np.float32)
    for label, x0, n_it in (("", cfg.current_x, MAX_ITER),
                            ("stressed.", x_hot, STRESS_ITER)):
        step = make_step(x0)
        kc_n = K.kernel_constants(fa, prefix_stages=prefix,
                                  max_iterations=n_it)
        hyper_n = dict(hyper, max_iterations=n_it)
        plain = K.apg_solve_plain(kc_n, step, None, **hyper_n)
        kern = K.apg_solve(kc_n, step, None, **hyper_n)
        for k in ("control", "u", "x", "primal_infeasibility"):
            errs[label + k] = check_close(label + k, kern[k], plain[k])
        for k in ("xi", "psi"):
            check_close(f"{label}y.{k}", kern["y"][k], plain["y"][k])
        if int(kern["iterations"]) != n_it:
            raise SmokeFailure(f"kernel ran {int(kern['iterations'])} "
                               f"iterations, expected {n_it}")
    step_hot = make_step(x_hot)
    plain = K.apg_solve_plain(kc, step_hot, None, **hyper)
    kern = K.apg_solve(kc, step_hot, None, **hyper)
    wit = K.apg_solve_plain(dict(kc, fa=as_f64(fa)), as_f64(step_hot),
                            None, **hyper)
    for k in ("control", "u", "x"):
        witness_check(f"stressed500.{k}", kern[k], plain[k], wit[k])
    for k in ("xi", "psi"):
        witness_check(f"stressed500.y.{k}", kern["y"][k], plain["y"][k],
                      wit["y"][k])
    step = make_step(cfg.current_x)

    # a tolerance the solve crosses mid-budget, found on the plain side
    tol = None
    for cand in (1e4, 3e3, 1e3, 3e2, 1e2, 30.0, 10.0, 3.0, 1.0, 0.3, 0.1):
        p_tol = K.apg_solve_plain(kc, step, None, tolerance=cand, **hyper)
        if 1 < int(p_tol["iterations"]) < MAX_ITER:
            tol = cand
            break
    if tol is None:
        raise SmokeFailure("no tolerance gave a mid-budget exit")
    k_tol = K.apg_solve(kc, step, None, tolerance=tol, **hyper)
    it_p, it_k = int(p_tol["iterations"]), int(k_tol["iterations"])
    print(f"[tolerance] tol {tol:g}: plain stops at {it_p}, kernel at {it_k}")
    if it_p != it_k:
        raise SmokeFailure("tolerance exits differ")
    check_close("tol.control", k_tol["control"], p_tol["control"])
    if bool((k_tol["primal_infeasibility"][it_k:] != 0).any()):
        raise SmokeFailure("trace not zero past the exit")

    # 4. the closed loop through the controller (the main path)
    def controller(backend):
        ctrl = SmpcController(copy.deepcopy(cfg), network=net, tree=tree,
                              forecaster=forecaster(net), backend=backend,
                              device="cuda")
        ctrl.initialise()
        return ctrl

    steps = 4
    ctrl = controller("auto")
    zero_counts()
    t0 = time.perf_counter()
    log = ctrl.closed_loop(steps)
    loop_ms = (time.perf_counter() - t0) * 1e3 / steps
    launches = count_launches("4", "apg_solve", steps)
    ms = [log[f"time{t}"][0] for t in range(steps)]
    print(f"[closed_loop] {steps} steps, kernel launches {launches}, "
          f"solve ms per step {', '.join(f'{m:.3f}' for m in ms)}; "
          f"whole step (host prep + solve + simulator) {loop_ms:.3f} ms")
    kpis = {k: log[k] for k in KPI_KEYS}
    apg_kpis = dict(kpis)
    print(f"[closed_loop] kpis {json.dumps(kpis)}")
    controls = np.array([log[f"control{t}"] for t in range(steps)])
    if not (np.isfinite(controls).all() and
            np.isfinite(list(kpis.values())).all()):
        raise SmokeFailure("non-finite controls or KPIs")
    if "memoryLeakWarning" in log:
        raise SmokeFailure(log["memoryLeakWarning"])
    ref_log = controller("torch").closed_loop(steps)
    ref_controls = np.array([ref_log[f"control{t}"] for t in range(steps)])
    check_close("closed_loop.controls", torch.as_tensor(controls),
                torch.as_tensor(ref_controls))

    # 5. timing: median of REPEATS solves each, alternating the order
    rng = np.random.default_rng(7)
    x0 = cfg.current_x
    times = {"kernel": [], "plain": []}
    solvers = {"kernel": K.apg_solve, "plain": K.apg_solve_plain}
    for r in range(REPEATS):
        xr = x0 * (1.0 + 0.02 * rng.standard_normal(x0.shape)
                   ).astype(np.float32)
        step_r = make_step(xr)
        order = ("plain", "kernel") if r % 2 == 0 else ("kernel", "plain")
        for name in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = solvers[name](kc, step_r, None, **hyper)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            if not bool(torch.isfinite(out["control"]).all()):
                raise SmokeFailure(f"{name} solve gave non-finite control")
    med = {k: float(np.median(v)) for k, v in times.items()}
    for name in ("kernel", "plain"):
        runs = ", ".join(f"{t:.3f}" for t in times[name])
        print(f"[timing] {name} {MAX_ITER}-iteration solve: median "
              f"{med[name]:.3f} ms of {REPEATS} ({runs})")

    single_bound = solve_bound(kc, solve_inputs(kc, step_r), out, MAX_ITER,
                               prefix)
    dims = (tree.N, tree.ns, net.nx, net.nu, kc["iWT"].shape[0])
    apg_variant("5", dims, 1, lambda v: v["cluster"] > 1 and
                v["prefix_cluster"] > 1 and all(v["staged"].values()))

    def reference_apg(steps, batch=None, n_it=None):
        """DIR's apg_solve.cu (--reference-kernel) on these inputs."""
        hy = dict(hyper, max_iterations=n_it or MAX_ITER)
        strides = {} if batch is None else K._strides(kc, steps, batch)
        with torch.cuda.device(device):
            return K._launch(ref_libs["apg_solve"],
                             torch.cuda.current_stream().cuda_stream, kc,
                             steps, None, batch=batch, tolerance=None,
                             **strides, **hy)

    def these_apg(steps, batch=None, n_it=None):
        """This checkout's apg_solve.cu, through the same launch."""
        hy = dict(hyper, max_iterations=n_it or MAX_ITER)
        strides = {} if batch is None else K._strides(kc, steps, batch)
        with torch.cuda.device(device):
            return K._launch(K._load(kc),
                             torch.cuda.current_stream().cuda_stream, kc,
                             steps, None, batch=batch, tolerance=None,
                             **strides, **hy)

    if ref_libs:
        in_turns("5 single solve", {
            "reference": lambda n: reference_apg(step_r, n_it=n),
            "these": lambda n: these_apg(step_r, n_it=n)}, APG_AB_SOLVES)

    # 6. the batched kernel at B = 32
    rng = np.random.default_rng(7)
    x0s = perturbed(x0, rng)
    steps_sh = make_batch(x0s)
    steps_st = make_batch(x0s, shared=False)
    print(f"[batch] B {BATCH}: uhat batch stride "
          f"{steps_sh['uhat'].stride(0)} (shared), "
          f"{steps_st['uhat'].stride(0)} (stacked)")

    # 6a. every instance against the single-solve kernel
    bitwise = {}
    for form, steps_b in (("shared", steps_sh), ("stacked", steps_st)):
        kb = K.apg_solve_batch(kc, steps_b, None, **hyper)
        singles = [K.apg_solve(kc, instance(steps_b, b), None, **hyper)
                   for b in range(BATCH)]
        _, bitwise[form] = compare_instances(f"6a.{form}", kb, singles)
        print(f"[batch] 6a.{form}: all {BATCH} instances equal to the "
              f"single-solve kernel bit for bit: {bitwise[form]}")
    del singles

    # 6b. every instance against the plain version; a tolerance batch
    kb = K.apg_solve_batch(kc, steps_sh, None, **hyper)
    pb = K.apg_solve_plain(kc, steps_sh, None, **hyper)
    for k in ("control", "u", "x", "primal_infeasibility"):
        errs["batch." + k] = check_close("6b." + k, kb[k], pb[k])
    for k in ("xi", "psi"):
        check_close(f"6b.y.{k}", kb["y"][k], pb["y"][k])
    kt = K.apg_solve_batch(kc, steps_sh, None, tolerance=tol, **hyper)
    pt = K.apg_solve_plain(kc, steps_sh, None, tolerance=tol, **hyper)
    its_k, its_p = kt["iterations"].tolist(), pt["iterations"].tolist()
    print(f"[batch] 6b.tolerance {tol:g}: kernel exits {sorted(set(its_k))}"
          f" (per instance {its_k})")
    if its_k != its_p:
        raise SmokeFailure(f"tolerance exits differ: kernel {its_k}, "
                           f"plain {its_p}")
    for b, it in enumerate(its_k):
        if bool((kt["primal_infeasibility"][b, it:] != 0).any()):
            raise SmokeFailure(f"instance {b}: trace not zero past exit")
    check_close("6b.tol.control", kt["control"], pt["control"])

    # 6c. the batched entry at B = 1 is the single solve
    one = {k: v[:1] for k, v in steps_sh.items()}
    b1 = K.apg_solve_batch(kc, one, None, **hyper)
    s1 = K.apg_solve(kc, instance(steps_sh, 0), None, **hyper)
    _, eq1 = compare_instances("6c.B=1", b1, [s1])
    if not eq1:
        raise SmokeFailure("B = 1 differs from the single solve")
    print("[batch] 6c: B = 1 equals the single solve bit for bit: True")
    if ref_libs:
        with torch.cuda.device(device):
            r1 = K._launch(ref_libs["apg_solve"],
                           torch.cuda.current_stream().cuda_stream,
                           kc, instance(steps_sh, 0), None, batch=None,
                           tolerance=None, **hyper)
        same = outputs_equal(r1, s1, ("x", "u", "primal_infeasibility",
                                      "iterations"))
        print(f"[batch] 6c: single solve equals the reference kernel "
              f"(apg_solve.cu of --reference-kernel) bit for bit: {same}")
        if not same:
            raise SmokeFailure("the single solve changed")

    # 7. batched closed loops through the controller (the batch's main
    # path), cold and warm-started
    blogs, b_launches, single = batched_loops(
        "7", cfg, net, tree, x0s, (("cold", forecaster(net), False),
                                   ("warm", forecaster(net), True)),
        "apg_solve_batch")
    check_close("7.instance0.controls",
                torch.as_tensor(blogs["cold"]["controls"][:, 0]),
                torch.as_tensor(single))

    # 8. timing: batched solves, inputs staged on the device
    def run_b(steps):
        return K.apg_solve_batch(kc, steps, None, **hyper)

    batch_med, steps_r, out_b = batch_timing(
        "apg", run_b, lambda: make_batch(perturbed(x0, rng)))
    per = [timed(lambda: [run_b(steps_r) for _ in range(PIPELINE_DEPTH)])[0]
           / PIPELINE_DEPTH for _ in range(PIPELINE_ROUNDS)]
    pipe_med = float(np.median(per))
    plain_batch = [timed(lambda: K.apg_solve_plain(
        kc, steps_r, None, **hyper))[0] for _ in range(3)]
    plain_batch_ms = float(np.median(plain_batch))
    batch_bound = solve_bound(kc, solve_inputs(kc, steps_r), out_b,
                              MAX_ITER, prefix)
    apg_variant("8", dims, BATCH, lambda v: v["prefix_cluster"] > 1 and
                v["staged"]["prefix"])
    if ref_libs:
        in_turns(f"8 B = {BATCH}", {
            "reference": lambda n: reference_apg(steps_r, BATCH, n),
            "these": lambda n: these_apg(steps_r, BATCH, n)}, APG_AB_CALLS)
    print(f"[timing] pipelined, {PIPELINE_DEPTH} batched calls per "
          f"synchronise: median {pipe_med:.3f} ms per call of "
          f"{PIPELINE_ROUNDS} rounds ({', '.join(f'{t:.3f}' for t in per)})"
          f": {BATCH * 1e3 / pipe_med:.3f} solves/s")
    print(f"[timing] single solve {med['kernel']:.3f} ms: "
          f"{1e3 / med['kernel']:.3f} solves/s; batched per instance "
          f"{batch_med / BATCH:.3f} ms")
    print(f"[timing] plain batched version, B {BATCH}: median "
          f"{plain_batch_ms:.3f} ms of 3 ("
          f"{', '.join(f'{t:.3f}' for t in plain_batch)})")
    for name, (b_ms, by, flops, nbytes) in (("single", single_bound),
                                            ("batched", batch_bound)):
        print(f"[bound] {name}: {flops / 1e9:.3f} GFLOP, "
              f"{nbytes / 1e6:.3f} MB: {b_ms:.6f} ms, set by {by}")

    source = "rapidnet_tpu_torch/csrc/apg_solve.cu"
    entries = [
        {"name": "apg_solve", "route": "cuda", "source": source,
         "replaces": "rapidnet_tpu/ops/pallas_apg.py:177",
         "launches": launches, "max_abs_err": errs["u"],
         "ms": med["kernel"], "plain_ms": med["plain"],
         "bound_ms": single_bound[0], "bound_by": single_bound[1],
         "library_ms": None},
        {"name": "apg_solve_batch", "route": "cuda", "source": source,
         "replaces": "rapidnet_tpu/ops/pallas_apg.py:477",
         "launches": b_launches, "max_abs_err": errs["batch.u"],
         "ms": batch_med, "plain_ms": plain_batch_ms,
         "bound_ms": batch_bound[0], "bound_by": batch_bound[1],
         "library_ms": None}]
    return entries, apg_kpis


def stream_bound(kc, step, out, iterations):
    """The least time (ms) the card could take for one streaming solve
    and what sets it.  Operations: per iteration the products of K1
    (Bb t, L'(g wp), iW inner) and K2 (L v, B u) on every tree node (a
    prefix node once, not once per slot of its subtree: the rep mask
    counts the nodes), and the factored prefix aggregation (one add per
    child node and feature, not a dense ns x ns product), over 67
    TFLOP/s; elementwise work is left out.  Bytes: the inputs read once
    (the rank-1 constants, the matrices, the index lists, the step) and
    the outputs written once, over 3.35 TB/s.  Also the time to stream
    the state of every node once per iteration as K1 and K2 must when it
    does not fit on chip (K1 reads the pre-images, y, z and beta and
    writes y', z' and v; K2 reads v, uhat, e, y' and z' and writes x, u
    and the pre-images).  Returns (bound_ms, bound_by, flops, bytes,
    streamed_ms, streamed_bytes)."""
    from rapidnet_tpu_torch.ops import apg_stream as S
    N, ns, nx, nu, nv = S._dims(kc)
    nodes = int((kc["rep"] > 0).sum())
    per_node = 2 * (nv * nx + nv * nu + nv * nv + nu * nv + nx * nu)
    children = int(kc["agg_ptr"][-1]) if kc["agg_stages"] else 0
    flops = iterations * (nodes * per_node + children * (nx + nv))
    tensors = ([kc[k] for k in S.ROW_KEYS + S.MATRIX_KEYS + S.INDEX_KEYS]
               + [step[k] for k in ("beta", "uhat", "e", "x0", "prev_u",
                                    "prev_uhat")])
    nbytes = sum(t.numel() * t.element_size() for t in tensors) + sum(
        t.numel() * t.element_size() for t in
        (out["x"], out["u"], out["v"], out["y"]["xi"], out["y"]["psi"],
         out["primal_infeasibility"], out["control"]))
    dual = 2 * nx + nu
    streamed = iterations * nodes * 4 * ((3 * dual + nv) + (2 * dual + nv) +
                                         (nv + nu + nx + 2 * dual) +
                                         (nx + nu + dual))
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes,
            streamed / HBM_BYTES_PER_S * 1e3, streamed)


def close_or_witness(name, kern, plain, witness):
    """``check_close`` at TOL_FACTOR; where that fails, the float64
    witness rule of phase 3 decides (``witness()`` gives the float64
    value).  Returns the error against the plain version."""
    try:
        return check_close(name, kern, plain)
    except SmokeFailure as exc:
        print(f"[stream] {name}: {exc}; the float64 witness decides")
        witness_check(name, kern, plain, witness())
        return float((kern.double() - plain.double()).abs().max())


@contextlib.contextmanager
def reference_kernel(ref_libs, name):
    """Within the block the wrappers launch ``name`` from the reference
    source's library (--reference-kernel) instead of the checkout's."""
    from rapidnet_tpu_torch.ops import build
    load = build.load
    build.load = lambda n: ref_libs[n] if n == name else load(n)
    try:
        yield
    finally:
        build.load = load


def kernel_times(run, n_it, names):
    """Device µs per iteration of each kernel in ``names`` over one
    ``run()`` (``phase_us``); None where the trace holds no device
    time."""
    us = phase_us(run, n_it)
    return None if us is None else {n: us.get(n, 0.0) for n in names}


def stream_phases(ref_libs, device, kc_b, step_b, hyper_b):
    """Phases 15-18, the streaming APG kernels at BASELINE config 5 (and,
    in 16, on the Barcelona problem's ``step_b`` against the whole-solve
    kernel's constants ``kc_b``); ``ref_libs``: the kernels of an earlier
    checkout's sources, or None.  Returns their JSON entry and the
    config-5 problem (cfg, net, tree, fa, make_step, the streaming
    constants, the prefix stages, the solver's keywords)."""
    import numpy as np
    import torch
    from rapidnet_tpu_torch.engine.engine import XS_UPPER
    from rapidnet_tpu_torch.ops import apg_solve as K
    from rapidnet_tpu_torch.ops import apg_stream as S
    from rapidnet_tpu_torch.solver import apg as apg_mod
    from rapidnet_tpu_torch.solver.controller import SmpcController

    # 15. config 5; one K1 and one K2 pass against their plain halves,
    # from tanks above their box after PASS_ITER plain iterations
    t0 = time.perf_counter()
    cfg, eng, net, tree, fa, make_step, _ = build_problem(
        device, CONFIG5_BRANCHING)
    prefix = eng.factor_step().prefix_stages
    hyper = dict(inv_step=1.0 / cfg.step_size, step_size=cfg.step_size,
                 penalty_state=cfg.penalty_state,
                 penalty_safety=cfg.penalty_safety,
                 xs_upper=float(XS_UPPER), max_iterations=MAX_ITER)
    kc = S.stream_constants(fa, prefix_stages=prefix,
                            max_iterations=MAX_ITER)
    print(f"[stream] 15: config 5: nodes {tree.n_nodes} scenarios "
          f"{tree.ns} prefix stages {prefix}; K1 launches over stages "
          f"{kc['ranges']}; step size {cfg.step_size:.6g} (built and "
          f"tuned in {time.perf_counter() - t0:.3f} s)")
    dims = dict(N=tree.N, ns=tree.ns, nx=net.nx, nu=net.nu,
                nv=fa["invWbar"].shape[0])
    if K.fits(**dims) or not S.stream_fits(**dims):
        raise SmokeFailure("config 5 should be past the whole-solve "
                           "kernel's limits and within the streaming "
                           "kernels'")
    c = hyper["inv_step"]
    step_hot = make_step((1.2 * net.xmax).astype(np.float32))
    ps = S.plain_iterations(kc, step_hot, iterations=PASS_ITER, **hyper)
    lams = kc["lams"]
    sc = (lams[PASS_ITER - 1], lams[PASS_ITER], 1.0) + PASS_SHRINKS
    scal = dict(lam_prev=sc[0], lam_i=sc[1], upd=1.0, k1f=sc[3],
                k2f=sc[4], c=c, xs_upper=hyper["xs_upper"])
    print(f"[stream] 15: state after {PASS_ITER} plain iterations from "
          f"tanks at 1.2 xmax: max |y.xi| "
          f"{float(ps['y']['xi'].abs().max()):.6g}, max |y.psi| "
          f"{float(ps['y']['psi'].abs().max()):.6g}, its shrinks "
          f"{float(ps['k1f']):g}, {float(ps['k2f']):g}; the pass is given "
          f"k1f {sc[3]}, k2f {sc[4]}")
    yk, zk, vk, chk = S.k1_call(kc, step_hot, ps["pre"], ps["y"], ps["z"],
                                sc, **hyper)
    yp, zp, vp, chp = S.k1_plain(kc, step_hot["beta"], ps["pre"], ps["y"],
                                 ps["z"], step=hyper["step_size"], **scal)
    ratio = 0.0

    def held(name, got, ref):
        nonlocal ratio
        err = check_close(name, got, ref, PASS_FACTOR)
        ratio = max(ratio, err / max(float(ref.abs().max()), 1.0))

    for k in ("xi", "psi"):
        held(f"15.k1.y.{k}", yk[k], yp[k])
        held(f"15.k1.z.{k}", zk[k], zp[k])
    held("15.k1.v", vk, vp)
    held("15.k1.champion", chk, chp)
    pdu = step_hot["prev_u"] - step_hot["prev_uhat"]
    xk, uk, prek, d1k, d2k = S.k2_call(kc, step_hot, vp, yp, zp, sc,
                                       **hyper)
    xp, up, prep, d1p, d2p = S.k2_plain(
        kc, vp, step_hot["uhat"], step_hot["e"], step_hot["x0"], pdu, yp,
        zp, lam_i=sc[1], c=c, xs_upper=hyper["xs_upper"])
    held("15.k2.x", xk, xp)
    held("15.k2.u", uk, up)
    for k in ("xi", "psi"):
        held(f"15.k2.pre.{k}", prek[k], prep[k])
    held("15.k2.d1sq", d1k, d1p)
    held("15.k2.d2sq", d2k, d2p)
    print(f"[stream] 15: one K1 and one K2 pass hold their plain halves; "
          f"largest deviation {ratio:.6g} x max(|plain|, 1) (bound "
          f"{PASS_FACTOR:g})")
    if ref_libs:
        with reference_kernel(ref_libs, "apg_stream"):
            ykr, zkr, vkr, chkr = S.k1_call(kc, step_hot, ps["pre"], ps["y"],
                                            ps["z"], sc, **hyper)
            k2r = S.k2_call(kc, step_hot, vp, yp, zp, sc, **hyper)
        same = (all(torch.equal(a[k], b[k]) for a, b in ((ykr, yk), (zkr, zk))
                    for k in ("xi", "psi")) and torch.equal(vkr, vk) and
                torch.equal(chkr, chk) and all(
                    torch.equal(a, b) for a, b in
                    ((k2r[0], xk), (k2r[1], uk), (k2r[2]["xi"], prek["xi"]),
                     (k2r[2]["psi"], prek["psi"]), (k2r[3], d1k),
                     (k2r[4], d2k))))
        print(f"[stream] 15: K1 and K2 equal the reference kernels' "
              f"(apg_stream.cu of --reference-kernel) bit for bit: {same}")
        del ykr, zkr, vkr, k2r
        if not same:
            raise SmokeFailure("15: a K1 or K2 pass changed")
    del ps, yk, zk, vk, yp, zp, vp, xk, uk, prek, xp, up, prep

    # 16. the 500-iteration solve against the plain APG solve
    step = make_step(cfg.current_x)
    kern = S.apg_stream(kc, step, None, **hyper)
    run_plain = apg_mod.make_apg(prefix_stages=prefix, **hyper)
    plain = run_plain(fa, step)
    f64 = {}

    def witness():
        if "out" not in f64:
            f64["out"] = run_plain(as_f64(fa), as_f64(step))
        return f64["out"]

    errs = {}
    for k in ("control", "u", "x", "v", "primal_infeasibility"):
        errs[k] = close_or_witness(f"16.{k}", kern[k], plain[k],
                                   lambda k=k: witness()[k])
    for k in ("xi", "psi"):
        close_or_witness(f"16.y.{k}", kern["y"][k], plain["y"][k],
                         lambda k=k: witness()["y"][k])
    if int(kern["iterations"]) != MAX_ITER:
        raise SmokeFailure("the streaming solve ran "
                           f"{int(kern['iterations'])} iterations")
    y0 = plain["y"]
    kern_w = S.apg_stream(kc, step, y0, **hyper)
    plain_w = run_plain(fa, step, y0)
    close_or_witness("16.warm.control", kern_w["control"],
                     plain_w["control"],
                     lambda: run_plain(as_f64(fa), as_f64(step),
                                       as_f64(y0))["control"])
    again = S.apg_stream(kc, step, None, **hyper)
    same = outputs_equal(again, kern, ("x", "u", "v", "control",
                                       "primal_infeasibility"))
    print(f"[stream] 16: {MAX_ITER} iterations held to the plain solve; "
          f"warm start held; two calls equal bit for bit: {same}")
    if not same:
        raise SmokeFailure("the streaming kernels do not repeat themselves")
    if ref_libs:
        with reference_kernel(ref_libs, "apg_stream"):
            ref = S.apg_stream(kc, step, None, **hyper)
        same = outputs_equal(ref, kern, ("x", "u", "v", "control",
                                         "primal_infeasibility"))
        print(f"[stream] 16: the streaming solve equals the reference "
              f"kernels (apg_stream.cu of --reference-kernel) bit for bit: "
              f"{same}")
        if not same:
            raise SmokeFailure("the streaming APG solve changed")
    del kern_w, plain_w, again, plain, f64
    # two independent kernels on the Barcelona problem
    fa_b = kc_b["fa"]
    kc_sb = S.stream_constants(fa_b, prefix_stages=kc_b["prefix_stages"],
                               max_iterations=MAX_ITER)
    ks = S.apg_stream(kc_sb, step_b, None, **hyper_b)
    kw = K.apg_solve(kc_b, step_b, None, **hyper_b)
    for k in ("control", "u", "x", "primal_infeasibility"):
        check_close(f"16.barcelona.{k}", ks[k], kw[k])
    for k in ("xi", "psi"):
        check_close(f"16.barcelona.y.{k}", ks["y"][k], kw["y"][k])
    print("[stream] 16: on the Barcelona problem the streaming kernels "
          "hold the whole-solve kernel")

    # 17. the closed loops at config 5 (the main path)
    def loop(backend):
        ctrl = SmpcController(copy.deepcopy(cfg), network=net, tree=tree,
                              forecaster=forecaster(net), backend=backend,
                              device="cuda")
        ctrl.initialise()
        zero_counts()
        t0 = time.perf_counter()
        log = ctrl.closed_loop(STREAM_LOOP_STEPS)
        loop_ms = (time.perf_counter() - t0) * 1e3 / STREAM_LOOP_STEPS
        n = count_launches(f"17.{backend}", "apg_stream",
                           0 if backend == "torch" else STREAM_LOOP_STEPS)
        controls = np.array([log[f"control{t}"]
                             for t in range(STREAM_LOOP_STEPS)])
        kpis = {k: log[k] for k in KPI_KEYS}
        ms = [log[f"time{t}"][0] for t in range(STREAM_LOOP_STEPS)]
        print(f"[stream] 17.{backend}: route {ctrl.route}, "
              f"{STREAM_LOOP_STEPS} steps, apg_stream launches {n}, solve "
              f"ms per step {', '.join(f'{m:.3f}' for m in ms)}; whole "
              f"step {loop_ms:.3f} ms; kpis {json.dumps(kpis)}")
        if not (np.isfinite(controls).all() and
                np.isfinite(list(kpis.values())).all()):
            raise SmokeFailure(f"17.{backend}: non-finite controls or KPIs")
        if "memoryLeakWarning" in log:
            raise SmokeFailure(log["memoryLeakWarning"])
        return ctrl.route, controls, n

    route_a, auto, n_auto = loop("auto")
    route_s, streamed, n_stream = loop("stream")
    route_t, plain_c, _ = loop("torch")
    if (route_a, route_s, route_t) != ("stream", "stream", "plain"):
        raise SmokeFailure(f"17: routes {route_a}, {route_s}, {route_t}")
    same = np.array_equal(auto, streamed)
    print(f"[stream] 17: auto and stream controls equal bit for bit: "
          f"{same}")
    if not same:
        raise SmokeFailure("17: auto and stream controls differ")
    check_close("17.controls", torch.as_tensor(auto),
                torch.as_tensor(plain_c))

    # 18. timing, inputs staged on the device; the kernels by the
    # profiler; the plain version; peak memory; the bound
    staged = [make_step(x) for x in perturbed(
        cfg.current_x, np.random.default_rng(7), REPEATS)]
    times, enqueue = [], []
    for st in staged:
        ms, enq, out = timed(lambda: S.apg_stream(kc, st, None, **hyper))
        times.append(ms)
        enqueue.append(enq)
        if not bool(torch.isfinite(out["control"]).all()):
            raise SmokeFailure("18: non-finite control")
    med = float(np.median(times))
    per_kernel = kernel_times(lambda: S.apg_stream(kc, step, None, **hyper),
                              MAX_ITER, ("k1_kernel", "k2_kernel",
                                         "scalars_kernel", "tail_kernel"))
    plain_ms = timed(lambda: S.apg_stream_plain(kc, step, None, **hyper))[0]
    torch.cuda.synchronize()
    held_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = S.apg_stream(kc, step, None, **hyper)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    bound = stream_bound(kc, step, out, MAX_ITER)
    print(f"[timing] stream {MAX_ITER}-iteration solve at config 5: median "
          f"{med:.3f} ms of {REPEATS} ({', '.join(f'{t:.3f}' for t in times)})"
          f", {med * 1e3 / MAX_ITER:.3f} us per iteration; host enqueue "
          f"{', '.join(f'{t:.3f}' for t in enqueue)} ms; plain version "
          f"{plain_ms:.3f} ms")
    if per_kernel is None:
        print("[timing] stream kernels: the profiler trace holds no device "
              "time (not measured)")
    else:
        print("[timing] stream kernels, device us per iteration: " +
              ", ".join(f"{k} {v:.3f}" for k, v in per_kernel.items()))
    print(f"[memory] stream solve: peak {peak / 2**20:.3f} MiB allocated, "
          f"{(peak - held_bytes) / 2**20:.3f} MiB above the "
          f"{held_bytes / 2**20:.3f} MiB held before it")
    print(f"[bound] stream: {bound[2] / 1e9:.3f} GFLOP, {bound[3] / 1e6:.3f} "
          f"MB: {bound[0]:.6f} ms, set by {bound[1]}; the state streamed "
          f"once per iteration: {bound[5] / 1e9:.3f} GB, {bound[4]:.6f} ms")
    picked = S.staged(**dims)
    print(f"[stream] 18: the variants the source picks at config 5 (staged: "
          f"the matrices and a stage's operands in shared memory): {picked}")
    if not all(picked.values()):
        raise SmokeFailure("18: config 5 should take the staged K1, K2 and "
                           "fused kernels")
    if ref_libs:
        # the reference source's kernels and these in turns (reference,
        # these, these, reference), 3 solves each
        ab = {"reference": [], "these": []}
        for which in ("reference", "these", "these", "reference"):
            ctx = (reference_kernel(ref_libs, "apg_stream")
                   if which == "reference" else contextlib.nullcontext())
            with ctx:
                ab[which] += [timed(lambda: S.apg_stream(
                    kc, step, None, **hyper))[0] for _ in range(3)]
                per = kernel_times(
                    lambda: S.apg_stream(kc, step, None, **hyper), MAX_ITER,
                    ("k1_kernel", "k2_kernel", "scalars_kernel"))
            print(f"[timing] stream, {which} kernels: "
                  f"{', '.join(f'{t:.3f}' for t in ab[which][-3:])} ms; "
                  f"device us per iteration {per}")
        print(f"[timing] stream solve, median of 6: these kernels "
              f"{np.median(ab['these']):.3f} ms, the reference source's "
              f"{np.median(ab['reference']):.3f} ms")
    entry = {"name": "apg_stream", "route": "cuda",
             "source": "rapidnet_tpu_torch/csrc/apg_stream.cu",
             "replaces": "rapidnet_tpu/ops/pallas_stream.py:251",
             "launches": n_auto + n_stream, "max_abs_err": errs["u"],
             "ms": med, "plain_ms": plain_ms, "bound_ms": bound[0],
             "bound_by": bound[1], "library_ms": None}
    return entry, (cfg, net, tree, fa, make_step, kc, prefix, hyper)


def busy_span(intervals):
    """(busy, span) in the units of the (start, end) intervals: the time
    covered by at least one interval, and the first start to the last
    end."""
    intervals = sorted(intervals)
    busy, span = 0, intervals[-1][1] - intervals[0][0]
    cur_s, cur_e = intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + cur_e - cur_s, span


def stream_qn_counts(algorithm, iterations, solves=1):
    """The wrapper calls of ``solves`` streaming FBE/NAMA solves of
    ``iterations`` iterations on the card: the first iteration runs the
    solve step's sweep pair (and FBE's gradient oracle), every later one
    three sweep pairs, one dots and one combine pass; the third is
    captured once and replayed for the rest (``qn_stream.replayed``), so
    each wrapper is called for the first three."""
    first = 2 if algorithm == QN_ALGORITHMS["fbe"] else 1
    called = min(iterations, 3)
    pairs = solves * (first + 3 * (called - 1))
    passes = solves * (called - 1)
    return {"stream_qn.s1": pairs, "stream_qn.s2": pairs,
            "lbfgs.dots": passes, "lbfgs.combine": passes}


def check_counts(tag, want):
    """The launches counted since ``zero_counts()``: each wrapper of
    ``want`` launched as many times as it says and every other wrapper
    none.  Returns the counts of ``want``'s wrappers."""
    counts = {k: fn.launches for k, fn in wrappers().items()}
    got = {k: counts.pop(k) for k in want}
    if got != want or any(counts.values()):
        raise SmokeFailure(f"{tag}: launches {got}, expected {want}; the "
                           f"other kernels' {counts}")
    return got


def event_ms(fn, reps):
    """Device ms per call of fn(), by CUDA events over ``reps`` calls
    after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    for _ in range(reps):
        fn()
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1) / reps


STREAM_QN_PARTS = {"s1_kernel": "S1", "s2_kernel": "S2",
                   "dots_kernel": "dots", "dots_vec_kernel": "dots",
                   "dots_finish_kernel": "dots",
                   "combine_kernel": "combine"}


def stream_qn_part(kernel_name):
    """The part of the streaming FBE/NAMA solve a device kernel belongs
    to: S1, S2, dots, combine, or the glue (PyTorch's own kernels)."""
    import re
    m = re.search(r"(\w+_kernel)[<(]", kernel_name)
    return STREAM_QN_PARTS.get(m.group(1) if m else "", "glue")


def stream_qn_profile(run, n_it):
    """One ``run()`` of ``n_it`` iterations under ``torch.profiler``:
    device µs per iteration of S1, S2, the dots (both of its kernels),
    combine and the glue (every other device kernel), the device's busy
    ms over the span of the run and the idle share; None where the trace
    holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if str(getattr(e, "device_type", "")).endswith("CUDA")]
    if not events:
        return None
    per = dict.fromkeys(("S1", "S2", "dots", "combine", "glue"), 0.0)
    for e in events:
        per[stream_qn_part(e.name)] += e.time_range.end - e.time_range.start
    bodies = sorted(dots_bodies(e.name for e in events))
    busy, span = busy_span([(e.time_range.start, e.time_range.end)
                            for e in events])
    out = {k: v / n_it for k, v in per.items()}
    out.update(busy_ms=busy / 1e3, span_ms=span / 1e3,
               idle_share=1.0 - busy / span, dots_bodies=bodies)
    return out


DOTS_BODY = {"float32": ["dots_kernel"], "bfloat16": ["dots_vec_kernel"]}


def dots_bodies(kernel_names):
    """The bodies of the dots pass (``dots_kernel``, the one-value body,
    or ``dots_vec_kernel``, the vector body) among device kernel names."""
    import re
    found = set()
    for name in kernel_names:
        m = re.search(r"(\w+_kernel)[<(]", name)
        if m and m.group(1) in ("dots_kernel", "dots_vec_kernel"):
            found.add(m.group(1))
    return found


def check_dots_body(tag, dtype, bodies):
    """The dots pass of a main-path solve with ``dtype`` history ran the
    body DOTS_BODY names, and no other (``bodies``: the ones a profile
    of it saw, or None where its trace held no device time)."""
    if bodies is None:
        print(f"[stream_qn] {tag}: the dots body is not measured (no device "
              f"time in the trace)")
        return
    print(f"[stream_qn] {tag}: the {dtype} history's dots ran "
          f"{', '.join(bodies) or 'no body'}")
    if list(bodies) != DOTS_BODY[dtype]:
        raise SmokeFailure(f"{tag}: the {dtype} dots ran {bodies}, not "
                           f"{DOTS_BODY[dtype]}")


def bound_of(flops, nbytes):
    """(ms, what sets it): the larger of the FP32 operations over 67
    TFLOP/s and the bytes over 3.35 TB/s."""
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def stream_qn_work(kc):
    """The products of one S1 and one S2 pass on every tree node (a
    prefix node once: the rep mask counts the nodes) and of the prefix
    handoffs, and the bytes each variant moves (inputs read once, outputs
    written once): {"S1": (flops, bytes solve step, bytes oracle), "S2":
    ...}."""
    from rapidnet_tpu_torch.ops import stream_qn as SQ
    N, ns, nx, nu, nv = SQ.dims(kc)
    D = 2 * nx + nu
    rows, nodes = N * ns, int((kc["rep"] > 0).sum())
    children = int(kc["agg_ptr"][-1]) if kc["agg_stages"] else 0
    consts = sum(kc[k].numel() * 4 for k in
                 ("cx1", "cx2", "cu", "L", "BbT", "iWT", "LT", "BT"))
    s1_f = nodes * 2 * (nv * nx + nv * nu + nv * nv) + children * (nx + nv)
    s1_b = consts + 4 * rows * (2 + D + nv)           # sq, nhp, w in; v out
    s2_f = nodes * 2 * (nu * nv + nx * nu)
    s2_b = consts + 4 * rows * (1 + nv + nx + nu + D)  # sq, v in; x u pr out
    return {"S1": (s1_f, s1_b + 4 * rows * nv, s1_b),
            "S2": (s2_f, s2_b + 4 * rows * (nu + nx) + 4 * (nx + nu), s2_b)}


def history_work(E, rows, M, size, dots):
    """(flops, bytes) of one history pass over E values a column, M
    columns a history, ``size`` bytes a stored value: the dots read both
    histories, s, yv, g and rep and write 6 M + 6 floats, 2 (6 M + 6)
    operations a value; combine reads both histories and g and writes the
    direction, 2 (2 M + 1) operations a value."""
    if dots:
        return (2 * (6 * M + 6) * E,
                (2 * M + 2) * E * size + 4 * E + 4 * rows + 4 * (6 * M + 6))
    return 2 * (2 * M + 1) * E, 2 * M * E * size + 8 * E + 4 * (2 * M + 1)


def tracking(tag, kern, plain, min_track, label="stream_qn"):
    """9a's TRACK between two solves of n iterations (kern(n),
    plain(n)): the traces within the JAX bounds, then control and u;
    at least ``min_track``.  ``label`` tags the printed line."""
    k_s, p_s = kern(QN_TRACK_MAX), plain(QN_TRACK_MAX)
    traced = qn_horizon(k_s, p_s, QN_TRACK_MAX)
    track = traced
    while track >= min_track:
        k_t, p_t = kern(track), plain(track)
        agree, u_atol = solutions_agree(k_t, p_t)
        if agree:
            break
        track -= 1
    print(f"[{label}] {tag}: TRACK {track} (traces within the JAX "
          f"bounds over {traced} of {QN_TRACK_MAX} iterations, control "
          f"and u after the first {track})")
    if track < min_track:
        raise SmokeFailure(f"{tag}: the two solves track over {track} "
                           f"iterations, fewer than {min_track}")
    check_allclose(f"{tag}.control", k_t["control"], p_t["control"],
                   1e-3, 1e-4)
    return check_allclose(f"{tag}.u", k_t["u"], p_t["u"], 0.0, u_atol)


def stream_qn_phases(ref_libs, device, problem, kq_b, kc_b, step_b,
                     hyper_b):
    """Phases 19-22, the streaming FBE/NAMA path at BASELINE config 5
    (``problem``, phase 15's), and in 20 on the Barcelona problem against
    the whole-solve QN kernel (its constants ``kq_b``, the streaming
    constants' source ``kc_b``); ``ref_libs``: the kernels of an earlier
    checkout (``--reference-kernel``) or None.  Returns the JSON entries
    of S1, S2 and the history passes."""
    import numpy as np
    import torch
    from rapidnet_tpu_torch.ops import apg_stream as S
    from rapidnet_tpu_torch.ops import lbfgs as LB
    from rapidnet_tpu_torch.ops import qn_solve as Q
    from rapidnet_tpu_torch.ops import stream_qn as SQ
    from rapidnet_tpu_torch.solver import qn_stream as QS
    from rapidnet_tpu_torch.solver import quasi_newton as qn_mod
    from rapidnet_tpu_torch.solver.controller import SmpcController

    cfg, net, tree, fa, make_step, kc, prefix, hyper = problem
    bs = int(cfg.lbfgs_buffer_size)
    N, ns, nx, nu, nv = SQ.dims(kc)
    D, M = 2 * nx + nu, bs + 1
    rows, E = N * ns, N * ns * (2 * nx + nu)
    errs = {}

    # 19. one S1/S2 pass in each variant against its plain half, from the
    # duals after PASS_ITER plain APG iterations from tanks at 1.2 xmax;
    # one dots and one combine pass over a full history in each storage
    step_hot = make_step((1.2 * net.xmax).astype(np.float32))
    ps = S.plain_iterations(kc, step_hot, iterations=PASS_ITER, **hyper)
    w = torch.cat([ps["y"]["xi"], ps["y"]["psi"]], dim=-1).contiguous()
    pdu = (step_hot["prev_u"] - step_hot["prev_uhat"]).contiguous()
    affine = {True: ((step_hot["beta"],), (step_hot["uhat"], step_hot["e"],
                                           step_hot["x0"], pdu)),
              False: ((), ())}
    v_in = SQ.s1_plain(kc, w, step_hot["beta"])
    del ps
    variant = SQ.staged(N, ns, nx, nu, nv)
    print(f"[stream_qn] 19: the source picks S1 "
          f"{'staged' if variant['s1'] else 'unstaged'}, S2 "
          f"{'staged' if variant['s2'] else 'unstaged'} (staged: "
          f"{variant['s1_smem']} and {variant['s2_smem']} bytes; "
          f"stream_qn_staged)")
    if not (variant["s1"] and variant["s2"]):
        raise SmokeFailure(f"19: config 5 should stage S1 and S2: {variant}")
    for aff, (a1, a2) in affine.items():
        label = "solve" if aff else "oracle"
        got_v = SQ.s1_call(kc, w, *a1)
        errs[f"S1.{label}"] = check_close(
            f"19.s1.{label}.v", got_v, SQ.s1_plain(kc, w, *a1), PASS_FACTOR)
        got, ref = SQ.s2_call(kc, v_in, *a2), SQ.s2_plain(kc, v_in, *a2)
        errs[f"S2.{label}"] = max(
            check_close(f"19.s2.{label}.{name}", g, r, PASS_FACTOR)
            for name, g, r in zip(("x", "u", "images"), got, ref))
        if ref_libs is not None:
            with reference_kernel(ref_libs, "stream_qn"):
                ref_v = SQ.s1_call(kc, w, *a1)
                ref_s2 = SQ.s2_call(kc, v_in, *a2)
            same = torch.equal(got_v, ref_v) and all(
                torch.equal(g, r) for g, r in zip(got, ref_s2))
            print(f"[stream_qn] 19.{label}: S1 and S2 equal to the "
                  f"reference source's bit for bit: {same}")
            if not same:
                raise SmokeFailure(f"19.{label}: S1/S2 differ from the "
                                   "reference source's")
    gen = torch.Generator().manual_seed(19)

    def seeded(*shape):
        return torch.randn(shape, generator=gen).to(device)

    hist = {}
    for dtype in LB.STORAGE:
        mat_s, mat_y = (seeded(M, N, ns, D).to(dtype) for _ in range(2))
        mat_s[0] = 0
        mat_y[0] = 0
        s, yv = (seeded(N, ns, D).to(dtype) for _ in range(2))
        g = seeded(N, ns, D)
        coef = seeded(2 * M + 1)
        hist[dtype] = (mat_s, mat_y, s, yv, g, coef)
        name = str(dtype).split(".")[-1]
        got = LB.dots(kc["rep"], mat_s, mat_y, s, yv, g)
        ref = LB.dots_plain(kc["rep"], mat_s, mat_y, s, yv, g)
        mag = LB.dots_plain(kc["rep"], mat_s.abs(), mat_y.abs(), s.abs(),
                            yv.abs(), g.abs())
        ratio = max(float(((a - b).abs() / m.clamp(min=1e-30)).max())
                    for a, b, m in zip(got, ref, mag))
        errs[f"dots.{name}"] = max(float((a - b).abs().max())
                                   for a, b in zip(got, ref))
        print(f"[stream_qn] 19.dots.{name}: max |kernel - plain| "
              f"{errs[f'dots.{name}']:.6g}, at most {ratio:.6g} of the "
              f"rep-weighted sum of |products| (bound 1e-5)")
        if not ratio <= 1e-5:
            raise SmokeFailure(f"19.dots.{name}: kernel and plain disagree")
        errs[f"combine.{name}"] = check_close(
            f"19.combine.{name}", LB.combine(coef, mat_s, mat_y, g),
            LB.combine_plain(coef, mat_s, mat_y, g), 1e-6)
    print(f"[stream_qn] 19: S1/S2 in both variants hold their plain halves "
          f"(bound {PASS_FACTOR:g} x max(|plain|, 1)); the history passes "
          f"hold theirs in float32 and bfloat16 (history {M} x {E} values)")

    def solver(algorithm, n=MAX_ITER, dtype="float32", consts=kc, f=fa,
               hy=hyper):
        return QS.make_qn_stream(f, algorithm=algorithm, consts=consts,
                                 prefix_stages=consts["prefix_stages"],
                                 lbfgs_buffer_size=bs, lbfgs_dtype=dtype,
                                 **dict(hy, max_iterations=n))

    def plain_qn(algorithm, n, step, y0=None, f=fa, hy=hyper,
                 consts=kc):
        return qn_mod.make_solver(
            algorithm=algorithm, prefix_stages=consts["prefix_stages"],
            lbfgs_buffer_size=bs, **dict(hy, max_iterations=n))(f, step, y0)

    # 20. the solve: kernels against the plain QN solve over the horizon
    # over which two float32 solves track; the residual tail at 500
    # iterations; repeats; a warm start; the bf16 history; no host sync
    step = make_step(cfg.current_x)
    solves, plain_ms, bf16_dev = {}, {}, {}
    for short, algorithm in QN_ALGORITHMS.items():
        min_track = QN_SHORT[short]
        errs[f"solve.{short}"] = tracking(
            f"20.{short}", lambda n: solver(algorithm, n)(step),
            lambda n: plain_qn(algorithm, n, step), min_track)
        run = solver(algorithm)
        torch.cuda.set_sync_debug_mode("error")
        try:
            k_full = run(step)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_full = plain_qn(algorithm, MAX_ITER, step)
        torch.cuda.synchronize()
        plain_ms[short] = (time.perf_counter() - t0) * 1e3
        again = run(step)
        same = outputs_equal(again, k_full, ("x", "u", "v", "control") +
                             QN_TRACES)
        tail_k = float(np.median(
            k_full["primal_infeasibility"].abs().cpu().numpy()[-20:]))
        tail_p = float(np.median(
            p_full["primal_infeasibility"].abs().cpu().numpy()[-20:]))
        u0 = k_full["control"]
        inside = bool(((u0 >= fa["umin_phys"] - 1e-5) &
                       (u0 <= fa["umax_phys"] + 1e-5)).all())
        print(f"[stream_qn] 20.{short}: {MAX_ITER} iterations with no host "
              f"sync (torch.cuda.set_sync_debug_mode('error')); median "
              f"|infeasibility| of the last 20: kernels {tail_k:.6g}, plain "
              f"{tail_p:.6g}; control within the physical bounds: "
              f"{inside}; two calls equal bit for bit: {same}; plain solve "
              f"{plain_ms[short]:.3f} ms")
        if not (bool(torch.isfinite(k_full["u"]).all()) and
                int(k_full["iterations"]) == MAX_ITER):
            raise SmokeFailure(f"20.{short}: the 500-iteration solve failed")
        if not tail_k < 10 * max(tail_p, 1e-6):
            raise SmokeFailure(f"20.{short}: residual tail {tail_k:.6g} "
                               f"above 10 x the plain version's")
        if not (inside and same):
            raise SmokeFailure(f"20.{short}: control outside its bounds or "
                               "repeats differ")
        y0 = p_full["y"]
        tracking(f"20.{short}.warm",
                 lambda n: solver(algorithm, n)(step, y0),
                 lambda n: plain_qn(algorithm, n, step, y0), min_track)
        k16 = solver(algorithm, dtype="bfloat16")(step)
        dev16 = float((k16["control"] - u0).abs().max())
        scale = max(float(u0.abs().max()), 1.0)
        bf16_dev[short] = dev16 / scale
        print(f"[stream_qn] 20.{short}.bf16: {MAX_ITER} iterations with the "
              f"bf16 history: max |control - f32's| {dev16:.6g} "
              f"({dev16 / scale:.6g} of max(|f32|, 1); gate 1e-1); u "
              f"{float((k16['u'] - k_full['u']).abs().max()):.6g}")
        if not (bool(torch.isfinite(k16["u"]).all()) and
                dev16 <= 1e-1 * scale):
            raise SmokeFailure(f"20.{short}.bf16: the bf16 history's "
                               "control strays")
        solves[short] = k_full
        del p_full, again, k16
        # two independent kernels on the Barcelona problem
        fa_b = kc_b["fa"]
        ks_b = S.stream_constants(fa_b, prefix_stages=kc_b["prefix_stages"],
                                  max_iterations=MAX_ITER)
        tracking(f"20.{short}.barcelona",
                 lambda n: solver(algorithm, n, consts=ks_b, f=fa_b,
                                  hy=hyper_b)(step_b),
                 lambda n: Q.qn_solve(kq_b, step_b, None,
                                      **dict(hyper_b, max_iterations=n,
                                             algorithm=algorithm,
                                             lbfgs_buffer_size=bs)),
                 min_track)

    # 21. the closed loops at config 5 (the main path): auto, stream and
    # stream with the bf16 history for each algorithm; a plain FBE loop
    launches = {}
    loop_controls = {}

    def loop(short, backend, steps=STREAM_QN_LOOP_STEPS, **kw):
        c = copy.deepcopy(cfg)
        c.algorithm = QN_ALGORITHMS[short]
        ctrl = SmpcController(c, network=net, tree=tree,
                              forecaster=forecaster(net), backend=backend,
                              device="cuda", **kw)
        ctrl.initialise()
        zero_counts()
        t0 = time.perf_counter()
        log = ctrl.closed_loop(steps)
        loop_ms = (time.perf_counter() - t0) * 1e3 / steps
        want = ({} if backend == "torch" else
                stream_qn_counts(c.algorithm, MAX_ITER, steps))
        got = check_counts(f"21.{short}.{backend}", want)
        tag = f"{short}.{backend}" + (".bf16" if kw else "")
        controls = np.array([log[f"control{t}"] for t in range(steps)])
        kpis = {k: log[k] for k in KPI_KEYS}
        ms = [log[f"time{t}"][0] for t in range(steps)]
        print(f"[stream_qn] 21.{tag}: route {ctrl.route}, {steps} steps, "
              f"launches {json.dumps(got)}, solve ms per step "
              f"{', '.join(f'{m:.3f}' for m in ms)}; whole step "
              f"{loop_ms:.3f} ms; kpis {json.dumps(kpis)}")
        if not (np.isfinite(controls).all() and
                np.isfinite(list(kpis.values())).all()):
            raise SmokeFailure(f"21.{tag}: non-finite controls or KPIs")
        if "memoryLeakWarning" in log:
            raise SmokeFailure(log["memoryLeakWarning"])
        want_route = "plain" if backend == "torch" else "stream"
        if ctrl.route != want_route:
            raise SmokeFailure(f"21.{tag}: route {ctrl.route}")
        for k, n in got.items():
            if k.startswith("lbfgs"):
                k += ".bfloat16" if kw else ".float32"
            launches[k] = launches.get(k, 0) + n
        loop_controls[tag] = controls
        return controls

    for short in QN_ALGORITHMS:
        auto = loop(short, "auto")
        streamed = loop(short, "stream")
        loop(short, "stream", stream_lbfgs_dtype="bfloat16")
        if not np.array_equal(auto, streamed):
            raise SmokeFailure(f"21.{short}: auto and stream controls differ")
        print(f"[stream_qn] 21.{short}: auto and stream controls equal bit "
              f"for bit: True")
    plain_c = loop("fbe", "torch", steps=PLAIN_LOOP_STEPS)
    gap = float(np.abs(loop_controls["fbe.stream"][:PLAIN_LOOP_STEPS] -
                       plain_c).max())
    print(f"[stream_qn] 21.fbe: the plain loop's controls against the "
          f"streaming loop's over {PLAIN_LOOP_STEPS} steps: max |difference|"
          f" {gap:.6g} (two float32 QN solves part after a few iterations; "
          f"recorded, not gated)")

    # 22. timing, inputs staged on the device: 500-iteration solves per
    # algorithm and history storage; device µs per iteration by the
    # profiler, the idle share, peak memory, the bound; each kernel's
    # time per call at the main path's shapes beside its plain version's
    staged = [make_step(x) for x in perturbed(
        cfg.current_x, np.random.default_rng(7), STREAM_QN_REPEATS)]
    fq = {}
    for short, algorithm in QN_ALGORITHMS.items():
        for dtype in ("float32", "bfloat16"):
            run = solver(algorithm, dtype=dtype)
            times, enqueue = [], []
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            for st in staged:
                ms, enq, out = timed(lambda: run(st))
                times.append(ms)
                enqueue.append(enq)
                if not bool(torch.isfinite(out["control"]).all()):
                    raise SmokeFailure(f"22.{short}: non-finite control")
            peak = torch.cuda.max_memory_allocated() - held
            med = float(np.median(times))
            prof = stream_qn_profile(
                lambda: solver(algorithm, PROFILE_ITER, dtype)(step),
                PROFILE_ITER)
            fq[(short, dtype)] = (med, prof, peak)
            check_dots_body(f"22.{short}", dtype,
                            None if prof is None else prof["dots_bodies"])
            print(f"[timing] stream {short} {dtype} history, {MAX_ITER} "
                  f"iterations at config 5: median {med:.3f} ms of "
                  f"{STREAM_QN_REPEATS} "
                  f"({', '.join(f'{t:.3f}' for t in times)}), "
                  f"{med * 1e3 / MAX_ITER:.3f} us per iteration; host "
                  f"enqueue {', '.join(f'{t:.3f}' for t in enqueue)} ms; "
                  f"peak {peak / 2**20:.3f} MiB above the "
                  f"{held / 2**20:.3f} MiB held")
            if prof is None:
                print("[timing] the profiler trace holds no device time "
                      "(not measured)")
            else:
                print(f"[timing] stream {short} {dtype}, device us per "
                      f"iteration over a {PROFILE_ITER}-iteration solve: " +
                      ", ".join(f"{k} {prof[k]:.3f}" for k in
                                ("S1", "S2", "dots", "combine", "glue")) +
                      f"; busy {prof['busy_ms']:.3f} of a "
                      f"{prof['span_ms']:.3f} ms span, idle share "
                      f"{prof['idle_share']:.4f}")
    work = stream_qn_work(kc)
    out = solves["fbe"]
    sweeps = work["S1"][0] + work["S2"][0]
    value = int((kc["rep"] > 0).sum()) * 2 * nu * nu
    for short, algorithm in QN_ALGORITHMS.items():
        first = 2 if short == "fbe" else 1
        for dtype, size in (("float32", 4), ("bfloat16", 2)):
            hist_f = sum(history_work(E, rows, M, size, d)[0]
                         for d in (True, False))
            flops = (first * sweeps + (MAX_ITER - 1) *
                     (3 * sweeps + 3 * value + hist_f))
            tensors = ([kc[k] for k in SQ.CONST_KEYS] +
                       [fa[k] for k in ("W", "umin_phys", "umax_phys")] +
                       [step[k] for k in ("beta", "uhat", "e", "alpha_price",
                                          "x0", "prev_u", "prev_uhat")])
            nbytes = sum(t.numel() * t.element_size() for t in tensors) + sum(
                t.numel() * t.element_size() for t in
                (out["x"], out["u"], out["v"], out["y"]["xi"],
                 out["y"]["psi"], out["primal_infeasibility"],
                 out["value_fbe"], out["tau"], out["control"]))
            b_ms, by = bound_of(flops, nbytes)
            streamed = (MAX_ITER - 1) * sum(
                history_work(E, rows, M, size, d)[1] for d in (True, False))
            med = fq[(short, dtype)][0]
            print(f"[bound] stream {short} {dtype}: {flops / 1e9:.3f} GFLOP, "
                  f"{nbytes / 1e6:.3f} MB: {b_ms:.6f} ms, set by {by} "
                  f"({100 * b_ms / med:.3f} % of the measured); the history "
                  f"read by its two passes an iteration, over the solve: "
                  f"{streamed / 1e9:.3f} GB, "
                  f"{streamed / HBM_BYTES_PER_S * 1e3:.6f} ms")

    # each kernel per call at the main path's shapes (phase 19's inputs):
    # the sweeps as the iteration mixes them (one solve step, two
    # oracles), the history passes in each storage
    reps = 20

    def sweep_mix(fn, which):
        """One solve-step pass and two oracle passes of S1 or S2."""
        def run():
            for aff in (True, False, False):
                a1, a2 = affine[aff]
                if which == "S1":
                    fn(kc, w, *a1)
                else:
                    fn(kc, v_in, *a2)
        return run

    entries = []
    src = "rapidnet_tpu_torch/csrc/stream_qn.cu"
    if ref_libs is not None:
        fbe = QN_ALGORITHMS["fbe"]

        def ref_solve(n):
            with reference_kernel(ref_libs, "stream_qn"):
                return solver(fbe, min(n, STREAM_QN_AB_ITER))(step)
        in_turns(f"22.fbe {STREAM_QN_AB_ITER}-iteration solve", {
            "reference": ref_solve,
            "these": lambda n: solver(fbe, min(n, STREAM_QN_AB_ITER))(step)},
            1)
    for name, call, plain, key, line in (
            ("S1", SQ.s1_call, SQ.s1_plain, "stream_qn.s1",
             "rapidnet_tpu/ops/pallas_stream_qn.py:79"),
            ("S2", SQ.s2_call, SQ.s2_plain, "stream_qn.s2",
             "rapidnet_tpu/ops/pallas_stream_qn.py:129")):
        ms = event_ms(sweep_mix(call, name), reps) / 3
        p_ms = event_ms(sweep_mix(plain, name), 2) / 3
        if ref_libs is not None:
            med = in_turns(f"22.{name}, {MAX_ITER} rounds of one solve "
                           "step and two oracles,", source_runs(
                               ref_libs, "stream_qn", sweep_mix(call, name)),
                           1)
            print(f"[timing] {name} in turns: these "
                  f"{med['these'] / (3 * MAX_ITER):.6f} ms per call, the "
                  f"reference source's "
                  f"{med['reference'] / (3 * MAX_ITER):.6f} ms")
        flops, b_aff, b_orc = work[name]
        b_ms = (bound_of(flops, b_aff)[0] + 2 * bound_of(flops, b_orc)[0]) / 3
        by = bound_of(flops, b_orc)[1]
        print(f"[timing] {name}: {ms:.6f} ms per call (one solve step and "
              f"two oracles, {reps} rounds), plain {p_ms:.6f} ms; bound "
              f"{b_ms:.6f} ms ({by}); {flops / 1e9:.3f} GFLOP a pass")
        entries.append({
            "name": key, "route": "cuda", "source": src, "replaces": line,
            "launches": launches[key],
            "max_abs_err": max(errs[f"{name}.solve"], errs[f"{name}.oracle"]),
            "ms": ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": None,
            "variant": ("staged" if variant[name.lower()] else
                        "unstaged")})
    for dtype in LB.STORAGE:
        name = str(dtype).split(".")[-1]
        mat_s, mat_y, s, yv, g, coef = hist[dtype]
        size = mat_s.element_size()
        for which, fn, plain, line in (
                ("dots", lambda: LB.dots(kc["rep"], mat_s, mat_y, s, yv, g),
                 lambda: LB.dots_plain(kc["rep"], mat_s, mat_y, s, yv, g),
                 "rapidnet_tpu/ops/pallas_lbfgs.py:72"),
                ("combine", lambda: LB.combine(coef, mat_s, mat_y, g),
                 lambda: LB.combine_plain(coef, mat_s, mat_y, g),
                 "rapidnet_tpu/ops/pallas_lbfgs.py:150")):
            ms = event_ms(fn, reps)
            p_ms = event_ms(plain, 3)
            if ref_libs is not None:
                med = in_turns(f"22.{which} {name}, {MAX_ITER} passes,",
                               source_runs(ref_libs, "lbfgs", fn), 1)
                print(f"[timing] {which} {name} in turns: these "
                      f"{med['these'] / MAX_ITER:.6f} ms per pass, the "
                      f"reference source's "
                      f"{med['reference'] / MAX_ITER:.6f} ms")
            flops, nbytes = history_work(E, rows, M, size, which == "dots")
            b_ms, by = bound_of(flops, nbytes)
            print(f"[timing] {which} {name}: {ms:.6f} ms per call, plain "
                  f"{p_ms:.6f} ms; bound {b_ms:.6f} ms ({by}: "
                  f"{nbytes / 1e6:.3f} MB, {flops / 1e9:.3f} GFLOP); "
                  f"{nbytes / ms / 1e6:.3f} GB/s")
            key = f"lbfgs.{which}.{name}"
            entries.append({
                "name": key, "route": "cuda",
                "source": "rapidnet_tpu_torch/csrc/lbfgs.cu",
                "replaces": line, "launches": launches[key],
                "max_abs_err": errs[f"{which}.{name}"], "ms": ms,
                "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
                "library_ms": None})
    for short in QN_ALGORITHMS:
        print(f"[stream_qn] {short}: kernels against the plain QN solve, "
              f"u within {errs[f'solve.{short}']:.6g} over TRACK; bf16 "
              f"control deviation {bf16_dev[short]:.6g} of max(|f32|, 1); "
              f"plain 500-iteration solve {plain_ms[short]:.3f} ms")
    return entries


MESH_RANKS = 2        # phases 23-27: two ranks share card 0 over gloo
MESH_TIMEOUT = 1500   # s the parent waits for the ranks' results
MESH_LOOP_STEPS = 2   # phase 26's loops: steps (cut from 4: the run took
                      # 1067 s of its 1200 on a slow host)
MESH_LOOP_ITER = 50   # phase 26's QN loops: iterations per step (cut from
                      # 500: a sharded QN iteration takes ~35 ms here)
MESH_QN_ITER = 100    # phases 25/27's sharded QN solves (cut from 500,
                      # then 200: a sharded QN iteration takes 30-60 ms
                      # on a shared host)
DOTS_BODY_ITER = 3    # phase 25: the profiled sharded solve that shows
                      # the dots body (iterations 2 and 3 run the dots)
MESH_QN_REPEATS = 2   # phases 25/27: sharded QN solves timed per
                      # algorithm and history storage (cut from 3 to keep
                      # the run inside its limit on slower hosts)
def mesh_qn_counts(algorithm, iterations, solves=1):
    """The wrapper calls of ``solves`` sharded FBE/NAMA solves: every
    iteration runs eagerly (no graph on a mesh), the first with the
    solve step's sweeps (and FBE's gradient oracle), every later one with
    three sweeps, one dots and one combine pass; each sharded backward
    sweep launches one partial parent block."""
    first = 2 if algorithm == QN_ALGORITHMS["fbe"] else 1
    sweeps = solves * (first + 3 * (iterations - 1))
    passes = solves * (iterations - 1)
    return {"stream_qn.s1a": sweeps, "stream_qn.s2": sweeps,
            "stream_sharded.partial_parents": sweeps,
            "lbfgs.dots": passes, "lbfgs.combine": passes}


def shard_work(kc):
    """Per pass on a rank's block: the products on its tree nodes (the
    rep mask counts a node once) and handoffs, and the bytes (inputs read
    once, outputs written once) of K1a (stages N-1 .. s_hi with the dual
    update), K2, the partial parent block, the sharded S1 (stages N-1 ..
    s_hi; solve step and oracle) and S2 on the block: {name: (flops,
    bytes) or (flops, bytes solve step, bytes oracle)}."""
    from rapidnet_tpu_torch.ops import stream_qn as SQ
    N, nsl, nx, nu, nv = SQ.dims(kc)
    s_hi = kc["s_hi"]
    D, W = 2 * nx + nu, nx + nv
    high = int((kc["rep"][s_hi:] > 0).sum())
    nodes = int((kc["rep"] > 0).sum())
    rows_h, rows = (N - s_hi) * nsl, N * nsl
    children = int(kc["agg_ptr"][-1]) if kc["agg_stages"] else 0
    consts = sum(kc[k].numel() * 4 for k in
                 ("cx1", "cx2", "cu", "bx_min", "bx_max", "bx_s", "bu_min",
                  "bu_max", "L", "BbT", "iWT", "LT", "BT"))
    bw = 2 * (nv * nx + nv * nu + nv * nv)
    fw = 2 * (nu * nv + nx * nu)
    R = kc["n_parents"]
    pp = (int(kc["x_Cp"].sum()) * W, 4 * (nsl * W + R * W))
    k1a_b = consts + 4 * rows_h * (3 * D + nv + 2) + 4 * rows_h * (
        2 * D + nv) + 4 * R * W
    k2_b = consts + 4 * rows * (nv + nu + nx + 2 * D + 3) + 4 * rows * (
        nx + nu + D)
    s1_b = consts + 4 * rows_h * (D + 2) + 4 * rows_h * nv + 4 * R * W
    s2_b = consts + 4 * rows * (nv + 1) + 4 * rows * (nx + nu + D)
    return {"k1a": (high * bw + children * W, k1a_b),
            "k2": (nodes * fw, k2_b),
            "partial_parents": pp,
            "s1a": (high * bw + children * W, s1_b + 4 * rows_h * nv, s1_b),
            "s2": (nodes * fw, s2_b + 4 * rows * (nu + nx) + 4 * (nx + nu),
                   s2_b)}


def mesh_profile(run, n_it, names):
    """One ``run()`` of ``n_it`` iterations under ``torch.profiler`` on
    this rank: device µs per iteration of the kernels in ``names`` and
    of every other device kernel (the glue), the host µs per iteration
    inside the collectives (the gloo calls, which copy CUDA tensors to
    the host and back), the busy share of the span; None where the trace
    holds no device time.  The collectives are the ``mesh.*`` spans
    ``parallel.Mesh`` records."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.events()
    dev = [e for e in events
           if str(getattr(e, "device_type", "")).endswith("CUDA")]
    if not dev:
        return None
    per = dict.fromkeys(list(names) + ["glue"], 0.0)
    for e in dev:
        key = next((n for n in names if n in e.name), "glue")
        per[key] += e.time_range.end - e.time_range.start
    coll = [(e.time_range.start, e.time_range.end) for e in events
            if e.name.startswith("mesh.")]
    busy, span = busy_span([(e.time_range.start, e.time_range.end)
                            for e in dev])
    out = {k: v / n_it for k, v in per.items()}
    out["collectives_host"] = (busy_span(coll)[0] / n_it if coll else 0.0)
    out.update(busy_ms=busy / 1e3, span_ms=span / 1e3,
               idle_share=1.0 - busy / span)
    return out


def mesh_phases(mesh, ref_paths=None):
    """Phases 23-27 on this rank of a two-rank mesh on card 0 (every rank
    runs them; rank 0 prints and reports): the sharded streaming APG and
    FBE/NAMA solves at BASELINE config 5; ``ref_paths``: the libraries of
    an earlier checkout's ``stream_qn.cu`` and ``stream_sharded.cu`` by
    name (``--reference-kernel``), or None.
    Returns (the JSON entries of the sharded kernels, the counts of phase
    26's main-path runs, this rank's peak memory)."""
    import numpy as np
    import torch
    from rapidnet_tpu_torch.engine.engine import XS_UPPER
    from rapidnet_tpu_torch.ops import apg_stream as S
    from rapidnet_tpu_torch.ops import apg_stream_sharded as SS
    from rapidnet_tpu_torch.ops import stream_qn as SQ
    from rapidnet_tpu_torch.solver import qn_stream as QS
    from rapidnet_tpu_torch.solver.controller import SmpcController

    dev = mesh.device
    t0 = time.perf_counter()
    ref_libs = None if ref_paths is None else {
        name: ctypes.CDLL(path) for name, path in ref_paths.items()}

    def lap(phase):
        print(f"[time] phase {phase}: {time.perf_counter() - t0:.3f} s "
              "since the ranks began")

    cfg, eng, net, tree, fa, make_step, _ = build_problem(
        dev, CONFIG5_BRANCHING)
    prefix = eng.factor_step().prefix_stages
    got = mesh.pmax(torch.tensor([cfg.step_size], device=dev))
    if float(got) != float(np.float32(cfg.step_size)):
        raise SmokeFailure("the ranks tuned different step sizes")
    hyper = dict(inv_step=1.0 / cfg.step_size, step_size=cfg.step_size,
                 penalty_state=cfg.penalty_state,
                 penalty_safety=cfg.penalty_safety,
                 xs_upper=float(XS_UPPER), max_iterations=MAX_ITER)
    bs = int(cfg.lbfgs_buffer_size)
    kc1 = S.stream_constants(fa, prefix_stages=prefix,
                             max_iterations=MAX_ITER)
    run_apg = SS.make_apg_stream_sharded(mesh, fa, prefix_stages=prefix,
                                         **hyper)
    kc = run_apg.consts
    print(f"[mesh] 23: config 5 on {mesh.size} ranks sharing {dev} over "
          f"gloo; this rank's {kc['nsl']} of {kc['ns']} slots; top cross "
          f"stage s_hi {kc['s_hi']}, cross stages {kc['cross_stages']}; "
          f"K1/S1 launches over stages {kc['ranges']} (built and tuned in "
          f"{time.perf_counter() - t0:.3f} s)")
    errs = {}

    # 23. one K1a, partial parent and sharded S1 pass (both variants)
    # against the plain halves, from phase 15's stressed state
    step_hot = make_step((1.2 * net.xmax).astype(np.float32))
    ps = S.plain_iterations(kc1, step_hot, iterations=PASS_ITER, **hyper)
    sl = kc["slots"]
    stl = SS.shard_step(kc, step_hot)
    lams = kc["lams"]
    sc = torch.stack([lams[PASS_ITER - 1], lams[PASS_ITER],
                      torch.ones((), device=dev),
                      torch.tensor(PASS_SHRINKS[0], device=dev),
                      torch.tensor(PASS_SHRINKS[1], device=dev)])

    def stressed():
        st = SS.new_state(kc, stl, None, MAX_ITER)
        for k in ("xi", "psi"):
            st[f"pre_{k}"].copy_(ps["pre"][k][:, sl])
            st[f"y_{k}"].copy_(ps["y"][k][:, sl])
            st[f"z_{k}"].copy_(ps["z"][k][:, sl])
        st["sc"].copy_(sc)
        return st

    ratio = 0.0

    def held(name, got_, ref):
        nonlocal ratio
        err = check_close(name, got_, ref, PASS_FACTOR)
        ratio = max(ratio, err / max(float(ref.abs().max()), 1.0))
        errs[name] = max(errs.get(name, 0.0), err)
        return err

    st_k, st_p = stressed(), stressed()
    ext_k, par_k = SS.k1a_call(kc, stl, st_k, **hyper)
    ext_p, par_p = SS.k1a_plain(kc, stl, st_p, **hyper)
    hs = slice(kc["s_hi"], None)
    err_k1a = 0.0
    for k in ("y_xi", "y_psi", "z_xi", "z_psi", "v"):
        err_k1a = max(err_k1a, held(f"23.k1a.{k}", st_k[k][hs], st_p[k][hs]))
    err_k1a = max(err_k1a, held("23.k1a.extrema", ext_k, ext_p))
    err_k1a = max(err_k1a, held("23.k1a.parents", par_k, par_p))
    last = st_k["carry"][(len(kc["ranges"]) - 1) & 1]
    got_pp = SS.partial_parents(kc, last)
    err_pp = held("23.partial_parents", got_pp,
                  SS.partial_parents_plain(kc, last))
    if ref_libs is not None:
        with reference_kernel(ref_libs, "stream_sharded"):
            same = torch.equal(got_pp, SS.partial_parents(kc, last))
        print(f"[mesh] 23: the partial parent block on rank {mesh.rank}'s "
              f"block equal to the reference source's bit for bit: {same}")
        if not same:
            raise SmokeFailure("23: the partial parent block differs from "
                               "the reference source's")
    # one K2 pass on the block from K1a's duals and v (zero below s_hi)
    st_p["v"][:kc["s_hi"]] = 0.0
    st_2 = stressed()
    for k in ("y_xi", "y_psi", "z_xi", "z_psi", "v"):
        st_2[k].copy_(st_p[k])
    d_k = SS.k2_local(kc, stl, st_2, **hyper)
    pdu = (stl["prev_u"] - stl["prev_uhat"]).contiguous()
    x_p, u_p, pre_p, d1_p, d2_p = S.k2_plain(
        kc, st_p["v"], stl["uhat"], stl["e"], stl["x0"], pdu,
        {"xi": st_p["y_xi"], "psi": st_p["y_psi"]},
        {"xi": st_p["z_xi"], "psi": st_p["z_psi"]}, lam_i=sc[1],
        c=hyper["inv_step"], xs_upper=hyper["xs_upper"])
    err_k2 = max(held("23.k2.x", st_2["x"], x_p),
                 held("23.k2.u", st_2["u"], u_p),
                 held("23.k2.pre.xi", st_2["pre_xi"], pre_p["xi"]),
                 held("23.k2.pre.psi", st_2["pre_psi"], pre_p["psi"]),
                 held("23.k2.dsq", d_k, torch.stack([d1_p, d2_p])))
    w = torch.cat([ps["y"]["xi"], ps["y"]["psi"]], dim=-1)[:, sl].contiguous()
    err_s1 = 0.0
    for name, beta in (("solve", stl["beta"]), ("oracle", None)):
        err_s1 = max(err_s1, held(f"23.s1a.{name}",
                                  SQ.s1a_call(kc, w, mesh, beta),
                                  SQ.s1a_plain(kc, w, mesh, beta)))
    v_in = SQ.s1a_plain(kc, w, mesh, stl["beta"])
    err_s2 = 0.0
    for name, aff in (("solve", (stl["uhat"], stl["e"], stl["x0"], pdu)),
                      ("oracle", ())):
        for a, b, k in zip(SQ.s2_call(kc, v_in, *aff),
                           SQ.s2_plain(kc, v_in, *aff), ("x", "u", "pr")):
            err_s2 = max(err_s2, held(f"23.s2.{name}.{k}", a, b))
    print(f"[mesh] 23: K1a, the partial parent block, K2 and the sharded S1 "
          f"(both variants) hold their plain halves on this rank's block; "
          f"largest deviation {ratio:.6g} x max(|plain|, 1) (bound "
          f"{PASS_FACTOR:g})")
    del ps, st_k, st_p, st_2, w, v_in
    lap(23)

    # 24. the 500-iteration sharded APG solve against the single-device
    # streaming kernels' (phase 16's), a warm start, repeats
    step = make_step(cfg.current_x)
    ref = S.apg_stream(kc1, step, None, **hyper)
    out = run_apg(step)
    run_plain = None
    f64 = {}

    def witness(key, y0=None):
        nonlocal run_plain
        from rapidnet_tpu_torch.solver import apg as apg_mod
        if run_plain is None:
            run_plain = apg_mod.make_apg(prefix_stages=prefix, **hyper)
        tag = "warm" if y0 is not None else "cold"
        if tag not in f64:
            f64[tag] = run_plain(as_f64(fa), as_f64(step),
                                 None if y0 is None else as_f64(y0))
        return f64[tag][key]

    err_apg = 0.0
    for k in ("control", "u", "x", "primal_infeasibility"):
        err_apg = max(err_apg, close_or_witness(
            f"24.{k}", out[k], ref[k], lambda k=k: witness(k)))
    y0 = ref["y"]
    out_w = run_apg(step, y0)
    ref_w = S.apg_stream(kc1, step, y0, **hyper)
    for k in ("control", "u", "x"):
        close_or_witness(f"24.warm.{k}", out_w[k], ref_w[k],
                         lambda k=k: witness(k, y0))
    again = run_apg(step)
    same = outputs_equal(again, out, ("x", "u", "v", "control",
                                      "primal_infeasibility"))
    print(f"[mesh] 24: the sharded APG solve ({MAX_ITER} iterations) holds "
          f"the single-device streaming solve; warm start held; two calls "
          f"equal bit for bit: {same}")
    if not same:
        raise SmokeFailure("24: the sharded APG solve does not repeat")
    del ref, out_w, ref_w, again, f64
    lap(24)

    # 25. FBE and NAMA, f32 and bf16 history: TRACK against the
    # single-device streaming QN solve, the residual tail against its
    # solve of as many iterations, bf16 vs f32, repeats; the solves are
    # phase 27's timed samples
    def qn(algorithm, n=MAX_ITER, dtype="float32", sharded=True):
        return QS.make_qn_stream(
            fa, algorithm=algorithm, prefix_stages=prefix,
            lbfgs_buffer_size=bs, lbfgs_dtype=dtype,
            mesh=mesh if sharded else None,
            **dict(hyper, max_iterations=n))

    # two solves of ``step`` (the repeat check) and MESH_QN_REPEATS - 2
    # of perturbed states, per history storage
    staged = [step, step] + [make_step(x) for x in perturbed(
        cfg.current_x, np.random.default_rng(7), MESH_QN_REPEATS - 2)]
    qn_times, qn_peak = {}, {}
    for short, algorithm in QN_ALGORITHMS.items():
        errs[f"qn.{short}"] = tracking(
            f"25.{short}", lambda n: qn(algorithm, n)(step),
            lambda n: qn(algorithm, n, sharded=False)(step),
            QN_SHORT[short])
        single = qn(algorithm, MESH_QN_ITER, sharded=False)(step)
        runs = {}
        for dtype in ("float32", "bfloat16"):
            run = qn(algorithm, MESH_QN_ITER, dtype=dtype)
            times, outs = [], []
            torch.cuda.synchronize()
            held_b = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            for i, st in enumerate(staged):
                ms, _, o = timed(lambda: run(st))
                times.append(ms)
                if i < 2:
                    outs.append(o)
                del o
            runs[dtype] = outs
            qn_peak[(short, dtype)] = (torch.cuda.max_memory_allocated() -
                                       held_b)
            qn_times[(short, dtype)] = times
            # the dots body a sharded solve runs on this rank's block:
            # rank 0 profiles a DOTS_BODY_ITER-iteration solve
            brief = qn(algorithm, DOTS_BODY_ITER, dtype=dtype)
            if mesh.rank == 0:
                prof = stream_qn_profile(lambda: brief(step), DOTS_BODY_ITER)
                check_dots_body(f"25.{short} on rank 0's block", dtype,
                                None if prof is None else
                                prof["dots_bodies"])
            else:
                brief(step)
        k_full, again = runs["float32"]
        same = outputs_equal(again, k_full, ("x", "u", "v", "control") +
                             QN_TRACES)
        tail_k = float(np.median(
            k_full["primal_infeasibility"].abs().cpu().numpy()[-20:]))
        tail_s = float(np.median(
            single["primal_infeasibility"].abs().cpu().numpy()[-20:]))
        u0 = k_full["control"]
        dev16 = float((runs["bfloat16"][0]["control"] - u0).abs().max())
        scale = max(float(u0.abs().max()), 1.0)
        print(f"[mesh] 25.{short}: {MESH_QN_ITER} iterations: median "
              f"|infeasibility| of the last 20: sharded {tail_k:.6g}, single "
              f"device {tail_s:.6g}; two calls equal bit for "
              f"bit: {same}; bf16 history: max |control - f32's| "
              f"{dev16:.6g} ({dev16 / scale:.6g} of max(|f32|, 1); gate "
              f"1e-1)")
        if not (bool(torch.isfinite(k_full["u"]).all()) and same):
            raise SmokeFailure(f"25.{short}: non-finite or repeats differ")
        if not tail_k < 10 * max(tail_s, 1e-6):
            raise SmokeFailure(f"25.{short}: residual tail {tail_k:.6g} "
                               f"above 10 x the single-device solve's")
        if not dev16 <= 1e-1 * scale:
            raise SmokeFailure(f"25.{short}.bf16: the control strays")
        del runs, again, k_full, single
    lap(25)

    # 26. the main path: 4-step loops through SmpcController(mesh=...,
    # backend="auto") for APG, FBE and NAMA, counted; APG against the
    # single-device auto loop, each FBE/NAMA step's solve against the
    # single-device auto solve of the same step and warm start
    counts = {}

    def host(d):
        return None if d is None else {
            k: v.cpu() if torch.is_tensor(v) else v for k, v in d.items()}

    def card(d):
        return None if d is None else {
            k: v.to(dev) if torch.is_tensor(v) else v for k, v in d.items()}

    def controller(algorithm, sharded, iters):
        c = copy.deepcopy(cfg)
        c.algorithm = algorithm
        c.max_iterations = iters
        ctrl = SmpcController(c, network=net, tree=tree,
                              forecaster=forecaster(net), backend="auto",
                              device="cuda", mesh=mesh if sharded else None)
        ctrl.initialise()
        return ctrl

    def loop(algorithm, sharded, iters):
        ctrl = controller(algorithm, sharded, iters)
        solves, inputs = [], []
        solve = ctrl._solver

        def kept(step, y0):
            # host copies: the loop's leak census counts device bytes
            inputs.append((host(step), host(y0)))
            o = solve(step, y0)
            solves.append({k: o[k].cpu() for k in QN_TRACES + ("control",)
                           if k in o})
            return o

        ctrl._solver = kept
        zero_counts()
        t_0 = time.perf_counter()
        log = ctrl.closed_loop(MESH_LOOP_STEPS)
        loop_ms = (time.perf_counter() - t_0) * 1e3 / MESH_LOOP_STEPS
        n = {k: fn.launches for k, fn in wrappers().items() if fn.launches}
        controls = np.array([log[f"control{t}"]
                             for t in range(MESH_LOOP_STEPS)])
        kpis = {k: log[k] for k in KPI_KEYS}
        return (ctrl.route, controls, kpis, n, solves, inputs, loop_ms,
                log)

    for name, algorithm in (("apg", cfg.algorithm),
                            ("fbe", QN_ALGORITHMS["fbe"]),
                            ("nama", QN_ALGORITHMS["nama"])):
        iters = MAX_ITER if name == "apg" else MESH_LOOP_ITER
        route, ctl, kpis, n, solves, inputs, loop_ms, log = loop(
            algorithm, True, iters)
        if name == "apg":
            want = {k: MESH_LOOP_STEPS * iters for k in
                    ("apg_stream_sharded.k1a", "apg_stream_sharded.k2",
                     "stream_sharded.partial_parents")}
        else:
            want = mesh_qn_counts(algorithm, iters, MESH_LOOP_STEPS)
        print(f"[mesh] 26.{name}: route {route}, {MESH_LOOP_STEPS} steps "
              f"of {iters} iterations, launches {json.dumps(n)}; solve ms "
              f"per step {', '.join(f'{log[f'time{t}'][0]:.3f}' for t in range(MESH_LOOP_STEPS))}"
              f"; whole step {loop_ms:.3f} ms; kpis {json.dumps(kpis)}")
        if n != want:
            raise SmokeFailure(f"26.{name}: launches {n}, expected {want}")
        for k, v in n.items():
            counts[k] = counts.get(k, 0) + v
        if route != "stream" or not (
                np.isfinite(ctl).all() and
                np.isfinite(list(kpis.values())).all()):
            raise SmokeFailure(f"26.{name}: route {route} or non-finite "
                               "controls or KPIs")
        if "memoryLeakWarning" in log:
            raise SmokeFailure(log["memoryLeakWarning"])
        if name == "apg":
            ref_c = loop(algorithm, False, iters)[1]
            check_close("26.apg.controls", torch.as_tensor(ctl),
                        torch.as_tensor(ref_c))
            continue
        # the two loops' states part after a step (each applies its own
        # control), so every step's solve is held to the single-device
        # auto solve of the sharded loop's own step and warm start
        ref = controller(algorithm, False, iters)
        if ref.route != "stream":
            raise SmokeFailure(f"26.{name}: the single-device auto loop "
                               f"routes to {ref.route}")
        for t, (a, (st_h, y_h)) in enumerate(zip(solves, inputs)):
            st_t, y_t = card(st_h), card(y_h)
            tracking(
                f"26.{name} step {t}",
                lambda n: qn(algorithm, n)(st_t, y_t),
                lambda n: qn(algorithm, n, sharded=False)(st_t, y_t),
                QN_SHORT[name])
            b = ref._solver(st_t, y_t)
            tail_a = float(np.median(
                a["primal_infeasibility"].abs().numpy()[-20:]))
            tail_b = float(np.median(
                b["primal_infeasibility"].abs().cpu().numpy()[-20:]))
            print(f"[mesh] 26.{name} step {t}: {iters}-iteration solves, "
                  f"residual tails {tail_a:.6g} sharded / {tail_b:.6g} "
                  f"single device; max |control difference| "
                  f"{float((a['control'] - b['control'].cpu()).abs().max()):.6g}"
                  f"; this rank holds "
                  f"{torch.cuda.memory_allocated() / 2**20:.3f} MiB, "
                  f"reserves {torch.cuda.memory_reserved() / 2**20:.3f}")
            if not tail_a < 10 * max(tail_b, 1e-6):
                raise SmokeFailure(f"26.{name} step {t}: the sharded and "
                                   "single-device solves part")
            # each solver built here holds config 5's constants; free
            # them (and the card's cache: the two ranks share it) before
            # the next step's
            del b, st_t, y_t
            gc.collect()
            torch.cuda.empty_cache()
        del ref
        gc.collect()
        torch.cuda.empty_cache()

    lap(26)

    # 27. timing: APG (7 solves), QN (25's); the profile of rank 0 over
    # PROFILE_ITER iterations; per-pass kernel times; memory; bounds
    times = []
    torch.cuda.synchronize()
    held_b = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for st in [step] + [make_step(x) for x in perturbed(
            cfg.current_x, np.random.default_rng(7), REPEATS - 1)]:
        times.append(timed(lambda: run_apg(st))[0])
    apg_peak = torch.cuda.max_memory_allocated() - held_b
    med = float(np.median(times))
    print(f"[timing] sharded APG, {mesh.size} ranks on one card (gloo), "
          f"{MAX_ITER} iterations at config 5: median {med:.3f} ms of "
          f"{REPEATS} ({', '.join(f'{t:.3f}' for t in times)}), "
          f"{med * 1e3 / MAX_ITER:.3f} us per iteration; this rank's peak "
          f"{apg_peak / 2**20:.3f} MiB above the {held_b / 2**20:.3f} MiB "
          f"held")
    for (short, dtype), ts in qn_times.items():
        m = float(np.median(ts))
        print(f"[timing] sharded {short} {dtype} history, {MESH_QN_ITER} "
              f"iterations: median {m:.3f} ms of {len(ts)} "
              f"({', '.join(f'{t:.3f}' for t in ts)}), "
              f"{m * 1e3 / MESH_QN_ITER:.3f} us per iteration; this rank's peak "
              f"{qn_peak[(short, dtype)] / 2**20:.3f} MiB above what was "
              f"held")
    apg_p = SS.make_apg_stream_sharded(
        mesh, fa, prefix_stages=prefix,
        **dict(hyper, max_iterations=PROFILE_ITER))
    fbe_p = qn(QN_ALGORITHMS["fbe"], PROFILE_ITER)
    for tag, run, names in (
            ("APG", lambda: apg_p(step), ("k1_kernel", "k2_kernel",
                                          "partial_parents_kernel")),
            ("FBE", lambda: fbe_p(step), ("s1_kernel", "s2_kernel",
                                          "partial_parents_kernel",
                                          "dots", "combine"))):
        wall = timed(run)[0] / PROFILE_ITER * 1e3
        prof = mesh_profile(run, PROFILE_ITER, names) \
            if mesh.rank == 0 else None
        if mesh.rank != 0:
            run()
        if mesh.rank == 0 and prof is None:
            print(f"[timing] sharded {tag}: the profiler trace holds no "
                  "device time (not measured)")
        elif mesh.rank == 0:
            print(f"[timing] sharded {tag}, rank 0, us per iteration over a "
                  f"{PROFILE_ITER}-iteration solve: wall {wall:.3f}; device " +
                  ", ".join(f"{k} {prof[k]:.3f}" for k in
                            list(names) + ["glue"]) +
                  f"; host in the collectives {prof['collectives_host']:.3f}"
                  f"; device busy {prof['busy_ms']:.3f} of a "
                  f"{prof['span_ms']:.3f} ms span, idle share "
                  f"{prof['idle_share']:.4f}")
    # per pass on this rank's block, rank 1 idle at a barrier meanwhile
    work = shard_work(kc)
    st_t = SS.new_state(kc, SS.shard_step(kc, step), None, MAX_ITER)
    st_t["sc"].copy_(sc)
    w = torch.zeros(kc["sq"].shape + (2 * net.nx + net.nu,), device=dev)
    v_t = torch.zeros(kc["sq"].shape + (kc["iWT"].shape[0],), device=dev)
    carry = torch.empty(2, kc["nsl"], net.nx + kc["iWT"].shape[0],
                        device=dev)
    stl = SS.shard_step(kc, step)
    pdu = (stl["prev_u"] - stl["prev_uhat"]).contiguous()
    last = carry[(len(kc["ranges"]) - 1) & 1]
    sharded = "rapidnet_tpu/ops/pallas_stream_sharded.py"
    # (entry, source, TPU kernel, wrapper counted in 26, 23's error,
    #  kernel call, plain half, its work)
    rows = (
        ("apg_stream_sharded.k1a", "apg_stream.cu", f"{sharded}:264",
         "apg_stream_sharded.k1a", err_k1a,
         lambda: SS.k1a_call(kc, stl, st_t, **hyper),
         lambda: SS.k1a_plain(kc, stl, st_t, **hyper), work["k1a"]),
        ("apg_stream_sharded.k2", "apg_stream.cu", f"{sharded}:361",
         "apg_stream_sharded.k2", err_k2,
         lambda: SS.k2_local(kc, stl, st_t, **hyper),
         lambda: S.k2_plain(kc, st_t["v"], stl["uhat"], stl["e"],
                            stl["x0"], pdu,
                            {"xi": st_t["y_xi"], "psi": st_t["y_psi"]},
                            {"xi": st_t["z_xi"], "psi": st_t["z_psi"]},
                            lam_i=sc[1], c=hyper["inv_step"],
                            xs_upper=hyper["xs_upper"]), work["k2"]),
        ("stream_sharded.partial_parents", "stream_sharded.cu",
         f"{sharded}:354", "stream_sharded.partial_parents", err_pp,
         lambda: SS.partial_parents(kc, last),
         lambda: SS.partial_parents_plain(kc, last),
         work["partial_parents"]),
        ("stream_qn.s1a", "stream_qn.cu", f"{sharded}:830", "stream_qn.s1a",
         err_s1,
         lambda: SQ._launch(kc, 1, True, w=w, v=v_t, beta=stl["beta"],
                            carry=carry),
         lambda: SQ._s1_high_plain(kc, w, stl["beta"]), work["s1a"][:2]),
        ("stream_qn.s2.sharded", "stream_qn.cu", f"{sharded}:878",
         "stream_qn.s2", err_s2,
         lambda: SQ.s2_call(kc, v_t, stl["uhat"], stl["e"], stl["x0"], pdu),
         lambda: SQ.s2_plain(kc, v_t, stl["uhat"], stl["e"], stl["x0"],
                             pdu), work["s2"][:2]))
    variant = SQ.staged(*SQ.dims(kc))
    kinds = {"stream_qn.s1a": "s1", "stream_qn.s2.sharded": "s2"}
    if ref_libs is not None:
        sweeps_against_reference(mesh, kc, w, v_t, stl, pdu, rows, ref_libs)
    # one PyTorch call computes the partial parent block: x_Cp @ carry
    library = {"stream_sharded.partial_parents":
               ("x_Cp @ carry", lambda: kc["x_Cp"] @ last)}

    def calls(fn):          # n calls, each result dropped as it comes
        def run(n):
            for _ in range(n):
                fn()
        return run
    entries = []
    for key, src, line, counted, err, call, plain, (flops, nbytes) in rows:
        mesh.barrier()
        lib_ms = None
        if mesh.rank == 0:
            ms, p_ms = event_ms(call, 20), event_ms(plain, 3)
            if key in library:      # by events over MAX_ITER calls a turn
                med = in_turns(
                    f"27.{key} (these) against {library[key][0]} (the "
                    f"reference), {MAX_ITER} calls,",
                    {"reference": calls(library[key][1]),
                     "these": calls(call)}, 3,
                    clock=lambda fn: event_ms(fn, 1))
                ms, lib_ms = (med["these"] / MAX_ITER,
                              med["reference"] / MAX_ITER)
                host = timed(lambda: calls(call)(MAX_ITER))[1]
                print(f"[timing] {key}: the wrapper's host time "
                      f"{host * 1e3 / MAX_ITER:.3f} us a call (enqueue, "
                      f"{MAX_ITER} calls)")
        else:
            ms = p_ms = 0.0
        mesh.barrier()
        b_ms, by = bound_of(flops, nbytes)
        print(f"[timing] {key}: {ms:.6f} ms per pass on rank 0's block, "
              f"plain {p_ms:.6f} ms; bound {b_ms:.6f} ms ({by}: "
              f"{flops / 1e9:.4f} GFLOP, {nbytes / 1e6:.3f} MB)")
        entries.append({"name": key, "route": "cuda",
                        "source": f"rapidnet_tpu_torch/csrc/{src}",
                        "replaces": line, "launches": counts[counted],
                        "max_abs_err": err, "ms": ms, "plain_ms": p_ms,
                        "bound_ms": b_ms, "bound_by": by,
                        "library_ms": lib_ms})
        if key in kinds:
            entries[-1]["variant"] = ("staged" if variant[kinds[key]] else
                                      "unstaged")
    # the bound of one sharded solve: both ranks' blocks on the one card
    b1 = stream_bound(kc1, step, out, MAX_ITER)
    print(f"[bound] sharded APG solve, both ranks' work on one card: "
          f"{b1[0]:.6f} ms ({b1[1]}), as the single-device solve's")
    lap(27)
    return entries, counts, torch.cuda.max_memory_allocated()


def sweeps_against_reference(mesh, kc, w, v, stl, pdu, rows, ref_libs):
    """Phase 27 with ``--reference-kernel``, on every rank: the sharded
    S1 (``s1a_call``, with its all-reduce and root-side stages) and S2 on
    this rank's block, solve step and oracle, equal to the reference
    source's bit for bit; then rank 0 times the per-pass calls of
    ``rows`` (phase 27's S1 and S2 and the partial parent block on its
    block) on both sources in turns (``in_turns``; rank 1 idle)."""
    import torch
    from rapidnet_tpu_torch.ops import stream_qn as SQ
    g = torch.Generator().manual_seed(27)
    w = (w + torch.randn(w.shape, generator=g).to(w.device)).contiguous()
    v = (v + torch.randn(v.shape, generator=g).to(v.device)).contiguous()
    for label, beta, aff in (
            ("solve", stl["beta"], (stl["uhat"], stl["e"], stl["x0"], pdu)),
            ("oracle", None, ())):
        got = (SQ.s1a_call(kc, w, mesh, beta),) + SQ.s2_call(kc, v, *aff)
        with reference_kernel(ref_libs, "stream_qn"):
            ref = (SQ.s1a_call(kc, w, mesh, beta),) + SQ.s2_call(kc, v, *aff)
        same = all(torch.equal(a, b) for a, b in zip(got, ref))
        print(f"[mesh] 27.{label}: the sharded S1 and S2 on rank "
              f"{mesh.rank}'s block equal to the reference source's bit "
              f"for bit: {same}")
        if not same:
            raise SmokeFailure(f"27.{label}: the sharded S1/S2 differ from "
                               "the reference source's")
    for key, src, _, _, _, call, _, _ in rows:
        name = src[:-3]
        if name not in ref_libs:
            continue
        mesh.barrier()
        if mesh.rank == 0:
            med = in_turns(f"27.{key}, {MAX_ITER} passes on rank 0's block,",
                           source_runs(ref_libs, name, call), 1)
            print(f"[timing] {key} in turns: these "
                  f"{med['these'] / MAX_ITER:.6f} ms per pass on rank 0's "
                  f"block, the reference source's "
                  f"{med['reference'] / MAX_ITER:.6f} ms")
        mesh.barrier()


PLAIN_MESH_BRANCHING = (5, 2)   # phase 32: 10 scenarios, 5 a rank
PLAIN_MESH_TOL = 1e-3           # phase 32's APG tolerance
PLAIN_MESH_QN_ITER = 50         # phase 32's FBE budget
PLAIN_MESH_STEPS = 1            # phase 32: closed-loop steps a run takes
                                # (cut from 2: ~9 s an APG step on 2 ranks)


def card_name():
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def plain_mesh_phase(mesh):
    """Phase 32 on this rank of the two-rank mesh: the plain sharded
    solves (``parallel.make_sharded_apg``, ``make_sharded_quasi_newton``)
    through ``SmpcController(mesh=..., backend="auto")`` on the Barcelona
    network over branching PLAIN_MESH_BRANCHING: APG under
    PLAIN_MESH_TOL and FBE at PLAIN_MESH_QN_ITER iterations, each a
    PLAIN_MESH_STEPS-step loop.  The route must be 'plain' and no kernel
    launched; step 0's APG control within 1e-3 * max(|single|, 1) of the
    single-device plain solve on the card with the same stopping
    iteration, FBE held to it by 9a's TRACK rule.  Returns this rank's
    step-0 controls, for the parent to hold the ranks to each other bit
    for bit."""
    import copy

    import numpy as np
    import torch
    from rapidnet_tpu_torch.engine.engine import XS_UPPER
    from rapidnet_tpu_torch.model.config import ALGORITHM_APG
    from rapidnet_tpu_torch.parallel import (make_sharded_quasi_newton,
                                             shard_factor_arrays)
    from rapidnet_tpu_torch.solver import apg as apg_mod
    from rapidnet_tpu_torch.solver import quasi_newton as qn_mod
    from rapidnet_tpu_torch.solver.controller import SmpcController

    t0 = time.perf_counter()
    dev = mesh.device
    cfg, eng, net, tree, fa, _, _ = build_problem(dev, PLAIN_MESH_BRANCHING)
    prefix = eng.factor_step().prefix_stages
    card = card_name() if mesh.rank == 0 else ""
    out = {}
    for short, algorithm, iters, tol in (
            ("apg", ALGORITHM_APG, MAX_ITER, PLAIN_MESH_TOL),
            ("fbe", QN_ALGORITHMS["fbe"], PLAIN_MESH_QN_ITER, None)):
        c = copy.deepcopy(cfg)
        c.algorithm, c.max_iterations = algorithm, iters
        ctrl = SmpcController(c, network=net, tree=tree,
                              forecaster=forecaster(net), tolerance=tol,
                              backend="auto", device=dev, mesh=mesh)
        zero_counts()
        controls = []
        for t in range(PLAIN_MESH_STEPS):
            controls.append(ctrl.control_action(t))
            if t == 0:
                first = ctrl._last
                step = ctrl.prepare_step(0)
            ctrl.move_forward_in_time()
        counts = {k: fn.launches for k, fn in wrappers().items()
                  if fn.launches}
        if ctrl.route != "plain" or counts:
            raise SmokeFailure(f"32.{short}: route {ctrl.route!r}, kernel "
                               f"launches {counts}")
        controls = np.asarray(controls)
        if not (np.isfinite(controls).all() and
                (controls >= net.umin - 1e-6).all() and
                (controls <= net.umax + 1e-6).all()):
            raise SmokeFailure(f"32.{short}: controls not finite inside the "
                               "physical bounds")
        kw = dict(prefix_stages=prefix, inv_step=1.0 / c.step_size,
                  step_size=c.step_size, penalty_state=c.penalty_state,
                  penalty_safety=c.penalty_safety,
                  xs_upper=float(XS_UPPER), max_iterations=iters,
                  tolerance=tol)
        it = int(first["iterations"])
        if short == "apg":
            single = apg_mod.make_apg(**kw)(fa, step)
            check_close("32.apg.control", first["control"],
                        single["control"])
            it_single = int(single["iterations"])
        else:
            qkw = dict(kw, algorithm=algorithm,
                       lbfgs_buffer_size=int(c.lbfgs_buffer_size))
            fa_l = shard_factor_arrays(fa, mesh)

            def sharded(n):
                return make_sharded_quasi_newton(
                    mesh, fa, step, **dict(qkw, max_iterations=n))(fa_l,
                                                                    step)

            tracking("32.fbe", sharded,
                     lambda n: qn_mod.make_solver(
                         **dict(qkw, max_iterations=n))(fa, step),
                     QN_SHORT["fbe"], label="plain_mesh")
            it_single = iters
        if it != it_single:
            raise SmokeFailure(f"32.{short}: the sharded solve stops at "
                               f"iteration {it}, the single-device one at "
                               f"{it_single}")
        ms = list(ctrl.solve_times_ms)
        print(f"[plain_mesh] 32.{short}: route plain, no kernel launched, "
              f"{it} iterations (single device {it_single}); ms per solve "
              f"{', '.join(f'{m:.3f}' for m in ms)} ({PLAIN_MESH_STEPS} "
              f"steps, 2 ranks sharing the card) on {card}")
        out[short] = {"control": controls[0], "iterations": it, "ms": ms}
        torch.cuda.synchronize()
    print(f"[time] phase 32: {time.perf_counter() - t0:.3f} s")
    return out


def mesh_rank(rank, init, results, ref_paths):
    """One rank of phases 23-27 (a process of its own): joins the gloo
    group, puts (rank, outcome) on ``results``.  Rank 1's output goes to
    /dev/null; both ranks run every phase; ``ref_paths`` as
    ``mesh_phases``'."""
    import os
    import traceback
    import torch
    if rank:
        sys.stdout = open(os.devnull, "w")
    try:
        from rapidnet_tpu_torch.parallel import distributed
        from rapidnet_tpu_torch.parallel import make_mesh
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
        distributed.initialize(backend="gloo", init_method=f"file://{init}",
                               rank=rank, world_size=MESH_RANKS)
        mesh = make_mesh(MESH_RANKS, devices=["cuda:0"] * MESH_RANKS)
        results.put((rank, mesh_phases(mesh, ref_paths) +
                     (plain_mesh_phase(mesh),)))
        mesh.barrier()
        torch.distributed.destroy_process_group()
    except BaseException:
        results.put((rank, traceback.format_exc()))


def spawn_ranks(tag, target, n, timeout, *args):
    """n processes (spawned: this one has initialised CUDA) each running
    ``target(rank, init, results, *args)``, which joins a gloo group over
    the FileStore ``init`` and puts (rank, outcome) on ``results``;
    returns the outcomes by rank.  A rank that fails, dies or is late
    fails the phases ``tag``.  Every process started is stopped."""
    import multiprocessing as mp
    import queue
    import tempfile

    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    init = f"{tmp}/store"
    procs = [ctx.Process(target=target, args=(r, init, results) + args)
             for r in range(n)]
    out = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(out) < n:
            try:
                rank, res = results.get(timeout=5)
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise SmokeFailure(f"{tag}: the ranks timed out")
                if any(not p.is_alive() and p.exitcode for p in procs):
                    raise SmokeFailure(f"{tag}: a rank died (exit codes "
                                       f"{[p.exitcode for p in procs]})")
                continue
            if isinstance(res, str):
                raise SmokeFailure(f"{tag}: rank {rank} failed:\n{res}")
            out[rank] = res
        for p in procs:
            p.join(60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    return out


def run_mesh_phases(ref_paths=None):
    """Phases 23-27: MESH_RANKS processes share card 0 over a gloo group;
    returns rank 0's entries.  ``ref_paths``: the libraries of the
    reference source's ``stream_qn.cu`` and ``stream_sharded.cu`` by
    name, which the ranks load by their paths (``--reference-kernel``),
    or None."""
    import numpy as np
    out = spawn_ranks("23-27", mesh_rank, MESH_RANKS, MESH_TIMEOUT,
                      ref_paths)
    entries, counts, peak0, plain0 = out[0]
    peak1, plain1 = out[1][2], out[1][3]
    for short in plain0:
        same = np.array_equal(plain0[short]["control"],
                              plain1[short]["control"])
        print(f"[plain_mesh] 32.{short}: the ranks' controls equal bit for "
              f"bit: {same}")
        if not same:
            raise SmokeFailure(f"32.{short}: the ranks' controls differ")
    print(f"[memory] sharded solves: peak {peak0 / 2**20:.3f} MiB on rank 0, "
          f"{peak1 / 2**20:.3f} MiB on rank 1 (each process's own "
          "allocator)")
    if out[1][1] != counts:
        raise SmokeFailure(f"26: the ranks' counts differ: {counts} and "
                           f"{out[1][1]}")
    return entries


MESH2D_RANKS = 4          # phase 34: four ranks share card 0 over gloo
MESH2D_TIMEOUT = 900      # s the parent waits for phase 34's ranks
MESH2D_BRANCHING = (2, 2)  # 34b, 34d: the Barcelona network over 4
                           # scenarios, 2 a scenario column
MESH2D_BATCH = 4          # 34b: instances, 2 a batch row
MESH2D_STEPS = 2          # 34b: closed-loop steps
MESH2D_ITER = {"apg": 50, "fbe": 10}   # 34b: iterations a step (34d: APG's);
                          # FBE inside the ~13 iterations over which two
                          # float32 FBE solves of the Barcelona network
                          # track (ROADMAP.md queue 3)
MESH2D_FACTOR = 2e-4      # 34b: rtol and atol against the single-device
                          # loop (the JAX package's, tests/test_batch.py:189)
MULTICHIP_ARGV = ["--devices", "4", "--iterations", "40"]
# phase 34a's launches by the JSON entry they are reported in
DRYRUN_ENTRIES = {"apg_stream_sharded.k1a": "apg_stream_sharded.k1a",
                  "apg_stream_sharded.k2": "apg_stream_sharded.k2",
                  "stream_sharded.partial_parents":
                      "stream_sharded.partial_parents",
                  "stream_qn.s1a": "stream_qn.s1a",
                  "stream_qn.s2.sharded": "stream_qn.s2"}


def dryrun_counts():
    """The wrapper calls of ``dryrun_multichip``'s sharded streaming
    solves, as phases 23-27 count them: a K1a, a K2 and a partial parent
    block an APG iteration, and ``mesh_qn_counts`` of the FBE solve."""
    from rapidnet_tpu_torch.examples import dryrun
    want = mesh_qn_counts(QN_ALGORITHMS["fbe"], dryrun.QN_ITERATIONS)
    for k in ("apg_stream_sharded.k1a", "apg_stream_sharded.k2",
              "stream_sharded.partial_parents"):
        want[k] = want.get(k, 0) + dryrun.APG_ITERATIONS
    return want


def mesh_2d_phase(devices, directory):
    """Phase 34 on this rank of MESH2D_RANKS (module docstring, 34a-d);
    ``devices``: every rank's card; ``directory``: where 34d's rows write
    their checkpoints.  Returns this rank's controls and 34a's counts,
    for the parent to hold the ranks to each other."""
    import numpy as np
    from rapidnet_tpu_torch.examples import dryrun, multichip_sharded
    from rapidnet_tpu_torch.model.config import ALGORITHM_APG
    from rapidnet_tpu_torch.parallel import make_mesh_2d
    from rapidnet_tpu_torch.solver.batch import BatchedSmpcController
    from rapidnet_tpu_torch.solver.controller import SmpcController

    t_phase = time.perf_counter()
    card = card_name()

    def launched():
        return {k: fn.launches for k, fn in wrappers().items()
                if fn.launches}

    # 34a. the dry run, its sharded streaming solves counted
    zero_counts()
    t0 = time.perf_counter()
    dry = dryrun.dryrun_multichip(MESH2D_RANKS, devices=devices)
    counts = check_counts("34a", dryrun_counts())
    print(f"[mesh2d] 34a: dryrun_multichip({MESH2D_RANKS}) passed in "
          f"{time.perf_counter() - t0:.3f} s (4 ranks sharing the card); "
          f"launches {json.dumps(counts)}; 2-D controls "
          f"{dry['batch_control'].shape}")
    out = {"counts": counts, "dryrun": dry}

    # 34b. BatchedSmpcController on the 2-D mesh against the single-device
    # plain batched loop
    m2 = make_mesh_2d(2, 2, devices=devices)
    dev = m2.device
    cfg, _, net, tree, _, _, _ = build_problem(dev, MESH2D_BRANCHING)
    x0s = perturbed(cfg.current_x, np.random.default_rng(7), MESH2D_BATCH)
    for short, algorithm in (("apg", ALGORITHM_APG),
                             ("fbe", QN_ALGORITHMS["fbe"])):
        c = copy.deepcopy(cfg)
        c.algorithm, c.max_iterations = algorithm, MESH2D_ITER[short]

        def batched(**kw):
            return BatchedSmpcController(c, net, tree, forecaster(net), x0s,
                                         device=dev, **kw)
        ctrl = batched(mesh=m2)
        zero_counts()
        log = ctrl.closed_loop(MESH2D_STEPS)
        if ctrl.route != "plain" or launched():
            raise SmokeFailure(f"34b.{short}: route {ctrl.route!r}, kernel "
                               f"launches {launched()}")
        controls = log["controls"]
        if not np.isfinite(controls).all():
            raise SmokeFailure(f"34b.{short}: controls not finite")
        if m2.rank == 0:
            ref = batched(backend="torch").closed_loop(MESH2D_STEPS)
            err = float(np.abs(controls - ref["controls"]).max())
            ok = np.allclose(controls, ref["controls"], rtol=MESH2D_FACTOR,
                             atol=MESH2D_FACTOR)
            ms = log["solve_times_ms"]
            print(f"[mesh2d] 34b.{short}: route plain, no kernel launched, "
                  f"{MESH2D_STEPS} steps of B = {MESH2D_BATCH} at "
                  f"{c.max_iterations} iterations on a (2, 2) mesh; max "
                  f"|controls - single-device| {err:.4g} (rtol and atol "
                  f"{MESH2D_FACTOR}): {ok}; ms per step "
                  f"{', '.join(f'{m:.3f}' for m in ms)} (single device "
                  f"{', '.join(f'{m:.3f}' for m in ref['solve_times_ms'])})"
                  f" on {card}")
            if not ok:
                raise SmokeFailure(f"34b.{short}: the 2-D loop's controls "
                                   f"differ from the single-device loop's "
                                   f"by {err}")
        out[short] = controls

    # 34c. the multichip example on the 4 ranks
    zero_counts()
    t0 = time.perf_counter()
    got = multichip_sharded.main(["--device", "cuda"] + MULTICHIP_ARGV)
    if launched() or not np.isfinite(got["control"]).all():
        raise SmokeFailure(f"34c: kernel launches {launched()} or controls "
                           "not finite")
    print(f"[mesh2d] 34c: multichip_sharded {' '.join(MULTICHIP_ARGV)}: "
          f"finite controls, no kernel, {time.perf_counter() - t0:.3f} s")
    out["multichip"] = got["control"]

    # 34d. a warm resume on the 1-D mesh of this rank's row
    c = copy.deepcopy(cfg)
    c.algorithm, c.max_iterations = ALGORITHM_APG, MESH2D_ITER["apg"]
    warm_resume("34d", "plain", lambda: SmpcController(
        c, network=net, tree=tree, forecaster=forecaster(net), device=dev,
        warm_start=True, mesh=m2.scen),
        f"{directory}/row{m2.batch.rank}")
    print(f"[time] phase 34: {time.perf_counter() - t_phase:.3f} s on "
          f"rank {m2.rank}")
    return out


def mesh_2d_rank(rank, init, results, directory):
    """One rank of phase 34 (a process of its own): LOCAL_RANK 0, so that
    every rank's default card is card 0; joins the gloo group; puts
    (rank, outcome) on ``results``.  Rank 0 alone prints."""
    import os
    import traceback
    import torch
    if rank:
        sys.stdout = open(os.devnull, "w")
    try:
        os.environ["LOCAL_RANK"] = "0"
        from rapidnet_tpu_torch.parallel import distributed
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
        distributed.initialize(backend="gloo", init_method=f"file://{init}",
                               rank=rank, world_size=MESH2D_RANKS)
        results.put((rank, mesh_2d_phase(["cuda:0"] * MESH2D_RANKS,
                                         directory)))
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
    except BaseException:
        results.put((rank, traceback.format_exc()))


def run_mesh_2d_phase():
    """Phase 34: MESH2D_RANKS processes share card 0 over a gloo group;
    the ranks' controls must be equal bit for bit and their counts too.
    Returns 34a's launches."""
    import tempfile

    import numpy as np
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh2d_") as tmp:
        out = spawn_ranks("34", mesh_2d_rank, MESH2D_RANKS, MESH2D_TIMEOUT,
                          tmp)
    first = out[0]
    for rank in range(1, MESH2D_RANKS):
        other = out[rank]
        same = (other["counts"] == first["counts"] and all(
            np.array_equal(other[k], first[k])
            for k in ("apg", "fbe", "multichip")) and all(
            np.array_equal(other["dryrun"][k], first["dryrun"][k])
            for k in first["dryrun"]))
        if not same:
            raise SmokeFailure(f"34: rank {rank}'s controls or counts differ "
                               "from rank 0's")
    print(f"[mesh2d] 34: the {MESH2D_RANKS} ranks' controls (34a-c) and "
          f"counts equal bit for bit; phase {time.perf_counter() - t0:.3f} "
          f"s with the spawn")
    return first["counts"]


def fused_streamed_bytes(kc, iterations):
    """The bytes the fused iteration streams when its state does not stay
    on chip, every tree node once per iteration: K1's stages read the
    pre-images, y, z and beta and write y', z', v and w; K2's read w,
    uhat and e and write x, u and the pre-images (v stays in shared
    memory).  ``stream_bound``'s last figure is the two kernels'."""
    from rapidnet_tpu_torch.ops import apg_stream as S
    _, _, nx, nu, nv = S._dims(kc)
    nodes = int((kc["rep"] > 0).sum())
    dual = 2 * nx + nu
    return iterations * nodes * 4 * (2 * (3 * dual + nv) + (dual + nu + nx)
                                     + (nx + nu + dual))


def fused_phases(problem, stream_plain_ms):
    """Phase 28, the fused streaming APG kernel at config 5 on phase 15's
    problem (``problem``, as ``stream_phases`` returns it);
    ``stream_plain_ms``: phase 18's time of ``apg_stream_plain``, which is
    the fused kernel's plain solve too.  Returns its JSON entry; its
    launches are counted on the main path, phase 30."""
    import re

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from rapidnet_tpu_torch.ops import apg_stream as S
    from rapidnet_tpu_torch.solver import apg as apg_mod

    cfg, net, tree, fa, make_step, kc, prefix, hyper = problem
    if not S.fused_fits(tree.N, tree.ns, net.nx, net.nu,
                        fa["invWbar"].shape[0]):
        raise SmokeFailure("28: config 5 should be within the fused "
                           "kernel's limits")
    # 28a. one fused iteration against k1_plain -> k2_plain, from phase
    # 15's stressed state and shrinks
    step_hot = make_step((1.2 * net.xmax).astype(np.float32))
    ps = S.plain_iterations(kc, step_hot, iterations=PASS_ITER, **hyper)
    lams = kc["lams"]
    sc = (lams[PASS_ITER - 1], lams[PASS_ITER], 1.0) + PASS_SHRINKS
    state = {"pre": ps["pre"], "y": ps["y"], "z": ps["z"]}
    got = S.fused_call(kc, step_hot, state, sc, **hyper)
    ref = S.fused_iteration_plain(kc, step_hot, state, sc, **hyper)
    ratio = 0.0
    for name, g, r in ([(f"{a}.{k}", got[a][k], ref[a][k])
                        for a in ("y", "z", "pre") for k in ("xi", "psi")] +
                       [(k, got[k], ref[k]) for k in
                        ("v", "champion", "x", "u", "d1sq", "d2sq")]):
        err = check_close(f"28.iteration.{name}", g, r, PASS_FACTOR)
        ratio = max(ratio, err / max(float(r.abs().max()), 1.0))
    print(f"[fused] 28: one fused iteration (one cooperative launch) holds "
          f"k1_plain -> k2_plain; largest deviation {ratio:.6g} x "
          f"max(|plain|, 1) (bound {PASS_FACTOR:g})")
    del ps, state, got, ref

    # 28b. 500 iterations against the two-kernel solve (the same stage
    # bodies in the same order: bit for bit, else within SAME_FACTOR) and
    # against the plain APG solve by phase 16's rule
    step = make_step(cfg.current_x)
    keys = ("x", "u", "v", "control", "primal_infeasibility")
    fused = S.apg_stream_fused(kc, step, None, **hyper)
    two = S.apg_stream(kc, step, None, **hyper)
    same = outputs_equal(fused, two, keys)
    print(f"[fused] 28: {MAX_ITER} iterations, one cooperative launch each "
          f"replayed from a captured graph, equal to the two-kernel solve "
          f"bit for bit: {same}")
    if not same:
        for k in keys:
            check_close(f"28.two_kernel.{k}", fused[k], two[k], SAME_FACTOR)
    run_plain = apg_mod.make_apg(prefix_stages=prefix, **hyper)
    plain = run_plain(fa, step)
    f64 = {}

    def witness():
        if "out" not in f64:
            f64["out"] = run_plain(as_f64(fa), as_f64(step))
        return f64["out"]

    errs = {k: close_or_witness(f"28.{k}", fused[k], plain[k],
                                lambda k=k: witness()[k])
            for k in ("control", "u", "x", "v", "primal_infeasibility")}
    # 28c. a warm start (phase 16 holds the two-kernel one to the plain
    # solve's), and repeats
    warm = S.apg_stream_fused(kc, step, plain["y"], **hyper)
    warm_two = S.apg_stream(kc, step, plain["y"], **hyper)
    same_w = outputs_equal(warm, warm_two, keys)
    if not same_w:
        for k in keys:
            check_close(f"28.warm.{k}", warm[k], warm_two[k], SAME_FACTOR)
    rep = outputs_equal(S.apg_stream_fused(kc, step, None, **hyper), fused,
                        keys)
    print(f"[fused] 28: held to the plain solve by phase 16's rule; a warm "
          f"start equals the two-kernel warm start bit for bit: {same_w}; "
          f"two calls equal bit for bit: {rep}")
    if not rep:
        raise SmokeFailure("28: the fused kernel does not repeat itself")
    del fused, two, plain, warm, warm_two, f64

    # 28d. the device kernels of a PROFILE_ITER-iteration solve and the
    # idle share, by the profiler
    kc_p = S.stream_constants(fa, prefix_stages=prefix,
                              max_iterations=PROFILE_ITER)
    hyper_p = dict(hyper, max_iterations=PROFILE_ITER)
    S.apg_stream_fused(kc_p, step, None, **hyper_p)
    torch.cuda.synchronize()
    # the profiler records a varying share of the graph-replayed
    # cooperative launches, some runs none of them: up to PROFILE_TRIES
    # solves are traced until one records a fused launch
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            S.apg_stream_fused(kc_p, step, None, **hyper_p)
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if str(getattr(e, "device_type", "")).endswith("CUDA")]
        kernels = {}
        for e in events:
            m = re.search(r"(\w+_kernel)[<(]", e.name)
            name = m.group(1) if m else e.name[:40]
            n, t = kernels.get(name, (0, 0.0))
            kernels[name] = (n + 1, t + e.time_range.end -
                             e.time_range.start)
        if any(k in kernels for k in ("fused_kernel", "k1_kernel",
                                      "k2_kernel")):
            break
    idle = None
    if events:
        busy, span = busy_span([(e.time_range.start, e.time_range.end)
                                for e in events])
        idle = 1.0 - busy / span
        n_fused, t_fused = kernels.get("fused_kernel", (0, 0.0))
        print(f"[fused] 28: a {PROFILE_ITER}-iteration solve's device work "
              f"as the profiler recorded it (count, total us): " +
              ", ".join(f"{k} {n} {t:.3f}"
                        for k, (n, t) in sorted(kernels.items())) +
              f"; {n_fused} of the {PROFILE_ITER} fused launches recorded, "
              f"{t_fused / max(n_fused, 1):.3f} us each; idle share "
              f"{idle:.4f} of the recorded {span / 1e3:.3f} ms")
        if not n_fused or any(k in kernels
                              for k in ("k1_kernel", "k2_kernel")):
            raise SmokeFailure(f"28: the profiled solve ran {kernels}, not "
                               "the fused kernel alone")
    else:
        print("[fused] 28: the profiler trace holds no device time (not "
              "measured)")

    # 28e. timing, the two-kernel solve in turns beside it; memory; bound
    staged = [make_step(x) for x in perturbed(
        cfg.current_x, np.random.default_rng(7), REPEATS)]
    times, twos = [], []
    for i, st in enumerate(staged):
        for fused_turn in ((True, False) if i % 2 else (False, True)):
            fn = S.apg_stream_fused if fused_turn else S.apg_stream
            ms, _, out = timed(lambda: fn(kc, st, None, **hyper))
            (times if fused_turn else twos).append(ms)
            if not bool(torch.isfinite(out["control"]).all()):
                raise SmokeFailure("28: non-finite control")
    med, med_two = float(np.median(times)), float(np.median(twos))
    torch.cuda.synchronize()
    held_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = S.apg_stream_fused(kc, step, None, **hyper)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    bound = stream_bound(kc, step, out, MAX_ITER)
    streamed = fused_streamed_bytes(kc, MAX_ITER)
    print(f"[timing] fused {MAX_ITER}-iteration solve at config 5: median "
          f"{med:.3f} ms of {REPEATS} ({', '.join(f'{t:.3f}' for t in times)})"
          f", {med * 1e3 / MAX_ITER:.3f} us per iteration; the two-kernel "
          f"solve in turns: median {med_two:.3f} ms "
          f"({', '.join(f'{t:.3f}' for t in twos)}); plain version (phase "
          f"18) {stream_plain_ms:.3f} ms")
    print(f"[memory] fused solve: peak {peak / 2**20:.3f} MiB allocated, "
          f"{(peak - held_bytes) / 2**20:.3f} MiB above the "
          f"{held_bytes / 2**20:.3f} MiB held before it")
    print(f"[bound] fused: {bound[2] / 1e9:.3f} GFLOP, {bound[3] / 1e6:.3f} "
          f"MB: {bound[0]:.6f} ms, set by {bound[1]}; its state streamed "
          f"once per iteration: {streamed / 1e9:.3f} GB, "
          f"{streamed / HBM_BYTES_PER_S * 1e3:.6f} ms (the two kernels': "
          f"{bound[5] / 1e9:.3f} GB, {bound[4]:.6f} ms)")
    return {"name": "apg_stream_fused", "route": "cuda",
            "source": "rapidnet_tpu_torch/csrc/apg_stream.cu",
            "replaces": "rapidnet_tpu/ops/pallas_stream.py:686",
            "launches": 0, "max_abs_err": errs["u"], "ms": med,
            "plain_ms": stream_plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": None}


def bf16_history_phases(cfg, fa, make_step, make_batch, hyper, prefix):
    """Phase 29, the whole-solve FBE/NAMA kernel with its L-BFGS history
    in bf16 at Barcelona scale, per algorithm.  The knob's main path is
    the wrapper factories with ``lbfgs_dtype="bfloat16"``
    (``make_qn_kernel``, ``make_qn_kernel_batch``), whose launches are
    counted; the float32 history's solves it is compared with run before
    the counts are zeroed.  Returns the JSON entries."""
    import numpy as np
    import torch
    from rapidnet_tpu_torch.ops import qn_solve as Q

    bs = int(cfg.lbfgs_buffer_size)
    kq = Q.kernel_constants(fa, prefix_stages=prefix)
    step = make_step(cfg.current_x)
    steps_b = make_batch(perturbed(cfg.current_x, np.random.default_rng(7)))
    staged = [make_step(x) for x in perturbed(
        cfg.current_x, np.random.default_rng(7), REPEATS)]
    lo, hi = fa["umin_phys"], fa["umax_phys"]
    entries = []
    for short, algorithm in QN_ALGORITHMS.items():
        qkw = dict(hyper, algorithm=algorithm, lbfgs_buffer_size=bs)

        def f32(n=MAX_ITER, st=step):
            return Q.qn_solve(kq, st, None, **dict(qkw, max_iterations=n))

        run_1 = Q.make_qn_kernel(fa, prefix_stages=prefix,
                                 lbfgs_dtype="bfloat16", **qkw)

        def kern(n=MAX_ITER, st=step):
            if n == MAX_ITER:
                return run_1(st)
            return Q.make_qn_kernel(fa, prefix_stages=prefix,
                                    lbfgs_dtype="bfloat16",
                                    **dict(qkw, max_iterations=n))(st)

        def plain(n):
            return Q.qn_solve_plain(kq, step, None, **dict(
                qkw, max_iterations=n, lbfgs_dtype="bfloat16"))

        f32_1, f32_full = f32(1), f32()
        zero_counts()
        # 29a. the first iteration uses no history
        one = kern(1)
        equal1 = bool(torch.equal(one["primal_infeasibility"],
                                  f32_1["primal_infeasibility"]))
        check_allclose(f"29.{short}.first", one["primal_infeasibility"],
                       f32_1["primal_infeasibility"], 1e-6, 0.0)
        print(f"[bf16] 29.{short}: the first iteration equals the float32 "
              f"history's bit for bit: {equal1}")
        # 29b. TRACK against the plain version with the same bf16 round
        # trip
        err_u = tracking(f"29.{short}", kern, plain, QN_SHORT[short],
                         label="bf16")
        plain_ms = timed(lambda: plain(QN_TRACK_MAX))[0]
        # 29c. 500 iterations: against the float32 history (the JAX
        # test's bound), the tail, the bounds, repeats
        full, again = kern(), kern()
        same = all(torch.equal(again[k], full[k]) for k in
                   ("x", "u", "iterations", "line_search_trials",
                    "lbfgs_skips") + QN_TRACES) and all(
            torch.equal(again["y"][k], full["y"][k]) for k in ("xi", "psi"))
        a, b = f32_full["control"], full["control"]
        dev = float((b - a).abs().max()) / max(float(a.abs().max()), 1.0)
        tail = {n: float(np.median(o["primal_infeasibility"].abs().cpu()
                                   .numpy()[-20:]))
                for n, o in (("bf16", full), ("f32", f32_full))}
        inside = bool(((b >= lo - 1e-5) & (b <= hi + 1e-5)).all())
        print(f"[bf16] 29.{short}: {MAX_ITER} iterations: control within "
              f"{dev:.6g} x max(|f32|, 1) of the float32 history's (bound "
              f"0.1); median |infeasibility| of the last 20: bf16 "
              f"{tail['bf16']:.6g}, f32 {tail['f32']:.6g}; control within "
              f"the physical bounds: {inside}; two calls equal bit for "
              f"bit: {same}; line-search trials "
              f"{int(full['line_search_trials'])} (f32 "
              f"{int(f32_full['line_search_trials'])})")
        if not (dev < 0.1 and inside and same and
                tail["bf16"] < 10 * max(tail["f32"], 1e-6)):
            raise SmokeFailure(f"29.{short}: the bf16 history's solve fails "
                               f"a check above")
        # 29d. B = 32: instance 0 against the single solve (phase 12a's
        # rule)
        run_b = Q.make_qn_kernel_batch(fa, prefix_stages=prefix,
                                       lbfgs_dtype="bfloat16", **qkw)
        out_b = run_b(steps_b)
        _, eq = compare_instances(f"29.{short}.B={BATCH}", out_b,
                                  [kern(st=instance(steps_b, 0))], QN_KEYS,
                                  QN_INT_KEYS)
        print(f"[bf16] 29.{short}: instance 0 of a B = {BATCH} call equals "
              f"the single solve bit for bit: {eq}")
        counts = {k: fn.launches for k, fn in wrappers().items()
                  if fn.launches}
        if set(counts) != {"qn_solve", "qn_solve_batch"}:
            raise SmokeFailure(f"29.{short}: the main path launched "
                               f"{counts}")
        n_main = sum(counts.values())
        # 29e. timing: single solves in turns with the float32 history,
        # then B = 32; peak memory of one solve of each
        times = {"bf16": [], "f32": []}
        for i, st in enumerate(staged):
            for dt in (("bf16", "f32") if i % 2 else ("f32", "bf16")):
                fn = (lambda st=st: kern(st=st)) if dt == "bf16" else \
                    (lambda st=st: f32(st=st))
                times[dt].append(timed(fn)[0])
        med = {k: float(np.median(v)) for k, v in times.items()}
        peak = {}
        for dt, fn in (("bf16", kern), ("f32", f32)):
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
            peak[dt] = (torch.cuda.max_memory_allocated() - held) / 2**20
        med_b, _, _ = batch_timing(f"29.{short} bf16 history", run_b,
                                   lambda: steps_b)
        bound = qn_solve_bound(kq, step, full, algorithm, prefix)
        D = sum(full["y"][k].numel() for k in ("xi", "psi"))
        hist = {dt: 2 * (bs + 1) * D * size
                for dt, size in (("f32", 4), ("bf16", 2))}
        print(f"[timing] 29.{short} single {MAX_ITER}-iteration solves in "
              f"turns: bf16 history median {med['bf16']:.3f} ms "
              f"({', '.join(f'{t:.3f}' for t in times['bf16'])}), float32 "
              f"{med['f32']:.3f} ms "
              f"({', '.join(f'{t:.3f}' for t in times['f32'])}); B = "
              f"{BATCH} bf16 {med_b:.3f} ms ({BATCH * 1e3 / med_b:.3f} "
              f"solves/s); plain bf16 version {plain_ms:.3f} ms over "
              f"{QN_TRACK_MAX} iterations")
        print(f"[memory] 29.{short} single solve above what was held: bf16 "
              f"{peak['bf16']:.3f} MiB, f32 {peak['f32']:.3f} MiB; the "
              f"history {hist['bf16'] / 2**20:.3f} MiB against "
              f"{hist['f32'] / 2**20:.3f} MiB")
        print(f"[bound] 29.{short}: {bound[2] / 1e9:.3f} GFLOP, "
              f"{bound[3] / 1e6:.3f} MB: {bound[0]:.6f} ms, set by "
              f"{bound[1]} (the history is the kernel's own state, not an "
              f"input or output)")
        entries.append(
            {"name": f"qn_solve_bf16_{short}", "route": "cuda",
             "source": "rapidnet_tpu_torch/csrc/qn_solve.cu",
             "replaces": "rapidnet_tpu/ops/pallas_qn.py:94",
             "launches": n_main, "max_abs_err": err_u, "ms": med["bf16"],
             "plain_ms": plain_ms, "plain_iterations": QN_TRACK_MAX,
             "bound_ms": bound[0], "bound_by": bound[1],
             "library_ms": None})
    return entries


LADDER_OUT = "ladder_out/LADDER_chip_smoke.json"
# the wrapper each ladder row must launch (bench_ladder.solver's routes;
# the bf16z row runs the plain solve)
LADDER_WRAPPERS = {
    "1_toy_deterministic_H8": "apg_solve",
    "2_binary_tree_H12": "apg_solve",
    "3_barcelona_subset_100node_H24": "apg_solve",
    "4_barcelona_556node_H24": "apg_solve",
    "4_barcelona_556node_H24_batch16": "apg_solve_batch",
    "5_1024scenario_H24": "apg_stream",
    "5_1024scenario_H24_bf16z": None,
    "5_1024scenario_H24_stream": "apg_stream",
    "5_1024scenario_H24_shardmap_1dev": None,
    "5_1024scenario_H24_stream_fused": "apg_stream_fused",
    "5h_512scenario_H24_stream_halfwidth": "apg_stream",
    "5h_512scenario_H24_fbe_stream_halfwidth": "stream_qn.s1",
}


def ladder_phase():
    """Phase 30, the main path of this slice: the port's config ladder
    (``python -m rapidnet_tpu_torch.bench_ladder --repeats 2``), every
    launch count zeroed just before it.  Every row must run without an
    error and launch its route's wrapper (the fused row the fused
    kernel).  Returns the wrappers' counts."""
    from rapidnet_tpu_torch import bench_ladder as L

    zero_counts()
    rc = L.main(["--repeats", "2", "--out", LADDER_OUT])
    counts = {k: fn.launches for k, fn in wrappers().items() if fn.launches}
    doc = json.loads(Path(LADDER_OUT).read_text())
    rows = {r["config"]: r for r in doc["rows"]}
    print(json.dumps({"ladder": doc}))
    print(f"[ladder] 30: exit {rc}, {len(rows)} rows on {doc['device']}; "
          f"the wrappers' launches {json.dumps(counts)}")
    if rc != 0 or set(rows) != set(LADDER_WRAPPERS):
        raise SmokeFailure(f"30: the ladder exited {rc} with rows "
                           f"{sorted(rows)}")
    for name, wrapper in LADDER_WRAPPERS.items():
        row = rows[name]
        launched = row["launches"]
        ok = (not launched) if wrapper is None else launched.get(wrapper, 0)
        if "error" in row or not ok:
            raise SmokeFailure(f"30: row {name}: {json.dumps(row)}")
    return counts


# phase 33: (example, its arguments, the route its controller must take,
# the wrapper it must launch once a step and no other); 2 steps each
EXAMPLE_STEPS = 2
EXAMPLES = (
    ("barcelona_scale", ["--steps", "2"], "kernel", "apg_solve"),
    ("batched_monte_carlo", ["--batch", "8", "--steps", "2"], "kernel",
     "apg_solve_batch"),
    ("large_tree_streaming", [], "stream", "apg_stream"),
    ("epanet_to_controller", [], "kernel", "apg_solve"),
)


def examples_phase():
    """Phase 33: the single-device examples on the card, in process
    through their ``main`` (what ``python -m
    rapidnet_tpu_torch.examples.<name>`` runs) with ``--device cuda``,
    every count zeroed just before each: each takes its route and
    launches its wrapper once a step and no other, with finite controls
    inside the physical bounds and finite KPIs; ``epanet_to_controller``
    writes into a temporary directory.  Returns the launches by wrapper
    name, all examples together."""
    import importlib
    import tempfile

    import numpy as np

    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as tmp:
        for name, argv, route, wrapper in EXAMPLES:
            if name == "epanet_to_controller":
                argv = argv + ["--out", str(Path(tmp) / "dwn")]
            mod = importlib.import_module(
                f"rapidnet_tpu_torch.examples.{name}")
            zero_counts()
            t0 = time.perf_counter()
            got = mod.main(argv + ["--device", "cuda"])
            wall = time.perf_counter() - t0
            n = count_launches(f"33.{name}", wrapper, EXAMPLE_STEPS)
            launches[wrapper] = launches.get(wrapper, 0) + n
            net = got["network"]
            u = np.asarray(got["controls"])
            kpi = np.asarray([np.asarray(v, np.float64)
                              for v in got["kpis"].values()])
            ok = (got["route"] == route and np.isfinite(u).all() and
                  (u >= net.umin - 1e-6).all() and
                  (u <= net.umax + 1e-6).all() and np.isfinite(kpi).all())
            print(f"[examples] 33.{name}: route {got['route']}, {n} "
                  f"{wrapper} launches for {EXAMPLE_STEPS} steps, controls "
                  f"{tuple(u.shape)} finite inside the physical bounds and "
                  f"finite KPIs: {ok}; wall {wall:.3f} s")
            if not ok:
                raise SmokeFailure(f"33.{name}: route {got['route']} "
                                   f"(expected {route}), or controls or "
                                   "KPIs out of bounds")
    return launches


CLI_STEPS = 2         # phase 31: closed-loop steps a CLI run takes
KPI_LINES = ("economic kpi", "smooth kpi", "safety kpi",
             "network utility kpi")
# csrc/apg_solve.cu's kernels whose names no other source uses
APG_SOLVE_KERNELS = ("backward_tail_kernel", "backward_prefix_kernel",
                     "forward_prox_kernel", "finish_iteration_kernel")


def run_cli(tag, config, out, name, net, profile_dir=None):
    """``rapidnet_tpu_torch.cli.main``, the function ``python -m
    rapidnet_tpu_torch.cli`` runs, on ``config`` for CLI_STEPS steps on
    the card, in this process, every wrapper's count zeroed just before
    it: (the output JSON, the per-step 'time lapsed' ms, the run's wall
    s, the launches of wrapper ``name``).  It must return 0, print the
    four KPI lines and finite KPIs, launch ``name`` once a step and no
    other wrapper, and write finite controls of width nu inside the
    physical bounds."""
    import io
    import math

    import numpy as np

    from rapidnet_tpu_torch import cli
    argv = ["--config", str(config), "--steps", str(CLI_STEPS), "--device",
            "cuda", "--output", str(out)]
    if profile_dir is not None:
        argv += ["--profile-dir", str(profile_dir)]
    stdout, stderr = io.StringIO(), io.StringIO()
    zero_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(stdout), \
                contextlib.redirect_stderr(stderr):
            rc = cli.main(argv)
    except Exception as exc:
        raise SmokeFailure(f"{tag}: the CLI raised {exc!r}:\n"
                           f"{stderr.getvalue()[-3000:]}") from exc
    wall = time.perf_counter() - t0
    launches = count_launches(tag, name, CLI_STEPS)
    if rc != 0:
        raise SmokeFailure(f"{tag}: the CLI returned {rc}:\n"
                           f"{stderr.getvalue()[-3000:]}")
    missing = [k for k in KPI_LINES if k not in stdout.getvalue()]
    ms = [float(line.split()[2]) for line in stderr.getvalue().splitlines()
          if line.startswith("time lapsed")]
    if missing or len(ms) != CLI_STEPS:
        raise SmokeFailure(f"{tag}: the CLI printed no {missing} or "
                           f"{len(ms)} step times:\n{stdout.getvalue()}\n"
                           f"{stderr.getvalue()[-3000:]}")
    log = json.loads(Path(out).read_text())
    for t in range(CLI_STEPS):
        u = np.asarray(log[f"control{t}"], np.float32)
        if not (u.shape == (net.nu,) and np.isfinite(u).all()
                and (u >= net.umin - 1e-5).all()
                and (u <= net.umax + 1e-5).all()):
            raise SmokeFailure(f"{tag}: control{t} is not a finite "
                               f"control of width {net.nu} inside the "
                               f"physical bounds")
    if not all(math.isfinite(log[k]) for k in KPI_KEYS):
        raise SmokeFailure(f"{tag}: KPIs {[log[k] for k in KPI_KEYS]}")
    return log, ms, wall, launches


def read_back(tag, paths, cfg, eng, net, tree):
    """The exported files read back by the port's readers equal the
    objects bit for bit."""
    import numpy as np
    from rapidnet_tpu_torch import DwnNetwork, ScenarioTree, SmpcConfig
    from rapidnet_tpu_torch.model.forecaster import JsonForecaster

    def same(what, a, b):
        a, b = np.asarray(a), np.asarray(b)
        if a.shape != b.shape or not np.array_equal(a, b):
            raise SmokeFailure(f"{tag}: {what} read back differs")

    net2 = DwnNetwork.from_json(paths["network"])
    for k in ("matA", "matB", "matGd", "matE", "matEd", "xmin", "xmax",
              "xsafe", "umin", "umax", "alpha1"):
        same(f"network.{k}", getattr(net2, k), getattr(net, k))
    tree2 = ScenarioTree.from_json(paths["tree"])
    for k in ("stage", "ancestor", "leaves", "n_children", "prob",
              "err_demand", "err_price", "node_of_slot", "rep"):
        same(f"tree.{k}", getattr(tree2, k), getattr(tree, k))
    fc, fc2 = forecaster(net), JsonForecaster(paths["forecaster"])
    for t in range(fc.sim_horizon):
        for f in (fc, fc2):
            f.predict_demand(t)
            f.predict_prices(t)
        same(f"forecast.demand{t}", fc2.nominal_demand, fc.nominal_demand)
        same(f"forecast.prices{t}", fc2.nominal_prices, fc.nominal_prices)
    cfg2 = SmpcConfig.from_json(paths["config"])
    same("config.mat_l", cfg2.mat_l, eng.L)
    same("config.mat_lhat", cfg2.mat_lhat, eng.Lhat)
    for k in ("cost_w", "diag_precnd", "current_x", "prev_u", "prev_demand",
              "step_size", "max_iterations", "penalty_state",
              "penalty_safety", "nx", "nu", "nd", "nv", "N"):
        same(f"config.{k}", getattr(cfg2, k), getattr(cfg, k))
    if cfg2.algorithm != cfg.algorithm:
        raise SmokeFailure(f"{tag}: config.algorithm read back differs")


RESUME_STREAM_ITER = 20    # phase 31d: iterations a step on the streaming
                           # route at config 5


def warm_resume(tag, route, build, path):
    """A warm controller (``build()``) on ``route``: step 0, a checkpoint
    after it, step 1; a fresh controller resumed from the file runs step
    1: its control and duals must equal the uninterrupted run's bit for
    bit.  On a mesh only its rank 0 reads the file: the other ranks pass
    a path with no file there.  Returns the line for the phase's
    report."""
    import numpy as np
    import torch
    from rapidnet_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                     save_checkpoint)
    a = build()
    a.control_action(0)
    a.move_forward_in_time()
    save_checkpoint(a, path, sim_time=1)
    t0 = time.perf_counter()
    u_ref = a.control_action(1)
    ms = (time.perf_counter() - t0) * 1e3
    b = build()
    here = path if b.mesh is None or b.mesh.rank == 0 else path + "_elsewhere"
    u = b.control_action(load_checkpoint(b, here))
    same = (np.array_equal(u, u_ref) and all(
        torch.equal(b._last["y"][k], a._last["y"][k]) for k in ("xi", "psi")))
    print(f"[resume] {tag}: route {a.route}, step 1 resumed from the "
          f"checkpoint equals the uninterrupted warm loop's (control and "
          f"duals) bit for bit: {same}; step 1 {ms:.3f} ms")
    if a.route != route or b.route != route or not same:
        raise SmokeFailure(f"{tag}: route {a.route}/{b.route} (expected "
                           f"{route}), or the resumed step differs by "
                           f"{np.abs(u - u_ref).max()}")
    return f"{tag} resume bit for bit ({route})"


def cli_phase(cfg, eng, net, tree, problem5):
    """Phase 31: the closed-loop CLI on the card, on a problem directory
    the port writes (phase 2's Barcelona-scale objects): the files read
    back bit for bit; ``rapidnet_tpu_torch.cli.main`` for 2 APG steps
    with ``--profile-dir`` and 2 FBE steps, each launching its
    whole-solve kernel once a step in its own run (counts zeroed just
    before it); the trace names a kernel of ``csrc/apg_solve.cu``; step 0
    of an in-process warm controller equal to the APG CLI's, and its
    checkpoint resume bit for bit with the uninterrupted warm loop.
    Returns the CLI runs' launches by the name of the kernel's JSON
    entry."""
    import tempfile

    import numpy as np

    from rapidnet_tpu_torch.io.writers import config_to_json, export_problem
    from rapidnet_tpu_torch.model.config import (ALGORITHM_APG, ALGORITHM_FBE,
                                                 ALGORITHM_NAMA)
    from rapidnet_tpu_torch.solver.controller import SmpcController
    from rapidnet_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                     save_checkpoint)

    t_phase = time.perf_counter()
    counts, report = {}, []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        tmp = Path(tmp)
        # 31a. export, read back
        paths = export_problem(net, tree, forecaster(net), cfg,
                               str(tmp / "apg"), mat_l=eng.L,
                               mat_lhat=eng.Lhat)
        read_back("31a", paths, cfg, eng, net, tree)
        fbe = copy.deepcopy(cfg)
        fbe.algorithm = ALGORITHM_FBE
        (tmp / "fbe").mkdir()
        fbe_config = str(tmp / "fbe" / "controllerConfig.json")
        config_to_json(fbe, fbe_config, network_path=paths["network"],
                       tree_path=paths["tree"],
                       forecaster_path=paths["forecaster"], mat_l=eng.L,
                       mat_lhat=eng.Lhat)
        print(f"[cli] 31a: {', '.join(sorted(paths))} written to "
              f"{tmp / 'apg'} and read back bit for bit; the FBE config "
              f"beside them")

        # 31b-c. the CLI as a user calls it, its own launches counted
        trace_dir = tmp / "trace"
        logs = {}
        for tag, config, name, entry, profile in (
                ("31b.apg", paths["config"], "apg_solve", "apg_solve",
                 trace_dir),
                ("31c.fbe", fbe_config, "qn_solve", "qn_solve_fbe", None)):
            log, ms, wall, counts[entry] = run_cli(
                tag, config, tmp / f"{tag}.json", name, net, profile)
            logs[tag] = log
            report.append(
                f"{tag} step ms {', '.join(f'{m:.3f}' for m in ms)}, "
                f"run {wall:.3f} s")
            print(f"[cli] {tag}: exit 0, {name} launches {counts[entry]} "
                  f"in the CLI's run and no other kernel's; controls "
                  f"finite and inside the bounds; kpis "
                  f"{json.dumps({k: log[k] for k in KPI_KEYS})}")

        # the trace names a kernel of csrc/apg_solve.cu
        traces = sorted(trace_dir.glob("*.json"))
        seen = set()
        for p in traces:
            for e in json.loads(p.read_text()).get("traceEvents", []):
                if e.get("cat") == "kernel":
                    seen.update(k for k in APG_SOLVE_KERNELS
                                if k in e.get("name", ""))
        print(f"[cli] 31b: {len(traces)} trace file(s), "
              f"{sum(p.stat().st_size for p in traces) / 2**20:.3f} MiB; "
              f"apg_solve.cu kernels named: {sorted(seen)}")
        if len(traces) != 1 or not seen:
            raise SmokeFailure("31b: the profile trace names no kernel of "
                               "csrc/apg_solve.cu")

        # 31d. a warm checkpoint resume against the uninterrupted loop
        def warm():
            ctrl = SmpcController(paths["config"], device="cuda",
                                  warm_start=True)
            ctrl.initialise()
            return ctrl
        ckpt = str(tmp / "ckpt")
        a = warm()
        u0 = a.control_action(0)
        if not np.array_equal(u0, np.asarray(logs["31b.apg"]["control0"],
                                              np.float32)):
            raise SmokeFailure("31d: step 0 of an in-process controller "
                               "differs from the APG CLI's control0")
        a.move_forward_in_time()
        save_checkpoint(a, ckpt, sim_time=1)
        u_ref = a.control_action(1)
        b = warm()
        u = b.control_action(load_checkpoint(b, ckpt))
        if not np.array_equal(u, u_ref):
            raise SmokeFailure(f"31d: the resumed step differs by "
                               f"{np.abs(u - u_ref).max()}")
        print("[cli] 31d: step 0 of an in-process warm controller equals "
              "the APG CLI's control0, and step 1 resumed from its "
              "checkpoint equals the uninterrupted warm loop's, bit for "
              "bit")
        nama_config = str(tmp / "nama" / "controllerConfig.json")
        (tmp / "nama").mkdir()
        nama = copy.deepcopy(cfg)
        nama.algorithm = ALGORITHM_NAMA
        config_to_json(nama, nama_config, network_path=paths["network"],
                       tree_path=paths["tree"],
                       forecaster_path=paths["forecaster"], mat_l=eng.L,
                       mat_lhat=eng.Lhat)
        for short, config in (("fbe", fbe_config), ("nama", nama_config)):
            report.append(warm_resume(
                f"31d.{short}", "kernel",
                lambda config=config: SmpcController(
                    config, device="cuda", warm_start=True),
                str(tmp / f"ckpt_{short}")))
        cfg5, net5, tree5 = problem5[:3]
        for short, algorithm in (("apg", ALGORITHM_APG),
                                 ("fbe", QN_ALGORITHMS["fbe"]),
                                 ("nama", QN_ALGORITHMS["nama"])):
            c5 = copy.deepcopy(cfg5)
            c5.algorithm, c5.max_iterations = algorithm, RESUME_STREAM_ITER
            report.append(warm_resume(
                f"31d.stream.{short}", "stream",
                lambda c5=c5: SmpcController(
                    c5, network=net5, tree=tree5,
                    forecaster=forecaster(net5), device="cuda",
                    warm_start=True),
                str(tmp / f"ckpt_stream_{short}")))
    print(f"[cli] 31: {'; '.join(report)}; phase "
          f"{time.perf_counter() - t_phase:.3f} s")
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reference-kernel", default=None, metavar="DIR",
                    help="the csrc directory of an earlier checkout: "
                         "phases 6c, 15, 16, 19, 23 and 27 also hold the "
                         "single APG solve, one K1 and one K2 pass, the "
                         "streaming APG solve, S1/S2 (single and on a "
                         "rank's block) and the partial parent block to "
                         "its kernels bit for bit, 12a the single FBE and "
                         "NAMA solves by TRACK and tail, and phases 5, 8, "
                         "11, 14, 18, 22 and 27 time its APG solve, B = 32 "
                         "APG call, QN solves, B = 32 QN calls, streaming "
                         "solve, S1/S2, the history passes, an FBE solve "
                         "and the partial parent block in turns with this "
                         "checkout's")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    from rapidnet_tpu_torch.engine.engine import XS_UPPER
    from rapidnet_tpu_torch.ops import apg_solve as K
    from rapidnet_tpu_torch.ops import build

    # full float32 products everywhere (the JAX package's HIGHEST)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind} count {torch.cuda.device_count()}")

    # 1. build the kernels from the checkout's sources (and the reference
    # sources), one nvcc for each distinct source, all started together
    t0 = time.perf_counter()
    jobs = {build.library_path(name): (name, None) for name in KERNELS}
    if args.reference_kernel:
        for name in KERNELS:
            src = Path(args.reference_kernel) / f"{name}.cu"
            jobs.setdefault(build.library_path(name, src), (name, src))
    with ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(lambda job: build.build(*job), jobs.values()))
    libs = {name: build.build(name) for name in KERNELS}
    ref_libs = None
    if args.reference_kernel:
        ref_libs = {name: ctypes.CDLL(str(build.build(
            name, Path(args.reference_kernel) / f"{name}.cu")))
            for name in KERNELS}
    for name, so in libs.items():
        build.load(name)
        print(f"[build] {so.name} built and loaded")
        for line in so.with_suffix(".log").read_text().splitlines():
            if ("entry function" in line or "registers" in line
                    or "spill" in line):
                print(f"[build] {line.strip()}")
    print(f"[build] {len(jobs)} sources in {time.perf_counter() - t0:.3f} s")

    # 2. the Barcelona-scale problem
    t0 = time.perf_counter()
    cfg, eng, net, tree, fa, make_step, make_batch = build_problem(device)
    prefix = eng.factor_step().prefix_stages
    hyper = dict(inv_step=1.0 / cfg.step_size, step_size=cfg.step_size,
                 penalty_state=cfg.penalty_state,
                 penalty_safety=cfg.penalty_safety,
                 xs_upper=float(XS_UPPER), max_iterations=MAX_ITER)
    kc = K.kernel_constants(fa, prefix_stages=prefix,
                            max_iterations=MAX_ITER)
    print(f"[problem] nx {net.nx} nu {net.nu} nd {net.nd} ne {net.ne} "
          f"N {tree.N} nodes {tree.n_nodes} scenarios {tree.ns} "
          f"prefix_stages {prefix} step_size {cfg.step_size:.6g} "
          f"(tuned in {time.perf_counter() - t0:.3f} s)")

    t_run = time.perf_counter()

    def lap(phases):
        print(f"[time] phases {phases}: {time.perf_counter() - t_run:.3f} s "
              f"since phase 3")

    entries, apg_kpis = apg_phases(ref_libs, device, cfg, net, tree, fa,
                                   make_step, make_batch, prefix, hyper, kc)
    lap("3-8")
    qn_entries, tols = qn_phases(ref_libs, cfg, net, tree, fa, make_step,
                                  hyper, prefix, apg_kpis)
    entries += qn_entries
    lap("9-11")
    entries += qn_batch_phases(ref_libs, cfg, net, tree, fa, make_batch,
                               hyper, prefix, tols)
    lap("12-14")
    step_b = make_step(cfg.current_x)
    entry, problem5 = stream_phases(ref_libs, device, kc, step_b, hyper)
    entries.append(entry)
    stream_plain_ms = entry["plain_ms"]
    lap("15-18")
    from rapidnet_tpu_torch.ops import qn_solve as Q
    entries += stream_qn_phases(ref_libs, device, problem5,
                                Q.kernel_constants(fa, prefix_stages=prefix),
                                kc, step_b, hyper)
    lap("19-22")
    entries += run_mesh_phases(None if ref_libs is None else {
        name: ref_libs[name]._name for name in ("stream_qn",
                                                "stream_sharded")})
    lap("23-27")
    fused = fused_phases(problem5, stream_plain_ms)
    lap("28")
    entries += bf16_history_phases(cfg, fa, make_step, make_batch, hyper,
                                   prefix)
    lap("29")
    fused["launches"] = ladder_phase().get("apg_stream_fused", 0)
    entries.append(fused)
    lap("30")
    cli = cli_phase(cfg, eng, net, tree, problem5)
    for e in entries:
        if e["name"] in cli:
            e["cli_launches"] = cli[e["name"]]
    lap("31")
    examples = examples_phase()
    for e in entries:
        if e["name"] in examples:
            e["example_launches"] = examples[e["name"]]
    lap("33")
    dry = run_mesh_2d_phase()
    for e in entries:
        if e["name"] in DRYRUN_ENTRIES:
            e["dryrun_launches"] = dry[DRYRUN_ENTRIES[e["name"]]]
    lap("34")

    print(card_name())
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
