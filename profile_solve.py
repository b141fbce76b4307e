#!/usr/bin/env python3
"""Where the time of one solve kernel call goes, on one GPU.

    python3 profile_solve.py [--algorithm apg|fbe|nama] [--iterations 500]
                             [--batch B] [--stream [--branching 8,8,4,4]]
                             [--spans] [--sweep] [--lbfgs-dtype D]
                             [--out profile_out]

Builds the Barcelona-scale problem of ``chip_smoke.py``, warms the
algorithm's whole-solve kernel up (APG: ``csrc/apg_solve.cu``; FBE and
NAMA: ``csrc/qn_solve.cu`` with the config's L-BFGS buffer of 5), then
prints, for one solve or, with ``--batch B``, one batched call of B
solves (states x0 * (1 + 0.02 N(0, 1)), numpy seed 7, assembled on the
device from the shared base), or, with ``--stream``, one solve of the
streaming path at BASELINE config 5 (the same widths over branching
[8, 8, 4, 4]: 1024 scenarios, or over ``--branching``): APG through
``csrc/apg_stream.cu``, FBE and NAMA through ``solver/qn_stream.py``
(the sweeps of ``csrc/stream_qn.cu``, the history passes of
``csrc/lbfgs.cu`` with the history in ``--lbfgs-dtype``, float32 or
bfloat16, and the PyTorch glue between them):

* the CUDA-event time of one call and the host's time to enqueue it;
* per phase kernel, its launches and its device µs per iteration
  (``torch.profiler``; PyTorch's own kernels, the streaming FBE/NAMA
  solve's glue, by their base names, and their sum as ``glue``);
* the device's busy time over the span of the traced solve, and the
  idle share;
* the card's name, power limit and SM clock;
* with ``--stream --spans`` (APG), where a block's stage spends its time:
  one K1 and one K2 pass of ``csrc/apg_stream.cu``'s instrumented build
  (``apg_stream.stage_spans``, from the state after two plain
  iterations), the SM cycles of each part per block and stage (the
  launches' start and end parts per block and pass) and their µs at
  the card's maximum SM clock;
* with ``--stream --spans --algorithm fbe|nama``, the same for the
  sweeps: one S1 and one S2 pass of ``csrc/stream_qn.cu``'s instrumented
  build (``stream_qn.sweep_spans``, the solve step and the Hessian
  oracle, from the duals after two plain APG iterations);
* with ``--spans`` (APG, single or ``--batch B``), where a block of the
  whole-solve kernel spends its time: one call of ``csrc/apg_solve.cu``'s
  instrumented build (``-DAPG_SOLVE_CLOCK``, ``apg_solve.phase_spans``),
  the SM cycles of each part of a block per launch of its phase (a
  phase's start waits for the previous phase: dependent launches) and
  their µs at the card's maximum SM clock;
* with ``--sweep`` (APG whole solve), the variant the source picks
  (``apg_solve.variant``) and the event ms of one call (the batched
  entry, B = 1 without ``--batch``) in each variant of SWEEP_CLUSTERS
  (slot clusters of C CTAs, staged as the pick would stage them, and
  the one-block design: C = Cp = 1 unstaged), SWEEP_ROUNDS rounds in
  turns; every variant's outputs equal the picked one's bit for bit.

It writes the trace (``trace.json``, for chrome://tracing or Perfetto)
and these numbers (``summary.json``) under ``--out``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import sys
import time


SWEEP_CLUSTERS = (1, 2, 4, 5, 8)   # --sweep's slot cluster sizes
SWEEP_ROUNDS = 2                  # --sweep's calls of each variant

# --algorithm -> the config's algorithm name (None: APG)
ALGORITHMS = {"apg": None, "fbe": "globalFbeAlgorithm",
              "nama": "namaAlgorithm"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--algorithm", default="apg",
                    choices=sorted(ALGORITHMS))
    ap.add_argument("--iterations", type=int, default=500)
    ap.add_argument("--batch", type=int, default=0,
                    help="trace one batched call of this many solves "
                         "(0: one single solve)")
    ap.add_argument("--stream", action="store_true",
                    help="the streaming solve at BASELINE config 5")
    ap.add_argument("--branching", default=None,
                    help="--stream: the tree's branching, comma-separated "
                         "(default: config 5's, 8,8,4,4)")
    ap.add_argument("--lbfgs-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="--stream with FBE or NAMA: the L-BFGS history's "
                         "storage")
    ap.add_argument("--spans", action="store_true",
                    help="the SM cycles of each part of a block (the "
                         "instrumented build): APG, or with --stream a "
                         "K1/K2 stage's (APG) or an S1/S2 stage's (FBE, "
                         "NAMA)")
    ap.add_argument("--sweep", action="store_true",
                    help="APG whole solve: time the variants (cluster "
                         "sizes, staging) in turns")
    ap.add_argument("--out", default="profile_out")
    args = ap.parse_args()
    algorithm = ALGORITHMS[args.algorithm]
    if args.stream and args.batch:
        ap.error("--stream runs one solve")
    if args.branching is not None and not args.stream:
        ap.error("--branching shapes the streaming solve's tree")
    if args.spans and algorithm is not None and not args.stream:
        ap.error("--spans times the APG kernels, or with --stream the "
                 "streaming kernels")
    if args.sweep and (algorithm is not None or args.stream):
        ap.error("--sweep times the whole-solve APG kernel's variants")

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_solve: no CUDA GPU available", file=sys.stderr)
        return 1
    from chip_smoke import (BARCELONA_BRANCHING, CONFIG5_BRANCHING,
                            build_problem, busy_span,
                            stream_qn_part)
    from rapidnet_tpu_torch.engine.engine import XS_UPPER
    from rapidnet_tpu_torch.ops import apg_solve as K
    from rapidnet_tpu_torch.ops import apg_stream as S
    from rapidnet_tpu_torch.ops import qn_solve as Q
    from rapidnet_tpu_torch.solver.qn_stream import make_qn_stream

    n_it = args.iterations
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    device = torch.device("cuda", 0)
    branching = (tuple(int(b) for b in args.branching.split(","))
                 if args.branching else CONFIG5_BRANCHING)
    cfg, eng, net, tree, fa, make_step, make_batch = build_problem(
        device, branching if args.stream else BARCELONA_BRANCHING)
    hyper = dict(inv_step=1.0 / cfg.step_size, step_size=cfg.step_size,
                 penalty_state=cfg.penalty_state,
                 penalty_safety=cfg.penalty_safety,
                 xs_upper=float(XS_UPPER), max_iterations=n_it)
    prefix = eng.factor_step().prefix_stages
    if args.batch:
        import numpy as np
        x0 = cfg.current_x
        rng = np.random.default_rng(7)
        step = make_batch((x0 * (1.0 + 0.02 * rng.standard_normal(
            (args.batch, x0.size)))).astype(np.float32))
    else:
        step = make_step(cfg.current_x)
    if args.stream and algorithm is not None:
        kc = S.stream_constants(fa, prefix_stages=prefix,
                                max_iterations=n_it)
        qn_run = make_qn_stream(
            fa, algorithm=algorithm, consts=kc, prefix_stages=prefix,
            lbfgs_buffer_size=int(cfg.lbfgs_buffer_size),
            lbfgs_dtype=args.lbfgs_dtype, **hyper)
        kw = {}

        def run(kc, step, y0):
            return qn_run(step, y0)
    elif args.stream:
        kc = S.stream_constants(fa, prefix_stages=prefix,
                                max_iterations=n_it)
        run, kw = S.apg_stream, hyper
    elif algorithm is None:
        kc = K.kernel_constants(fa, prefix_stages=prefix,
                                max_iterations=n_it)
        run = K.apg_solve_batch if args.batch else K.apg_solve
        kw = hyper
    else:
        kc = Q.kernel_constants(fa, prefix_stages=prefix)
        run = Q.qn_solve_batch if args.batch else Q.qn_solve
        kw = dict(hyper, algorithm=algorithm,
                  lbfgs_buffer_size=int(cfg.lbfgs_buffer_size))

    def call():
        return run(kc, step, None, **kw)

    for _ in range(3):
        call()
    torch.cuda.synchronize()

    summary = {"algorithm": args.algorithm, "iterations": n_it,
               "branching": list(branching if args.stream
                                 else BARCELONA_BRANCHING),
               "batch": args.batch, "stream": args.stream,
               "lbfgs_dtype": args.lbfgs_dtype,
               "scenarios": tree.ns, "solves": []}
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        torch.cuda.synchronize()
        ev0.record()
        t0 = time.perf_counter()
        call()
        t1 = time.perf_counter()
        ev1.record()
        torch.cuda.synchronize()
        solve = {"event_ms": ev0.elapsed_time(ev1),
                 "enqueue_ms": (t1 - t0) * 1e3,
                 "wall_ms": (time.perf_counter() - t0) * 1e3}
        summary["solves"].append(solve)
        print("[solve] " + ", ".join(f"{k} {v:.3f}" for k, v in solve.items()))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(out_dir / "trace.json"))

    phases = []
    for e in prof.key_averages():
        dt = getattr(e, "device_time_total", None)
        if dt is None:
            dt = getattr(e, "cuda_time_total", 0)
        name = re.search(r"\w+_kernel(<[\w, ]+>)?", e.key)
        if dt > 0 and name:
            phases.append({"kernel": name.group(), "launches": e.count,
                           "us_per_iteration": dt / n_it})
    phases.sort(key=lambda p: -p["us_per_iteration"])
    summary["phases"] = phases

    for p in phases:
        print(f"[phase] {p['kernel']:34s} launches {p['launches']:6d}  "
              f"{p['us_per_iteration']:8.3f} us per iteration")

    device_events = [e for e in prof.events()
                     if str(getattr(e, "device_type", "")).endswith("CUDA")]
    intervals = [(e.time_range.start, e.time_range.end)
                 for e in device_events]
    if args.stream and algorithm is not None:
        glue = sum(e.time_range.end - e.time_range.start
                   for e in device_events
                   if stream_qn_part(e.name) == "glue")
        summary["glue_us_per_iteration"] = glue / n_it
        print(f"[phase] glue (every device kernel but S1, S2 and the "
              f"history passes): {glue / n_it:.3f} us per iteration")
    if args.stream:
        # K1's launches of an iteration in order: one per range of stages
        k1 = sorted((e.time_range.start, e.time_range.end)
                    for e in device_events if "k1_kernel" in e.name)
        n_r = len(kc["ranges"])
        if len(k1) == n_it * n_r:
            ranges = []
            for r, (hi, lo, gather) in enumerate(kc["ranges"]):
                us = sum(e - s for s, e in k1[r::n_r]) / n_it
                ranges.append({"stages": [hi, lo], "gather": gather,
                               "us_per_iteration": us})
                print(f"[k1] launch {r}: stages {hi}..{lo}, handoff read "
                      f"{gather}: {us:.3f} us per iteration, "
                      f"{us / (hi - lo + 1):.3f} us per stage")
            summary["k1_launches"] = ranges
    if intervals:
        busy, span = busy_span(intervals)
        summary.update(device_busy_ms=busy / 1e3, device_span_ms=span / 1e3,
                       idle_share=1.0 - busy / span)
        print(f"[device] {len(intervals)} device events, busy "
              f"{busy / 1e3:.3f} ms of a {span / 1e3:.3f} ms span, idle "
              f"share {1.0 - busy / span:.4f}")
    else:
        print("[device] the trace holds no device time")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    summary["card"] = smi.splitlines()[0]
    if args.spans:
        mhz = float(summary["card"].split(",")[-1].split()[0])
        if args.stream and algorithm is not None:
            summary["spans"] = sweep_split(S, kc, step, hyper, mhz)
        elif args.stream:
            summary["spans"] = stage_split(S, kc, step, hyper, mhz)
        else:
            summary["spans"] = phase_split(K, kc, step, hyper, args.batch,
                                           mhz)
    if args.sweep:
        summary["sweep"] = variant_sweep(K, kc, step, hyper, args.batch)
    print(summary["card"])
    (out_dir / "summary.json").write_text(json.dumps(summary, indent=1))
    return 0


def per_block(cycles, per_pass, N, nb, mhz, label=""):
    """Print and return each part's SM cycles (summed over nb blocks and
    a pass's launches) per block and stage, or, for the parts of
    ``per_pass`` (part -> launches a pass), per block and launch, with
    their µs at ``mhz``, the card's maximum SM clock."""
    split = {}
    for part, cyc in cycles.items():
        n = per_pass.get(part, N)
        per = cyc / nb / n
        split[part] = {"cycles": per, "us": per / mhz,
                       "per": "launch" if part in per_pass and n > 1 else
                       "pass" if part in per_pass else "stage"}
        print(f"[span] {label}{part:9s} {per:10.1f} cycles a block per "
              f"{split[part]['per']}, {per / mhz:8.3f} us at {mhz:g} MHz "
              f"(x{n} a pass: {per * n / mhz:8.3f} us)")
    return split


def stage_split(S, kc, step, hyper, mhz):
    """Print and return the per-part split of one K1 and one K2 pass of
    the instrumented build at ``mhz``, the card's maximum SM clock."""
    st = S.plain_iterations(kc, step, iterations=2, **hyper)
    lams = kc["lams"]
    out = S.stage_spans(kc, step, st["pre"], st["y"], st["z"],
                        (lams[1], lams[2], 1.0, st["k1f"], st["k2f"]),
                        **hyper)
    N, ns = kc["sq"].shape
    per_pass = {"k1_start": len(kc["ranges"]), "k1_end": len(kc["ranges"]),
                "k2_end": 1}
    return per_block(out["cycles"], per_pass, N, -(-ns // S.TILE), mhz)


def sweep_split(S, kc, step, hyper, mhz):
    """Print and return the per-part split of one S1 and one S2 pass of
    ``csrc/stream_qn.cu``'s instrumented build at ``mhz``, the card's
    maximum SM clock, for the solve step and the Hessian oracle, with the
    variant each pass took (``stream_qn.staged``)."""
    import torch
    from rapidnet_tpu_torch.ops import stream_qn as SQ
    st = S.plain_iterations(kc, step, iterations=2, **hyper)
    w = torch.cat([st["y"]["xi"], st["y"]["psi"]], dim=-1).contiguous()
    pdu = (step["prev_u"] - step["prev_uhat"]).contiguous()
    N, ns = kc["sq"].shape
    per_pass = {"s1_start": len(kc["ranges"]), "s1_end": len(kc["ranges"]),
                "s2_start": 1}
    split = {}
    for label, a1, a2 in (("solve", (step["beta"],),
                           (step["uhat"], step["e"], step["x0"], pdu)),
                          ("oracle", (), ())):
        got = SQ.sweep_spans(kc, w, *a1, *a2)
        split[label] = per_block(got["cycles"], per_pass, N,
                                 -(-ns // SQ.TILE), mhz, f"{label:6s} ")
    split["staged"] = SQ.staged(*SQ.dims(kc))
    print(f"[span] variants (stream_qn_staged): {split['staged']}")
    return split


def phase_split(K, kc, step, hyper, batch, mhz):
    """Print and return the per-part split of one call of the whole-solve
    APG kernel's instrumented build (``apg_solve.phase_spans``): the SM
    cycles of each part per block and launch of its phase, at ``mhz``,
    the card's maximum SM clock."""
    got = K.phase_spans(kc, step, None, batch=batch or None, **hyper)
    n_it = hyper["max_iterations"]
    for phase, blocks in got["blocks"].items():
        print(f"[span] {phase}: {blocks / n_it:g} blocks a launch")
    split = {}
    for part, cyc in got["cycles"].items():
        split[part] = {"cycles": cyc, "us": cyc / mhz}
        print(f"[span] {part:18s} {cyc:10.1f} cycles a block per launch, "
              f"{cyc / mhz:8.3f} us at {mhz:g} MHz")
    return {"parts": split, "blocks": got["blocks"]}


def variant_sweep(K, kc, step, hyper, batch):
    """Print and return the event ms of one call in each variant of
    SWEEP_CLUSTERS, the picked one and the one-block design, in turns (``apg_solve.solve_as``; B = 1 of the batched entry for a single
    solve), after checking that each equals the picked variant's outputs
    bit for bit."""
    import numpy as np
    import torch
    steps = step if batch else {k: v[None] for k, v in step.items()}
    B = steps["beta"].shape[0]
    fa = kc["fa"]
    dims = (*fa["d1"].shape, fa["g"].shape[-1], fa["invWbar"].shape[0])
    props = torch.cuda.get_device_properties(0)
    limits = dict(sm_count=props.multi_processor_count,
                  smem_limit=props.shared_memory_per_block_optin,
                  smem_per_sm=getattr(props, "shared_memory_per_multiprocessor",
                                      K.H100_SMEM_PER_SM))
    picked = K.variant(*dims, B)
    print(f"[sweep] B {B}: the source picks {picked} "
          f"(code {K.encode(picked):#x})")
    runs = {"picked": K.encode(picked)}
    for C in SWEEP_CLUSTERS:
        runs[f"C {C}"] = K.encode(K.pick(*dims, B, cluster=C, **limits))
    runs["one-block (C 1, Cp 1, unstaged)"] = 0x110
    ref = K.solve_as(kc, steps, None, code=runs["picked"], **hyper)
    for name, code in runs.items():
        out = K.solve_as(kc, steps, None, code=code, **hyper)
        for k in ("x", "u", "primal_infeasibility", "iterations"):
            if not torch.equal(out[k], ref[k]):
                raise RuntimeError(f"sweep: {name} ({code:#x}) differs from "
                                   f"the picked variant in {k}")
    times = {name: [] for name in runs}
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    for r in range(SWEEP_ROUNDS):
        for name in (runs if r % 2 == 0 else reversed(list(runs))):
            torch.cuda.synchronize()
            ev0.record()
            K.solve_as(kc, steps, None, code=runs[name], **hyper)
            ev1.record()
            torch.cuda.synchronize()
            times[name].append(ev0.elapsed_time(ev1))
    out = {}
    for name, ts in times.items():
        out[name] = {"code": runs[name], "ms": ts,
                     "median_ms": float(np.median(ts))}
        print(f"[sweep] B {B} {name:34s} code {runs[name]:#06x}: "
              f"{float(np.median(ts)):9.3f} ms "
              f"({', '.join(f'{t:.3f}' for t in ts)})")
    return out


if __name__ == "__main__":
    sys.exit(main())
