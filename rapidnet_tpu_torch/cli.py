"""Closed-loop CLI driver (reference main.cu parity), PyTorch port.

Usage:
  python -m rapidnet_tpu_torch.cli --config path/to/controllerConfig.json \
      --steps 10 --output controlOutput.json [--device cuda] \
      [--backend auto|cuda|stream|torch] \
      [--stream-lbfgs-dtype float32|bfloat16] [--external-simulator] \
      [--profile-dir DIR]
  torchrun --nproc-per-node N -m rapidnet_tpu_torch.cli --devices N ...

Runs the receding-horizon loop: forecast -> controlAction (timed) ->
moveForwardInTime, then prints the four KPIs (src/main.cu:34-69).  The
config's ``algorithm`` picks the solver (APG, global FBE or NAMA, the
last two with its ``lbfgsBufferSize``); the per-step lines and the
output JSON are the same for all three.  With
``--external-simulator`` the controller re-reads currentX/prevU/
prevDemand from the config JSON each step and writes the updated state
back (the reference's simulatorFlag=0 path).  ``--profile-dir DIR``
writes a ``torch.profiler`` Chrome trace of the closed loop into DIR.

``--devices N`` shards the scenario axis over N processes, one per
shard, each running this command (``torchrun`` sets RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR and MASTER_PORT; ``--dist-init`` names another
rendezvous, such as ``file:///shared/path``).  Every rank runs the same
closed loop; rank 0 alone prints and writes ``--output``.  A rank's
card is ``cuda:<LOCAL_RANK>`` and the group NCCL; with ``--device cpu``
the ranks run on the CPU over gloo.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", required=True,
                   help="controller configuration JSON "
                        "(reference-compatible)")
    p.add_argument("--steps", type=int, default=2,
                   help="closed-loop time instances to simulate")
    p.add_argument("--output", default="controlOutput.json",
                   help="control output JSON path")
    p.add_argument("--external-simulator", action="store_true",
                   help="read/write closed-loop state via the config "
                        "JSON instead of the built-in simulator")
    p.add_argument("--no-price-uncertainty", action="store_true")
    p.add_argument("--no-demand-uncertainty", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device of the solve (default cuda; "
                        "raises when no GPU is present)")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "cuda", "stream", "torch"],
                   help="auto: on a GPU the whole-solve CUDA kernel when "
                        "the tree fits it, else the streaming kernels "
                        "(fixed budget), else the plain solve; cuda: the "
                        "whole-solve kernel; stream: the streaming "
                        "kernels; torch: the plain PyTorch solve (the "
                        "kernels' plain versions run on the CPU)")
    p.add_argument("--stream-precision", default=None,
                   choices=["highest", "default"],
                   help="the streaming kernels' products: highest (full "
                        "float32, the default) or default (one bf16 pass "
                        "a product, as the TPU's MXU takes it)")
    p.add_argument("--stream-lbfgs-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="the storage of the streaming FBE/NAMA solve's "
                        "L-BFGS history (bfloat16 halves its bytes)")
    p.add_argument("--tolerance", type=float, default=None,
                   help="terminate each solve when the residual "
                        "magnitude drops below this (default: fixed "
                        "budget like the reference)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace (CPU, and "
                        "CUDA activity on a GPU) of the closed loop here; "
                        "on a mesh rank 0 alone traces")
    p.add_argument("--devices", type=int, default=0,
                   help="shard the scenario axis over this many processes "
                        "(one per shard, e.g. under torchrun; 0 = one "
                        "device)")
    p.add_argument("--dist-init", default=None,
                   help="the process group's init method (default env://, "
                        "torchrun's variables)")
    args = p.parse_args(argv)

    from rapidnet_tpu_torch.solver.controller import SmpcController

    mesh, rank = None, 0
    if args.devices:
        from rapidnet_tpu_torch.parallel import distributed, make_mesh
        cpu = args.device == "cpu"
        distributed.initialize(backend="gloo" if cpu else "nccl",
                               init_method=args.dist_init)
        mesh = make_mesh(args.devices,
                         devices=["cpu"] * args.devices if cpu else None)
        rank = mesh.rank
    ctrl = SmpcController(args.config, backend=args.backend,
                          device=args.device, tolerance=args.tolerance,
                          mesh=mesh, stream_precision=args.stream_precision,
                          stream_lbfgs_dtype=args.stream_lbfgs_dtype)
    if args.no_price_uncertainty:
        ctrl.engine.price_uncertainty = False
    if args.no_demand_uncertainty:
        ctrl.engine.demand_uncertainty = False
    ctrl.simulator_flag = not args.external_simulator

    if rank == 0:
        print(f"scenario tree nodes {ctrl.tree.n_nodes} "
              f"{ctrl.tree.ns}", file=sys.stderr)
    output = args.output if rank == 0 else None
    if args.profile_dir and rank == 0:
        from rapidnet_tpu_torch.utils.timing import profile_trace
        with profile_trace(args.profile_dir):
            log = ctrl.closed_loop(args.steps, output_json=output)
    else:
        log = ctrl.closed_loop(args.steps, output_json=output)
    if rank != 0:
        return 0
    for t in range(args.steps):
        print(f"time lapsed {log[f'time{t}'][0]:.3f} milliseconds",
              file=sys.stderr)
    print(f"economic kpi {log['economicKpi']}")
    print(f"smooth kpi {log['smoothKpi']}")
    print(f"safety kpi {log['safetyKpi']}")
    print(f"network utility kpi {log['networkKpi']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
