#!/usr/bin/env python
"""Weak-scaling run of the row-partitioned Chebyshev free-energy sweep.

The PyTorch/CUDA counterpart of ``examples/weak_scaling.py``.  Each rank owns
a fixed local slab of ``--local-lx`` x-planes of ``--width`` sites; the
lattice grows with the number of ranks, and every rank runs the fused halo
step (``ell_cheb_step_halo``) on its slab with the boundary planes exchanged
through ``torch.distributed`` each step.  With one card per rank, ideal weak
scaling is a constant wall-clock: efficiency = t(1) / t(P).

Two runs are made: a world of one (no process group), and ``--ranks`` gloo
ranks spawned on this machine, every one of them on the same card (or on the
CPU with ``--device cpu``).  **One card cannot show scaling**: the ranks
share its SMs and memory bandwidth and exchange their planes through host
memory, so P ranks do P times the work on fixed hardware and the ideal there
is t(P) = P·t(1).  The run checks the communication structure and reports
both normalisations; scaling itself needs one card per rank.

    python examples/torch_weak_scaling.py                  # on the card
    python examples/torch_weak_scaling.py --device cpu --local-lx 16 --width 32

The last line of output is one JSON object with the result.
"""

import argparse
import json
import socket
import sys
import time


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _run(args, rank: int, world: int) -> dict:
    """Build this rank's slab of the (local_lx·world) × width lattice and time
    the sharded free energy (min over ``args.reps`` after a warm-up)."""
    import torch
    import torch.distributed as dist

    from bodge_tpu_torch.models.systems import swave_superconductor
    from bodge_tpu_torch.parallel import RowSharding, free_energy_kpm_sharded_cuda, make_row_mesh

    device = torch.device(args.device) if args.device else torch.device("cuda", 0)
    mesh = make_row_mesh(devices=device)
    system = swave_superconductor((args.local_lx * world, args.width, 1), delta=0.4, device=device)
    rs = RowSharding(system.skeleton, mesh)
    data = rs.shard_data(system.data)
    del system

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if world > 1:
            dist.barrier()

    def run():
        return free_energy_kpm_sharded_cuda(rs, data, args.temperature, scale=6.0,
                                            order=args.order, samples=args.samples)

    F = run()  # warm-up
    best = float("inf")
    for _ in range(args.reps):
        sync()
        t0 = time.perf_counter()
        F = run()
        sync()
        best = min(best, time.perf_counter() - t0)
    return {"ranks": world, "sites": args.local_lx * world * args.width, "time_s": best, "F": F,
            "exchanges": rs.stats["exchanges"], "exchange_s": rs.stats["exchange_s"],
            "timing": f"min of {args.reps} after a warm-up"}


def _rank(rank: int, world: int, port: int, args, queue) -> None:
    """One gloo rank; rank 0 puts its result on ``queue``."""
    import torch.distributed as dist

    from bodge_tpu_torch.parallel import initialize_multihost

    initialize_multihost(f"localhost:{port}", world, rank, backend="gloo")
    try:
        out = _run(args, rank, world)
        if rank == 0:
            queue.put(out)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="'cpu', or a CUDA device (default: the card)")
    ap.add_argument("--local-lx", type=int, default=256, help="x-planes per rank")
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--order", type=int, default=32)
    ap.add_argument("--samples", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3, help="timing repeats; the minimum is kept")
    ap.add_argument("--temperature", type=float, default=0.1)
    ap.add_argument("--ranks", type=int, default=4, help="gloo ranks of the second run")
    args = ap.parse_args(argv)

    import torch
    import torch.multiprocessing as mp

    if args.device is None and not torch.cuda.is_available():
        sys.exit("No CUDA device is available; pass --device cpu to run on the CPU")
    results = [_run(args, 0, 1)]

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank, args=(r, args.ranks, port, args, queue)) for r in range(args.ranks)]
    for p in procs:
        p.start()
    try:
        results.append(queue.get(timeout=600))  # read before joining: rank 0 waits on its pipe
        for p in procs:
            p.join(timeout=120)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if any(p.exitcode != 0 for p in procs):
        sys.exit(f"a rank failed: exit codes {[p.exitcode for p in procs]}")

    t1, tp = results[0]["time_s"], results[1]["time_s"]
    for r in results:
        print(f"P={r['ranks']:2d}  sites={r['sites']:9d}  t={r['time_s']:8.4f}s  F={r['F']:.2f}")
    shared = {
        "one_card_note": "all ranks share one card: this shows the exchange structure, not scaling",
        "shared_card_throughput_efficiency": args.ranks * t1 / tp,  # ideal there: t(P) = P·t(1)
        "weak_scaling_efficiency_if_one_card_per_rank": t1 / tp,  # not meaningful on one card
    }
    device = args.device or torch.cuda.get_device_name(0)
    print(json.dumps({"example": "torch_weak_scaling", "device": device, "runs": results, **shared}))
    if not all(r["exchanges"] > 0 or r["ranks"] == 1 for r in results):
        sys.exit("the ranks exchanged no halo planes")


if __name__ == "__main__":
    main()
