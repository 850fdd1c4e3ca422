"""Multi-process worker: edge-sharded DBA over a ``torch.distributed`` group
(port of ``dbaf_tpu/parallel/dist_worker.py``).

One process per rank.  Every process builds the same seeded window, keeps
only its slice of the edge arrays, joins the group, and runs N
edge-sharded GN iterations (``parallel/shard_ba.py``: local linearization,
summed assembly, gathered couplings, replicated solve).  Process 0 saves
the final poses, disparities and ms an iteration to ``--out``.

Two processes on the CPU (gloo):

    python -m dbaf_tpu_torch.parallel.dist_worker --process-id 0 --num-processes 2 \\
        --coordinator localhost:29511 --device cpu --out p0.npz &
    python -m dbaf_tpu_torch.parallel.dist_worker --process-id 1 --num-processes 2 \\
        --coordinator localhost:29511 --device cpu --out p1.npz

On a host with several cards (NCCL, one card a rank):

    torchrun --nproc-per-node 4 -m dbaf_tpu_torch.parallel.dist_worker --time 20 --out p.npz

Without ``--num-processes`` and outside torchrun the worker is one process
(a group of one rank).  Ranks that share one card name ``--backend gloo``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

H8, W8 = 24, 32


def seeded_window(P_win: int, E: int, seed: int = 0) -> dict:
    """The worker's window as numpy arrays, the same on every process:
    poses (P, 7) near the identity, disparities (P, H8, W8), intrinsics,
    E edges ii -> jj, targets, weights, eta and mask."""
    import torch

    from ..ops import lie

    rng = np.random.default_rng(seed)
    xi = rng.normal(size=(P_win, 6)).astype(np.float32) * 0.02
    ident = torch.tensor([0, 0, 0, 0, 0, 0, 1.0]).repeat(P_win, 1)
    poses = lie.se3_retr(ident, torch.as_tensor(xi)).numpy()
    disps = (0.5 + 0.1 * rng.random((P_win, H8, W8))).astype(np.float32)
    intr = np.asarray([80.0, 80.0, W8 / 2, H8 / 2], np.float32)
    ii = np.repeat(np.arange(P_win), E // P_win + 1)[:E].astype(np.int64)
    jj = np.clip(ii + rng.integers(1, 4, size=E), 0, P_win - 1).astype(np.int64)
    targets = (rng.random((E, H8, W8, 2)) * [W8, H8]).astype(np.float32)
    weights = (0.5 * np.ones((E, H8, W8, 2))).astype(np.float32)
    eta = np.full((P_win, H8 * W8), 1e-4, np.float32)
    return dict(poses=poses, disps=disps, intr=intr, ii=ii, jj=jj, targets=targets,
                weights=weights, eta=eta, mask=np.ones((E,), bool))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Edge-sharded DBA over a torch.distributed group.")
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--coordinator", type=str, default=None,
                    help="host:port of rank 0 (or a tcp:// or file:// URL)")
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--backend", type=str, default=None,
                    help="nccl or gloo (default: nccl on the card, gloo on the CPU)")
    ap.add_argument("--edges", type=int, default=128)
    ap.add_argument("--window", type=int, default=16)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--time", type=int, default=0,
                    help="additionally time this many chained iterations")
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32",
                    help="float64 holds the sharded sums to the single-process solve at "
                         "f64 rounding (the window's GN step amplifies f32 rounding)")
    ap.add_argument("--out", type=str, default="")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as tdist

    from . import dist
    from .mesh import make_mesh
    from .shard_ba import make_sharded_ba_iteration

    dist.initialize(coordinator_address=args.coordinator, num_processes=args.num_processes,
                    process_id=args.process_id, backend=args.backend, device=args.device)
    if args.device == "cpu":
        torch.set_num_threads(1)
    mesh = make_mesh(device=args.device)
    n = dist.world_size()
    dev = dist.rank_device(args.device)
    print(f"# rank {dist.rank()}/{n} on {dev} ({tdist.get_backend()})", file=sys.stderr,
          flush=True)

    P_win, E = args.window, args.edges
    if E % n:
        raise SystemExit(f"--edges {E} must divide the world size {n}")
    w = seeded_window(P_win, E)
    w = {k: v.astype(args.dtype) if v.dtype == np.float32 else v for k, v in w.items()}
    sl = dist.process_edge_slice(E)
    tg, wg, iig, jjg, mg = dist.global_edge_arrays(
        mesh, "edge", w["targets"][sl], w["weights"][sl], w["ii"][sl], w["jj"][sl],
        w["mask"][sl], device=dev)
    pg, dg, ig, eg = dist.replicated(mesh, w["poses"], w["disps"], w["intr"], w["eta"],
                                     device=dev)

    step = make_sharded_ba_iteration(mesh, P_win)
    p, d = pg, dg
    for _ in range(args.iters):
        p, d = step(p, d, ig, tg, wg, eg, iig, jjg, mg, 1, P_win)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    timing = None
    if args.time:
        t0 = time.perf_counter()
        tp, td = p, d
        for _ in range(args.time):
            tp, td = step(tp, td, ig, tg, wg, eg, iig, jjg, mg, 1, P_win)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        timing = (time.perf_counter() - t0) / args.time
        print(json.dumps({"metric": "multihost_sharded_ba_iter_ms", "processes": n,
                          "backend": tdist.get_backend(), "device": str(dev),
                          "value": timing * 1e3, "unit": "ms/iter"}), flush=True)

    if args.out and dist.rank() == 0:
        np.savez(args.out, poses=p.cpu().numpy(), disps=d.cpu().numpy(),
                 iter_ms=-1.0 if timing is None else timing * 1e3)
    tdist.barrier()
    tdist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
