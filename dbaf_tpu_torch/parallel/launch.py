"""Run a function on several ranks of one machine: spawned processes that
join one process group through a ``file://`` store.

    results = launch.run(fn, 2, (arg,), workdir=d, device="cpu")

or ``launch.start(...)``, work in this process, then ``.wait()``.

``fn`` is a module-level function (a spawned process imports its module,
so that module should not import what the ranks do not need); it runs
after the rank has joined the group, and its return value (picklable)
comes back in rank order.  A rank that raises fails the run, and the
others are stopped; so are all of them at ``timeout``.  Ranks on the card
all use ``cuda:<rank % cards>``: ranks that share a card name
``backend="gloo"``.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Callable, List, Sequence

import torch


def _entry(rank: int, world: int, store: str, backend: str, device: str, threads: int,
           fn: Callable, args: Sequence, workdir: str) -> None:
    import torch.distributed as tdist

    from . import dist

    torch.set_num_threads(threads)
    dist.initialize(coordinator_address=f"file://{store}", num_processes=world,
                    process_id=rank, backend=backend, device=device)
    try:
        out = fn(*args)
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        tdist.barrier()
    finally:
        tdist.destroy_process_group()


class Ranks:
    """Ranks started by :func:`start`; :meth:`wait` joins them."""

    def __init__(self, ctx, world: int, workdir: str, store: str, timeout: float):
        self.ctx, self.world, self.workdir, self.store = ctx, world, workdir, store
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout

    def wait(self) -> List:
        """Each rank's result, in rank order, once all have finished; a
        failed rank raises here and the others are stopped."""
        try:
            while not self.ctx.join(timeout=max(self.deadline - time.monotonic(), 0.0)):
                if time.monotonic() >= self.deadline:
                    raise TimeoutError(f"{self.world} ranks did not finish within "
                                       f"{self.timeout} s")
        finally:
            for p in self.ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
            if os.path.exists(self.store):
                os.remove(self.store)
        out = []
        for r in range(self.world):
            with open(os.path.join(self.workdir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def start(fn: Callable, world: int, args: Sequence = (), *, workdir: str,
          backend: str = "gloo", device: str = "cpu", timeout: float = 600.0,
          threads: int = 1) -> Ranks:
    """Start ``fn(*args)`` on ``world`` ranks without waiting for them."""
    import torch.multiprocessing as mp

    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir, f"store-{os.getpid()}-{time.time_ns()}")
    for r in range(world):
        path = os.path.join(workdir, f"rank{r}.pkl")
        if os.path.exists(path):
            os.remove(path)
    ctx = mp.start_processes(_entry, args=(world, store, backend, device, threads, fn,
                                           tuple(args), workdir),
                             nprocs=world, join=False, start_method="spawn")
    return Ranks(ctx, world, workdir, store, timeout)


def run(fn: Callable, world: int, args: Sequence = (), **kw) -> List:
    """``fn(*args)`` on ``world`` ranks; returns each rank's result (the
    keywords are :func:`start`'s)."""
    return start(fn, world, args, **kw).wait()
