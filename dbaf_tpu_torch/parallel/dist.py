"""Multi-process execution on ``torch.distributed``: process init, meshes
over the ranks, data placement (port of ``dbaf_tpu/parallel/dist.py``).

* :func:`initialize` joins a job that torchrun's environment (``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``) or the
  caller's arguments describe.  It is idempotent, and a no-op returning 1
  when nothing describes a multi-process job.
* A mesh spans ranks, one device per rank (where the JAX package counts
  ``jax.devices()``, the port counts the world size).  Ranks are
  host-major, as torchrun numbers them, so the edge axis keeps each host's
  share contiguous.
* Each rank holds only its slice of the edge arrays
  (:func:`global_edge_arrays`); the window state is replicated
  (:func:`replicated`), so the Schur solve is the same on every rank.

The backend is NCCL on the card and gloo on the CPU.  Ranks that share one
card cannot use NCCL; they name ``backend="gloo"``, and the collectives
then go through the host (:mod:`dbaf_tpu_torch.parallel.collectives`).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device

# a rank that waits this long in a collective raises instead of hanging
TIMEOUT_S = 300


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """This rank's device: the card (``LOCAL_RANK`` modulo the card count
    when no index is given) unless the caller names the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank()))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def default_backend(device: Optional[Union[str, torch.device]] = None) -> str:
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None,
               device: Optional[Union[str, torch.device]] = None) -> int:
    """Join (or create) the process group; returns the world size.

    ``coordinator_address`` is ``host:port`` (or an ``init_method`` URL,
    ``tcp://`` or ``file://``); without arguments, torchrun's environment
    is read.  When neither describes a multi-process job nothing is
    initialized and 1 is returned.  ``backend`` defaults to NCCL for the
    card and gloo for the CPU; a card rank sets its device first."""
    if dist.is_initialized():
        return dist.get_world_size()
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None:
        return 1
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process job needs a coordinator address, the number of "
                         "processes and this process's id")
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(env.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend or default_backend(dev), init_method=url, rank=process_id,
                            world_size=num_processes,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return dist.get_world_size()


def global_edge_mesh(axis: str = "edge"):
    """1-D mesh over every rank of the job, host-major."""
    from .mesh import make_mesh

    return make_mesh(axis=axis)


def hybrid_mesh(ici_shape: Optional[Sequence[int]] = None,
                dcn_shape: Optional[Sequence[int]] = None,
                axis_names: Sequence[str] = ("host", "edge")):
    """Explicit (hosts x ranks-per-host) mesh: the outer axes cross hosts,
    the inner stay within one.  Defaults to (hosts, ranks per host), the
    ranks per host read from torchrun's ``LOCAL_WORLD_SIZE`` (all ranks on
    one host without it).  The shape is the product of the two, axis by
    axis, and must cover the world."""
    from .mesh import make_mesh_nd

    world = world_size()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    hosts = max(world // max(per_host, 1), 1)
    dcn_shape = (hosts, 1) if dcn_shape is None else tuple(dcn_shape)
    ici_shape = (1, per_host) if ici_shape is None else tuple(ici_shape)
    shape = tuple(a * b for a, b in zip(dcn_shape, ici_shape))
    return make_mesh_nd(shape, tuple(axis_names))


def process_edge_slice(E: int, axis_size: Optional[int] = None) -> slice:
    """This rank's contiguous slice of a length-E edge axis sharded over
    the ranks in order."""
    n = world_size()
    if E % max(axis_size or n, 1):
        raise ValueError(f"edge count {E} must divide the mesh axis ({axis_size or n})")
    per = E // n
    i = rank()
    return slice(i * per, (i + 1) * per)


def _put(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.as_tensor(np.asarray(a), device=device)


def global_edge_arrays(mesh, axis: str, *host_arrays,
                       device: Optional[Union[str, torch.device]] = None):
    """This rank's slice (:func:`process_edge_slice`) of each edge-axis
    array, on its device; the collectives of the mesh's ``axis`` group join
    the slices.  Each rank passes only its own slice."""
    del mesh, axis  # the slice already is this rank's shard
    dev = rank_device(device)
    return tuple(_put(a, dev) for a in host_arrays)


def replicated(mesh, *host_arrays, device: Optional[Union[str, torch.device]] = None):
    """The same values on every rank (window poses, disparities,
    intrinsics), each on this rank's device."""
    del mesh
    dev = rank_device(device)
    return tuple(_put(a, dev) for a in host_arrays)
