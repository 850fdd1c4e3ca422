"""Meshes over the ranks and the edge-parallel steps built on them (port
of ``dbaf_tpu/parallel/mesh.py``).

A ``torch.distributed.device_mesh.DeviceMesh`` takes the place of
``jax.sharding.Mesh``: it spans ranks, one device each, and hands out the
process group of each axis.  Where the JAX package shards a jitted
function's inputs and lets XLA insert the collectives, the port's steps
take this rank's shard and call the collectives themselves:

* **edge parallelism** (:func:`sharded_ba_step`): covisibility edges are
  split over the ranks; each linearizes its own, the window system is
  summed over the ranks and solved on each (``parallel/shard_ba.py``);
* **frame parallelism** (:func:`sharded_feature_step`): each rank
  extracts the features of its frames, and a gather returns every frame's.

Without a process group, a mesh is the single process: a group of one
rank is created for it (gloo on the CPU, NCCL on the card).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist

from ..ops import dba
from . import collectives as col
from .dist import default_backend, initialize


def _ensure_group(device: Optional[Union[str, torch.device]] = None) -> int:
    """The world size, after joining the job the environment describes, or
    making a group of this process alone when none does."""
    if not dist.is_initialized() and initialize(device=device) == 1:
        dist.init_process_group(default_backend(device), store=dist.HashStore(), rank=0,
                                world_size=1)
    return dist.get_world_size()


def make_mesh_nd(shape: Sequence[int], axis_names: Sequence[str],
                 device: Optional[Union[str, torch.device]] = None):
    """A mesh of ``shape`` over every rank, in rank order (host-major)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = _ensure_group(device)
    n = 1
    for s in shape:
        n *= int(s)
    if n != world:
        raise ValueError(f"a mesh of shape {tuple(shape)} needs {n} ranks; the job has {world}")
    dtype = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(dtype, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axis_names))


def make_mesh(n_devices: Optional[int] = None, axis: str = "edge",
              device: Optional[Union[str, torch.device]] = None):
    """1-D mesh over the job's ranks; ``n_devices``, where given, must be
    the world size (a mesh of torch ranks spans them all)."""
    world = _ensure_group(device)
    n = world if n_devices is None else int(n_devices)
    return make_mesh_nd((n,), (axis,), device)


def make_mesh_2d(dp: int, edge: int, dp_axis: str = "dp", edge_axis: str = "edge",
                 device: Optional[Union[str, torch.device]] = None):
    """(dp x edge) mesh for the training step: tuples over the first axis,
    each tuple's edges over the second (consecutive ranks share a dp row,
    so the edge collectives stay within a host)."""
    return make_mesh_nd((dp, edge), (dp_axis, edge_axis), device)


def sharded_ba_step(mesh, axis: str = "edge"):
    """``dba.ba`` with ``iterations=2`` on edge-sharded inputs.

    Returns f(poses, disps, intrinsics, targets, weights, eta, ii, jj,
    mask, nfixed, nactive) -> BAState: the edge-axis arguments are this
    rank's slice, the window state is replicated and so is the result."""
    group = mesh.get_group(axis)

    def step(poses, disps, intrinsics, targets, weights, eta, ii, jj, mask, nfixed, nactive):
        return dba.ba(poses, disps, intrinsics, targets, weights, eta, ii, jj, mask, nfixed,
                      nactive, iterations=2, group=group)

    return step


def sharded_feature_step(mesh, model, axis: str = "edge"):
    """Frame-parallel feature extraction: f(images) with this rank's frames
    (N / ranks of them, in rank order) -> (fmaps, net, inp) of every
    frame, as ``model.extract_features`` gives them for all N."""
    group = mesh.get_group(axis)

    @torch.no_grad()
    def step(images):
        return tuple(col.all_cat(x.contiguous(), group) for x in model.extract_features(images))

    return step
