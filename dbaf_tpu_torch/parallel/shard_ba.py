"""Edge-parallel dense BA with explicit collectives (port of
``dbaf_tpu/parallel/shard_ba.py``).

One Gauss-Newton iteration, its edges split over the ranks of a group:

* **local**: the per-edge linearization (projective Jacobians over every
  pixel, the 12 x 12 blocks, the pose-depth couplings) of this rank's
  edges;
* **all_reduce**: the depth diagonal (C, w), a sum over edges onto the
  frames;
* **all_gather**: the per-edge pose blocks ``H``, right-hand sides ``v``
  and couplings ``Exy`` in one collective, and the edges' frame and pose
  indices in another, so that every rank forms the same pose system and
  Schur complement;
* **replicated**: the Schur complement and the damped solve (the pose
  window is small);
* **local + all_reduce**: the depth back-substitution of this rank's edges,
  summed onto the frames.

The Schur complement is the port's pairwise product on the gathered edges
(``ops/dba.py::assemble_pairwise``): ``S = M (Hbd - T) M^T`` with one
one-hot placement ``M``, the per-edge 12 x 12 blocks ``H`` gathered beside
the couplings, so every rank forms ``S`` by one process's formula on the
edges in one process's order.  The JAX package's iteration instead sums
``A`` over the shards and scatters the ``E x E`` pair product into the
(P, P, 6, 6) window block by block; a difference ``A - M T M^T`` of two
large matrices would lose the digits that ``Hbd - T`` keeps.  The 144
floats of ``H`` an edge are small beside its ``12 D`` of couplings.

The iteration is ``dba.ba``'s own pairwise body with a process group
(:func:`dbaf_tpu_torch.ops.dba.ba`), and its collectives are
differentiable (:mod:`.collectives`), so the training step's BA layer runs
the same body on its edge shard.
"""

from __future__ import annotations

from ..ops import dba


def make_sharded_ba_iteration(mesh, P_win: int, axis: str = "edge"):
    """One edge-sharded GN iteration over the mesh's ``axis`` group: f(poses,
    disps, intrinsics, targets, weights, eta, ii, jj, mask, nfixed,
    nactive) -> (poses, disps), the disparities clamped at 0.001.  The
    edge-axis arguments are this rank's slice (equal sizes on every rank;
    pad with masked edges)."""
    group = mesh.get_group(axis)

    def iteration(poses, disps, intrinsics, targets, weights, eta, ii, jj, mask, nfixed,
                  nactive):
        assert poses.shape[0] == P_win, (poses.shape, P_win)
        out = dba.ba(poses, disps, intrinsics, targets, weights, eta, ii, jj, mask, nfixed,
                     nactive, iterations=1, group=group)
        return out.poses, out.disps

    return iteration
