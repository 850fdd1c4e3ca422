"""Plain BA weights of an update round: DROID-SLAM's confidence heuristics
as DBA-Fusion's ``covisible_graph.py:309-328`` runs them, edge by edge, in
float64.

For each edge (i, j) the update operator's weight is multiplied by

1. 0.1 where i is the newest source frame and 0.25 where j is the newest
   target frame, the newest among the valid edges (none where no edge is
   valid);
2. with the IMU on and a positive ``mask_threshold``: 1e-3 where the two
   cameras' centres lie less than ``mask_threshold`` apart (the
   short-baseline mask);
3. with the IMU on and a positive ``far_threshold``: 1e-3 at each pixel of
   frame i whose inverse depth is below ``far_threshold``.

Poses are world-to-camera 7-vectors ``[t, qx, qy, qz, qw]``; a camera's
centre is ``-R^T t``.  Nothing here comes from the program.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from .geometry import quat_to_matrix


def centres(poses_cw: torch.Tensor) -> torch.Tensor:
    """Camera centres (N, 3) of world-to-camera poses (N, 7), float64."""
    p = poses_cw.double()
    R = quat_to_matrix(p[:, 3:])
    return -(R.transpose(-1, -2) @ p[:, :3, None])[..., 0]


def round_weights(w_all: torch.Tensor, ii, jj, mask, poses_cw: torch.Tensor,
                  disps: torch.Tensor, imu: bool, mask_threshold: float,
                  far_threshold: float) -> Tuple[torch.Tensor, Optional[List[bool]]]:
    """The weights (E, H, W, 2) float64 of edges ``ii`` -> ``jj`` (``mask``
    their validity) from the update operator's ``w_all``, and the edges the
    short-baseline mask down-weighted (None where it does not apply)."""
    ii, jj, mask = ([int(x) for x in torch.as_tensor(a).reshape(-1).tolist()]
                    for a in (ii, jj, mask))
    w = w_all.double().clone()
    valid = [k for k in range(len(ii)) if mask[k]]
    newest_i = max((ii[k] for k in valid), default=-1)
    newest_j = max((jj[k] for k in valid), default=-1)
    use_mask = imu and mask_threshold > 0
    c = centres(poses_cw)
    cut = []
    for k in range(len(ii)):
        f = 1.0
        if ii[k] == newest_i:
            f *= 0.1
        if jj[k] == newest_j:
            f *= 0.25
        short = use_mask and float(torch.linalg.norm(c[jj[k]] - c[ii[k]])) < mask_threshold
        cut.append(short)
        if short:
            f *= 1e-3
        w[k] *= f
        if imu and far_threshold > 0:
            far = disps[ii[k]].double() < far_threshold
            w[k][far] *= 1e-3
    return w, (cut if use_mask else None)
