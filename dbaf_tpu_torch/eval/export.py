"""Dense reconstruction export: filtered and raw keyframe point clouds
(port of ``dbaf_tpu/eval/export.py``).

The reference's ``save_vis_easy`` (dbaf.py:64-140): back-project the
archived keyframes, mask them by a multi-view depth-consistency vote and a
disparity floor, and pickle ``{points, cameras, stamps}`` for the viewers
(:mod:`dbaf_tpu_torch.eval.visualize`).  The back-projection and the vote
run on the system's device.
"""

from __future__ import annotations

import pickle
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..ops import lie, lie_np
from ..ops import projective as pj
from ..utils.device import resolve_device, to_host


def _points_and_counts(poses: torch.Tensor, disps: torch.Tensor, intrinsics: torch.Tensor,
                       thresh: torch.Tensor):
    """World points (N, H, W, 3) of every pixel and its depth-consistency
    votes (N, H, W), in one device -> host read."""
    N = poses.shape[0]
    points = pj.iproj_points(lie.se3_inv(poses), disps, intrinsics)
    count = pj.depth_consistency_count(poses, disps, intrinsics,
                                       torch.arange(N, device=poses.device), thresh)
    flat = to_host(torch.cat([points.reshape(N, -1), count.reshape(N, -1)], 1))
    HW = disps.shape[1] * disps.shape[2]
    return (flat[:, :3 * HW].reshape(points.shape), flat[:, 3 * HW:].reshape(count.shape))


def build_reconstruction(tstamps: np.ndarray, poses: np.ndarray, disps: np.ndarray,
                         images_small: np.ndarray, intrinsics: np.ndarray, filtered: bool = True,
                         device: Optional[Union[str, torch.device]] = None) -> Dict:
    """poses (N, 7) Tcw; disps (N, H, W); images_small (N, H, W, 3) BGR;
    intrinsics at the disparities' scale.  ``device`` (default: the card)
    runs the back-projection and the vote.

    ``filtered=True`` is the reference's strict mask (a vote of at least
    one neighbour at the median-scaled threshold, dbaf.py:77-89); False the
    permissive raw variant (:121-126).  Both keep pixels whose disparity is
    above half their keyframe's mean."""
    N = len(tstamps)
    if N == 0:
        return {"points": {}, "cameras": {}, "stamps": {}}
    dev = resolve_device(device)
    disps = np.asarray(disps, np.float32)
    mean_d = disps.reshape(N, -1).mean(axis=1)
    if filtered:
        thresh = 0.4 * np.ones(N) / 4.0 / max(np.median(mean_d), 1e-8)
    else:
        thresh = 0.4 * np.ones(N)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    points, count = _points_and_counts(t(poses), t(disps), t(intrinsics), t(thresh))

    min_count = 1 if filtered else 0
    mpoints, mcameras, mstamps = {}, {}, {}
    for i in range(N):
        Twc = lie_np.se3_matrix(lie_np.se3_inv(np.asarray(poses[i], np.float64)))
        mask = ((count[i] >= min_count) & (disps[i] > 0.5 * mean_d[i])).reshape(-1)
        pts = points[i].reshape(-1, 3)[mask]
        clr = images_small[i].reshape(-1, 3)[mask][:, ::-1] / 255.0
        mcameras[i] = Twc
        mpoints[i] = {"pts": pts, "clr": clr, "disp": disps[i], "rgb": images_small[i]}
        mstamps[i] = float(tstamps[i])
    return {"points": mpoints, "cameras": mcameras, "stamps": mstamps}


def save_reconstruction(system, path: str) -> None:
    """Write the filtered reconstruction to ``path`` and the raw one beside
    it (``<stem>_raw.pkl``) from a ``DBAFusion``'s archived keyframes and
    its live ones (needs ``cfg.save_pkl``), on the system's device."""
    v = system.video
    tstamps, poses, disps, images = v.export_rows(system.frontend.t1)
    intr = to_host(v.intrinsics)
    for filtered, suffix in ((True, ""), (False, "_raw")):
        d = build_reconstruction(tstamps, poses, disps, images, intr, filtered, system.device)
        out = path if not suffix else path.rsplit(".", 1)[0] + suffix + ".pkl"
        with open(out, "wb") as f:
            pickle.dump(d, f)
