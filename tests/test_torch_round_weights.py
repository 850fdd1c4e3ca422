"""The port's update-round BA weights (``slam/graph.py::round_weights``, the
confidence heuristics of covisible_graph.py:309-328) against the
benchmark's plain float64 reference (``perfbench/reference/heuristics.py``),
with the short-baseline mask, the IMU and the far-disparity mask each on
and off, on a small grid.

The port computes in float32: the weights agree to float32 rounding
(``rtol 1e-6``), the mask's flags exactly (the scene keeps every camera
distance more than 1e-3 m from the threshold)."""

import itertools

import numpy as np
import pytest
import torch

from dbaf_tpu_torch.ops import lie
from dbaf_tpu_torch.slam.graph import round_weights
from perfbench.reference import heuristics

MASK_THRESHOLD, FAR_THRESHOLD = 1.0, 0.4


def _scene(seed=3, N=7, E=12, H=4, W=6):
    g = torch.Generator().manual_seed(seed)
    # camera centres 0.3-0.9 m apart along a drive; world-to-camera poses
    centres = torch.cumsum(0.3 + 0.6 * torch.rand(N, 3, generator=g) * torch.tensor([1.0, 0.2, 0.1]),
                           0).double()
    q = torch.nn.functional.normalize(torch.randn(N, 4, generator=g).double(), dim=-1)
    t = -lie.quat_act(q, centres)
    poses = torch.cat([t, q], -1).float()
    ii = torch.randint(0, N, (E,), generator=g)
    jj = (ii + torch.randint(1, N, (E,), generator=g)) % N
    mask = torch.rand(E, generator=g) > 0.2
    mask[0] = True
    disps = 0.8 * torch.rand(N, H, W, generator=g)
    w_all = torch.rand(E, H, W, 2, generator=g)
    return w_all, ii, jj, mask, poses, disps


@pytest.mark.parametrize("use_mask,imu,far", list(itertools.product([True, False], repeat=3)),
                         ids=lambda v: "on" if v else "off")
def test_round_weights_match_the_plain_reference(use_mask, imu, far):
    w_all, ii, jj, mask, poses, disps = _scene()
    mt = MASK_THRESHOLD if use_mask else -1.0
    ft = FAR_THRESHOLD if far else -1.0
    got, cut = round_weights(w_all, ii, jj, mask, poses, disps, imu, mt, ft)
    want, ref_cut = heuristics.round_weights(w_all, ii, jj, mask, poses, disps, imu, mt, ft)
    d = torch.linalg.norm(heuristics.centres(poses)[jj] - heuristics.centres(poses)[ii], dim=-1)
    assert bool((torch.abs(d - MASK_THRESHOLD) > 1e-3).all())
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=1e-6, atol=0)
    if use_mask and imu:
        assert cut.tolist() == ref_cut and 0 < sum(ref_cut) < len(ref_cut)
    else:
        assert cut is None and ref_cut is None
    # every factor shows: the newest frames', and the masks' where on
    scale = (got.double() / w_all.double()).reshape(len(ii), -1)
    assert bool((scale.min(1).values < 0.3).any())
    if imu and (use_mask or far):
        assert bool((scale < 1e-2).any())
    else:
        assert bool((scale > 2e-2).all())
