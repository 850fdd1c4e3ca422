"""The coupled scenario of ``tests/test_shard_video.py:89-135`` on two gloo
ranks with ``cfg.shard_video``, against the port's single-process run: the
device solver and the fused coupled step, 20 frames of the multi-sensor
scene at 10 fps with VI initialization at the 12-keyframe warmup (the
harness of ``test_torch_coupled.py``).  Held bit for bit on one torch
thread: the body positions and disparities of every keyframe and the
fused-step count; each rank holds half of the feature buffers' bytes.  The
single-process run is held to the JAX package by ``test_torch_coupled.py``.
"""

import numpy as np
import pytest
import torch

from tests import torch_ranks as ranks
from tests.test_slam_e2e import H8, W8, make_cfg, plane_disparity
from tests.test_slam_multisensor import FPS, simulate

INTR = np.asarray([16.0, 16.0, W8 / 2, H8 / 2], np.float32)
N_COUPLED = 20


def _coupled_args(shard):
    from dbaf_tpu_torch.ops import lie_np
    from dbaf_tpu_torch.utils import config as m

    imu_rows, poses_at = simulate(N_COUPLED / FPS + 0.5)
    gt_cw, gt_disps = [], []
    for k in range(N_COUPLED + 1):
        R, p = poses_at[k]
        Twc = np.eye(4)
        Twc[:3, :3], Twc[:3, 3] = R, p
        pose7 = lie_np.se3_from_matrix(np.linalg.inv(Twc)).astype(np.float32)
        gt_cw.append(pose7)
        gt_disps.append(plane_disparity(pose7, INTR, z0=4.0))
    jc = make_cfg(vi_warmup=12, keyframe_thresh=-1.0, rollup_start=1000)
    cfg = m.DBAFusionConfig(
        image_size=jc.image_size, buffer=jc.buffer,
        graph=m.GraphConfig(**vars(jc.graph)), frontend=m.FrontendConfig(**vars(jc.frontend)),
        ba=m.BAConfig(**vars(jc.ba)), sensors=m.SensorConfig(**vars(jc.sensors)))
    cfg.sensors.device_solver = True
    cfg.sensors.coupled_mega = True
    cfg.sensors.coupled_async = False
    cfg.shard_video = shard
    return (cfg, np.stack(gt_cw), np.stack(gt_disps), INTR, imu_rows, FPS, N_COUPLED)



@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from dbaf_tpu_torch.parallel import launch

    sharded = launch.run(ranks.coupled_scenario, 2, _coupled_args(True),
                         workdir=str(tmp_path_factory.mktemp("shard_coupled")), timeout=300)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = ranks.coupled_scenario(*_coupled_args(False))
    finally:
        torch.set_num_threads(n)
    return single, sharded


def test_shard_video_coupled_equivalence(runs):
    s, sharded = runs
    assert s["imu"] and s["megas"] > 0, "fused coupled keyframes did not run"
    for c in sharded:
        assert c["megas"] == s["megas"]
        np.testing.assert_array_equal(c["pos"], s["pos"])
        np.testing.assert_array_equal(c["disps"], s["disps"])
        assert 2 * c["feature_bytes"] == s["feature_bytes"]
