"""RGB-D input through the port on the CPU, against the JAX package.

The scenario of ``tests/test_slam_e2e.py::test_rgbd_depth_anchors_metric_scale``
(``:198-227``: 14 keyframes fed straight into the video, each with the
scene's depth at pixels [3::8, 3::8], the oracle update operator in f32)
runs through both packages, and the JAX test's assertion holds on the port:
the median ratio of the live disparities to the truth lies in 0.9-1.1.
Culls and rollups go through ``DBAFusion.track`` with a depth map each
(``test_torch_stereo.track_run``), so ``disps_sens`` moves with every row.

Held, port against JAX: keyframes, timestamps, edges and ages exactly;
``disps_sens`` bit for bit (1/d of the same f32 depth); each live
``disps_sens`` row equal to its frame's true disparity within 1e-6
relative (the round trip 1/(1/d) in f32); poses within 1e-4 and
disparities within 1e-3 (f32 on both sides, sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_slam_e2e import H8, W8, Harness, make_cfg, make_scene
from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_stereo import (INTR, MOVES, PortHarness, assert_moves, assert_same,
                                     jax_feed, port_cfg, summary, track_run)


def depth_map(disp):
    """tests/test_slam_e2e.py:208-209: the depth at pixels [3::8, 3::8]."""
    depth = np.zeros((8 * H8, 8 * W8), dtype=np.float32)
    depth[3::8, 3::8] = 1.0 / disp
    return depth


def test_rgbd_scenario_matches_jax():
    jc = make_cfg()
    n = 14
    gt_poses, gt_disps = make_scene(n, INTR)
    jh = Harness(jc, jnp.asarray(gt_poses), jnp.asarray(gt_disps), INTR)
    ph = PortHarness(port_cfg(jc), gt_poses, gt_disps)
    for k in range(n):
        jax_feed(jh, k, depth=depth_map(gt_disps[k]))
        ph.feed(k, depth=depth_map(gt_disps[k]))
    p, j = summary(ph), summary(jh)
    assert ph.video.has_depth and jh.video.has_depth
    assert_same(p, j)
    np.testing.assert_array_equal(p["disps_sens"], j["disps_sens"])
    ids = np.round(p["ts"]).astype(int)
    np.testing.assert_allclose(p["disps_sens"], gt_disps[ids], rtol=1e-6)
    # the JAX test's assertion (tests/test_slam_e2e.py:222-227) on both
    t1 = p["t1"]
    for s in (p, j):
        ratio = np.median(s["disps"][1:t1 - 1] / gt_disps[1:t1 - 1])
        assert 0.9 < ratio < 1.1, ratio


@pytest.mark.parametrize("moves", sorted(MOVES))
def test_rgbd_track_matches_jax(moves):
    """DBAFusion.track with a depth map each through both packages, with
    culls or a rollup, the asynchronous pipeline configured (it never
    activates in the port; the JAX one declines sensor depth too,
    dbaf_tpu/slam/async_pipeline.py:431-441)."""
    p, j = track_run("port", "rgbd", **MOVES[moves]), track_run("jax", "rgbd", **MOVES[moves])
    assert_moves(p, moves)
    assert_same(p, j)
    np.testing.assert_array_equal(p["disps_sens"], j["disps_sens"])
    ids = np.round(p["ts"]).astype(int)
    np.testing.assert_allclose(p["disps_sens"], p["gt_disps"][ids], rtol=1e-6)
    assert np.all(np.isfinite(p["traj"]))


def _pipeline_run(depth_at):
    """The port's 16-frame visual pipeline run of test_torch_async_pipeline
    (pipeline on), a depth map fed with frame ``depth_at``; returns the
    system and whether the pipeline was active just before that frame."""
    from dbaf_tpu_torch.slam.system import DBAFusion
    from tests.test_async_pipeline import make_scene as scene
    from tests.test_torch_async_pipeline import INTR_FULL, frames, port_cfg as pipe_cfg, port_fns

    n = 16
    gt_poses, gt_disps = scene(n, INTR)
    cfg = pipe_cfg(True)
    fns = port_fns(gt_poses, gt_disps, cfg.buffer)
    sysm = DBAFusion(cfg, device="cpu", feat_fn=fns[0], ctx_fn=fns[1], update_fn=fns[2])
    active_before = None
    for k, img in enumerate(frames(n)):
        depth = None
        if k == depth_at:
            active_before = sysm._async.active
            depth = np.zeros((8 * H8, 8 * W8), np.float32)
            depth[3::8, 3::8] = 1.0 / gt_disps[k]
        sysm.track(float(k), img, depth=depth, intrinsics=INTR_FULL)
    return sysm, active_before, gt_disps


def test_depth_after_activation_drains_the_pipeline():
    """A depth map that arrives while the asynchronous visual pipeline is
    active is not dropped: the pipeline drains, the frame runs the
    synchronous flow with its depth row (the slot of frame 12), and the
    pipeline does not activate again."""
    sysm, active_before, gt_disps = _pipeline_run(depth_at=12)
    v = sysm.video
    assert active_before and not sysm._async.active and v.has_depth
    slot = int(np.nonzero(np.round(v.tstamp[:sysm.frontend.t1]) == 12)[0][0])
    np.testing.assert_allclose(v.disps_sens[slot].numpy(), gt_disps[12], rtol=1e-6)
    assert int((v.disps_sens[:sysm.frontend.t1] > 0).any(dim=(1, 2)).sum()) == 1
    assert sysm.frontend.t1 == 16 and np.all(np.isfinite(sysm.terminate()))


def test_reference_drops_depth_after_activation():
    """The JAX facade hands an active pipeline the image alone
    (dbaf_tpu/slam/system.py:146-153): a depth map fed then never reaches
    the video (a reference fault, ROADMAP Queue 3)."""
    from dbaf_tpu.slam.system import DBAFusion

    class ActivePipeline:
        active = True
        calls = []

        def track(self, *args, **kw):
            self.calls.append((args, kw))

    sysm = DBAFusion.__new__(DBAFusion)
    sysm._async = ActivePipeline()
    sysm.filter = sysm.frontend = None  # the synchronous flow would fail on these
    depth = np.ones((8 * H8, 8 * W8), np.float32)
    sysm.track(0.0, np.zeros((8 * H8, 8 * W8, 3), np.uint8), depth=depth)
    (args, kw), = ActivePipeline.calls
    assert len(args) == 2 and not kw  # (tstamp, image): the depth map is gone
