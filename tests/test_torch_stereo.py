"""Stereo input through the port on the CPU, against the JAX package.

The scenario of ``tests/test_slam_e2e.py::test_stereo_mode_runs_with_self_edges``
(``:170-194``: keyframes fed straight into the video with a right-camera
feature row each, seeded noise, and the oracle update operator in f32) runs
through both packages.  Culls and rollups go through ``DBAFusion.track`` with
``image_right`` in both packages (the scene, oracle and configuration of
``tests/test_async_pipeline.py``: 18 frames with its slow frames, or 22
with a rollup at 12/4), so every row move of ``fmaps_right`` happens: fed
straight into the video, the JAX frontend resolves a cull one call late,
after the harness has mapped the next slot to its frame, so the two
packages' oracles would see different frames there.

Held, port against JAX: the keyframe count and timestamps, the edge lists
(self-edges included), their ages and the rollup count exactly;
``fmaps_right`` bit for bit; poses within 1e-4 and disparities within 1e-3
(the oracle's targets and the dense BA are f32 on both sides; their sums
run in another order, as in ``test_torch_async_pipeline.py``).  The JAX
test's own assertions hold on the port: self-edges exist and the poses are
finite.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_slam_e2e import H8, W8, Harness, make_cfg, make_scene
from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)

INTR = np.asarray([16.0, 16.0, W8 / 2, H8 / 2], np.float32)


def port_cfg(jc):
    """A JAX ``DBAFusionConfig`` in the port's config module."""
    from dbaf_tpu_torch.utils import config as m

    return m.DBAFusionConfig(
        image_size=jc.image_size, buffer=jc.buffer, stereo=jc.stereo, upsample=jc.upsample,
        graph=m.GraphConfig(**vars(jc.graph)), frontend=m.FrontendConfig(**vars(jc.frontend)),
        ba=m.BAConfig(**vars(jc.ba)))


def cull_rollup_scene(n=20):
    """test_e2e_with_culling_and_rollup's scene: frames 10-13 at 10 % speed."""
    speeds = np.where((np.arange(n) >= 10) & (np.arange(n) < 14), 0.1, 1.0)
    times = np.concatenate([[0.0], np.cumsum(speeds[1:])])
    return make_scene(n, INTR, times=times)


class PortHarness:
    """tests/test_slam_e2e.py::Harness in the port: keyframes fed straight
    into the video, the oracle's slot -> frame map in ``graph.aux``."""

    def __init__(self, cfg, gt_poses, gt_disps):
        from dbaf_tpu_torch.eval.synthetic import make_oracle
        from dbaf_tpu_torch.slam.frontend import Frontend
        from dbaf_tpu_torch.slam.graph import CovisibleGraph
        from dbaf_tpu_torch.slam.video import DepthVideo

        self.video = DepthVideo(cfg, torch.device("cpu"))
        self.id_map = np.zeros(cfg.buffer, dtype=np.int64)
        self.graph = CovisibleGraph(self.video, make_oracle(gt_poses, gt_disps, INTR), cfg)
        self.frontend = Frontend(self.video, self.graph, cfg)
        self.intr8 = torch.tensor(INTR)
        self.zeros = torch.zeros((H8, W8, 128), dtype=torch.bfloat16)

    def feed(self, k, depth=None, fmap_right=None):
        idx = self.video.counter
        self.video.append(float(k), None, None, None, self.intr8, self.zeros, self.zeros,
                          self.zeros, depth=None if depth is None else torch.tensor(depth),
                          fmap_right=None if fmap_right is None else torch.tensor(fmap_right))
        self.id_map[idx] = k
        self.graph.aux = {"id_map": torch.as_tensor(self.id_map)}
        self.frontend()
        n = self.video.counter
        self.id_map[:n] = np.round(self.video.tstamp[:n]).astype(np.int64)
        self.graph.aux = {"id_map": torch.as_tensor(self.id_map)}


def jax_feed(h, k, depth=None, fmap_right=None):
    """tests/test_slam_e2e.py's per-frame loop of the stereo and RGB-D cases."""
    idx = h.video.counter
    h.video.append(float(k), None, None, None, None if depth is None else jnp.asarray(depth),
                   h.intr8, h.zeros_feat, h.zeros_feat, h.zeros_feat,
                   fmap_right=None if fmap_right is None else jnp.asarray(fmap_right, jnp.bfloat16))
    h.id_map[idx] = k
    h.graph.aux = {"id_map": jnp.asarray(h.id_map)}
    h.frontend()
    h.id_map[: h.video.counter] = np.round(h.video.tstamp[: h.video.counter]).astype(np.int32)
    h.graph.aux = {"id_map": jnp.asarray(h.id_map)}


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def summary(h):
    if hasattr(h.frontend, "_resolve_pending"):  # the JAX frontend's deferred cull bookkeeping
        h.frontend._resolve_pending()
    t1 = h.frontend.t1
    v, g = h.video, h.graph
    out = dict(t1=t1, ts=np.asarray(v.tstamp[:t1]).copy(), ii=np.asarray(g.ii).copy(),
               jj=np.asarray(g.jj).copy(), age=np.asarray(g.age).copy(),
               rollups=h.frontend.rollup_count, poses=as_np(v.poses[:t1]),
               disps=as_np(v.disps[:t1]), disps_sens=as_np(v.disps_sens[:t1]))
    if v.fmaps_right is not None:
        out["fmaps_right"] = as_np(v.fmaps_right[:t1])
    return out


def assert_same(p, j, disp_atol=1e-3):
    assert p["t1"] == j["t1"]
    np.testing.assert_array_equal(p["ts"], j["ts"])
    np.testing.assert_array_equal(p["ii"], j["ii"])
    np.testing.assert_array_equal(p["jj"], j["jj"])
    np.testing.assert_array_equal(p["age"], j["age"])
    assert p["rollups"] == j["rollups"]
    np.testing.assert_allclose(p["poses"], j["poses"], atol=1e-4)
    np.testing.assert_allclose(p["disps"], j["disps"], atol=disp_atol)


def assert_moves(s, moves):
    """The run made its row moves: culls (gaps in the surviving frames, as
    test_e2e_with_culling_and_rollup asserts) or a rollup."""
    if moves == "culls":
        assert np.any(np.diff(np.round(s["ts"]).astype(int)) > 1), s["ts"]
    else:
        assert s["rollups"] >= 1


# the row moves of a track run: culls (the slow frames and cull threshold
# of test_torch_async_pipeline_culls.py, 18 frames) or rollups (rollup 12/4,
# 22 frames).  The oracle maps a slot to the scene frame of its index, so
# after the first cull every keyframe culls and t1 stops growing: one run
# cannot have both.
MOVES = {"culls": dict(n_frames=18, keyframe_thresh=0.12, slow=(10, 11, 14)),
         "rollup": dict(n_frames=22, rollup=(12, 4))}


def track_run(pkg, kind, n_frames, keyframe_thresh=-1.0, slow=(), rollup=None):
    """``DBAFusion.track`` through package ``pkg`` ("port" on the CPU or
    "jax") on the scene, oracle and configuration of
    ``tests/test_async_pipeline.py`` (asynchronous pipeline configured),
    fed ``kind`` input: "stereo" (a right frame each, ``cfg.stereo``) or
    "rgbd" (a depth map each, the scene's depth at pixels [3::8, 3::8], 0
    elsewhere).  Returns the run's summary."""
    from tests.test_async_pipeline import make_cfg as jax_cfg, make_fns, make_scene as scene
    from tests.test_torch_async_pipeline import INTR_FULL, frames, port_cfg as pipe_cfg, port_fns

    gt_poses, gt_disps = scene(n_frames, INTR, slow=slow)
    left, right = frames(n_frames), frames(n_frames, seed=1)
    if pkg == "port":
        from dbaf_tpu_torch.slam.system import DBAFusion

        cfg = pipe_cfg(True, keyframe_thresh, rollup)
        fns = port_fns(gt_poses, gt_disps, cfg.buffer)
        kw = dict(device="cpu")
    else:
        from dbaf_tpu.slam.system import DBAFusion

        cfg = jax_cfg(True, keyframe_thresh)
        if rollup is not None:
            cfg.frontend.rollup_start, cfg.frontend.rollup_shift = rollup
        fns = make_fns(gt_poses, gt_disps, INTR, cfg.buffer)
        kw = {}
    cfg.stereo = kind == "stereo"
    sysm = DBAFusion(cfg, feat_fn=fns[0], ctx_fn=fns[1], update_fn=fns[2], **kw)
    self_edges = []
    for k in range(n_frames):
        depth = None
        if kind == "rgbd":
            depth = np.zeros((8 * H8, 8 * W8), np.float32)
            depth[3::8, 3::8] = 1.0 / gt_disps[k]
        steps = sysm.frontend.keyframe_steps if pkg == "port" else None
        sysm.track(float(k), left[k], depth=depth, intrinsics=INTR_FULL,
                   image_right=right[k] if kind == "stereo" else None)
        if pkg == "port":
            assert not sysm._async.active, "the pipeline activated"
            if sysm.frontend.keyframe_steps > steps:
                self_edges.append(int(np.sum(sysm.graph.ii == sysm.graph.jj)))
    out = summary(sysm)
    out.update(self_edges=self_edges, gt_disps=gt_disps)
    if pkg == "port":
        out["right_feats"] = fns[0](torch.tensor(right)).float().numpy()
        out["traj"] = sysm.terminate()
    return out


def test_stereo_scenario_matches_jax():
    """tests/test_slam_e2e.py:170-194 (12 frames fed to the video, the
    oracle, no culls) through both packages."""
    jc = dataclasses.replace(make_cfg(), stereo=True)
    gt_poses, gt_disps = make_scene(12, INTR)
    right = np.random.default_rng(0).normal(size=(12, H8, W8, 128)).astype(np.float32)
    right = np.asarray(jnp.asarray(right, jnp.bfloat16), np.float32)  # exact in bf16
    jh = Harness(jc, jnp.asarray(gt_poses), jnp.asarray(gt_disps), INTR)
    ph = PortHarness(port_cfg(jc), gt_poses, gt_disps)
    for k in range(12):
        jax_feed(jh, k, fmap_right=right[k])
        ph.feed(k, fmap_right=right[k])
    p, j = summary(ph), summary(jh)
    assert_same(p, j)
    np.testing.assert_array_equal(p["fmaps_right"], j["fmaps_right"])
    # the JAX test's assertions (tests/test_slam_e2e.py:192-194)
    assert ph.frontend.is_initialized
    assert np.any(p["ii"] == p["jj"]), "no stereo self-edges"
    assert np.all(np.isfinite(p["poses"]))


@pytest.mark.parametrize("moves", sorted(MOVES))
def test_stereo_track_matches_jax(moves):
    """DBAFusion.track with image_right through both packages, with culls
    or a rollup, the asynchronous pipeline configured: it never activates
    in the port (the JAX one declines stereo too,
    dbaf_tpu/slam/async_pipeline.py:431-441); every keyframe's right row is
    its frame's right features after the row moves, bit for bit as in the
    JAX run; every keyframe step's edge set has self-edges (not the
    initialization's: its neighbourhood edges fill the 24-edge capacity)."""
    p, j = track_run("port", "stereo", **MOVES[moves]), track_run("jax", "stereo", **MOVES[moves])
    assert_moves(p, moves)
    assert_same(p, j)
    np.testing.assert_array_equal(p["fmaps_right"], j["fmaps_right"])
    np.testing.assert_array_equal(p["fmaps_right"],
                                  p["right_feats"][np.round(p["ts"]).astype(int)])
    assert len(p["self_edges"]) >= 8 and min(p["self_edges"]) > 0, p["self_edges"]
    assert np.all(np.isfinite(p["traj"]))
