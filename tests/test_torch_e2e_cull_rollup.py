"""A visual run with keyframe culls and a rollup together, on the port:
``tests/test_slam_e2e.py:299``'s scenario and assertions (``slow`` in the
reference), with no JAX run.

The scene: 20 frames of ``make_scene``'s trajectory, frames 10-13 at 10 %
speed, so their flow falls far below ``keyframe_thresh`` 0.4 and they cull;
``rollup_start`` 12 with a shift of 4.  The assertions: at least one
rollup, gaps in the surviving frame ids (culls), the live window's
Sim3-aligned ATE under 0.08 x span, finite disparities.

The oracle is keyed by the scene frame, so culls and rollups can meet in
one run.  On the straight-fed harness (``tests/test_slam_e2e.py``'s
``Harness``) the frame id rides in ``graph.aux`` by slot, and the port moves
slot-keyed aux rows at every cull and rollup.  Through ``DBAFusion.track``
the asynchronous pipeline admits frames on the device, where the host
cannot write an aux row for the new slot, so there the frame id rides in
the frame itself: channel 0 of the context features at pixel (0, 0) holds
it (exact in bf16), those rows move with the video, and the oracle reads
the rows of ``ii`` and ``jj``.  On that route the synchronous flow and the
asynchronous pipeline must agree to the bit (every frame after activation
under ``NoHostRead``), and both must meet the reference's assertions.
"""

import numpy as np
import pytest
import torch

from tests.test_slam_e2e import H8, W8, make_cfg
from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_coupled_async import NoHostRead
from tests.test_torch_stereo import INTR, PortHarness, cull_rollup_scene, port_cfg

N = 20
CFG_KW = dict(keyframe_thresh=0.4, rollup_start=12, rollup_shift=4)


def e2e_asserts(t1, rollups, stamps, poses, disps, gt_poses):
    """test_slam_e2e.py:315-334 on a run's live window."""
    from dbaf_tpu_torch.eval.ate import ate_rmse
    from dbaf_tpu_torch.ops import lie_np

    gt_ids = np.round(stamps[:t1]).astype(int)
    assert rollups >= 1
    assert np.any(np.diff(gt_ids) > 1), gt_ids  # culls left gaps
    est = lie_np.se3_inv(poses[:t1].astype(np.float64))[:, :3]
    ref = lie_np.se3_inv(gt_poses[gt_ids].astype(np.float64))[:, :3]
    rmse = ate_rmse(est, ref, align="sim3")
    span = np.linalg.norm(ref.max(0) - ref.min(0))
    assert rmse < 0.08 * span, (rmse, span)
    assert np.all(np.isfinite(disps[:t1]))


def test_straight_fed_cull_and_rollup_meet_the_reference_bounds():
    gt_poses, gt_disps = cull_rollup_scene(N)
    h = PortHarness(port_cfg(make_cfg(**CFG_KW)), gt_poses, gt_disps)
    for k in range(N):
        h.feed(k)
    fe = h.frontend
    assert fe.is_initialized and fe.culls >= 1
    e2e_asserts(fe.t1, fe.rollup_count, h.video.tstamp, h.video.poses.numpy(),
                h.video.disps.numpy(), gt_poses)


def frame_keyed_fns(gt_poses, gt_disps, holder):
    """feat_fn, ctx_fn and an oracle update_fn for ``DBAFusion``: the frame
    id is the frame's top-left 8x8 block, which ctx_fn leaves unscaled in
    channel 0 of the context features; the oracle reads it back from the
    video's rows (``holder["video"]``)."""
    from dbaf_tpu_torch.ops import projective as pj

    gtp, gtd = torch.tensor(gt_poses), torch.tensor(gt_disps)
    intr8 = torch.tensor(INTR)

    def feat_fn(img):
        x = img[:, ::8, ::8, :].float() / 255.0
        return x[..., :1].repeat(1, 1, 1, 128).to(torch.bfloat16)

    def ctx_fn(img):
        f = img[:, ::8, ::8, :1].float().repeat(1, 1, 1, 128).to(torch.bfloat16)
        return f, f

    def update_fn(net, inp, corr, motn, ii, jj, aux):
        zeros = torch.zeros(net.shape[:-1] + (2,), dtype=torch.float32)
        if "coords1" not in aux:
            return net, zeros, zeros  # the motion-gate probe
        video = holder["video"]
        gi, gj = (video.feature_rows("inps", x)[:, 0, 0, 0].float().round().long()
                  for x in (ii, jj))
        target, valid = pj.projective_transform(gtp, gtd, intr8, gi, gj)
        delta = target - aux["coords1"]
        return net, delta.float(), valid.expand(delta.shape).float()

    return feat_fn, ctx_fn, update_fn


def run_track(async_on):
    """DBAFusion.track over the scene's frames; the frames after the
    pipeline's activation under NoHostRead."""
    from dbaf_tpu_torch.slam.system import DBAFusion

    gt_poses, gt_disps = cull_rollup_scene(N)
    cfg = port_cfg(make_cfg(**CFG_KW))
    cfg.frontend.filter_thresh = -1.0  # admit every frame, as the straight feed does
    cfg.frontend.async_pipeline = async_on
    holder = {}
    feat_fn, ctx_fn, update_fn = frame_keyed_fns(gt_poses, gt_disps, holder)
    sysm = DBAFusion(cfg, device="cpu", feat_fn=feat_fn, ctx_fn=ctx_fn, update_fn=update_fn)
    holder["video"] = sysm.video
    rng = np.random.default_rng(0)
    a = sysm._async
    guarded = 0
    for k in range(N):
        img = rng.integers(0, 255, size=(8 * H8, 8 * W8, 3)).astype(np.uint8)
        img[:8, :8] = k
        if a is not None and a.active:
            with NoHostRead():
                sysm.track(float(k), img, intrinsics=INTR * 8.0)
            guarded += 1
        else:
            sysm.track(float(k), img, intrinsics=INTR * 8.0)
    stats = None
    if async_on:
        active = a.active
        a.sync()  # applies the packs still in flight
        stats = dict(a.stats(), active=active)
    fe, v, g = sysm.frontend, sysm.video, sysm.graph
    t1 = fe.t1
    return dict(t1=t1, stamps=v.tstamp[:t1].copy(), poses=v.poses[:t1].numpy().copy(),
                disps=v.disps[:t1].numpy().copy(), ii=g.ii.copy(), jj=g.jj.copy(),
                age=g.age.copy(), rollups=fe.rollup_count, culls=fe.culls,
                traj=np.asarray(sysm.terminate()), stats=stats, guarded=guarded,
                gt_poses=gt_poses)


@pytest.fixture(scope="module")
def track_runs():
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)  # a module fixture is set up before the autouse one
    try:
        return run_track(True), run_track(False)
    finally:
        torch.set_num_threads(n_threads)


def test_track_cull_and_rollup_meet_the_reference_bounds(track_runs):
    for r in track_runs:
        assert r["culls"] >= 1
        e2e_asserts(r["t1"], r["rollups"], r["stamps"], r["poses"], r["disps"], r["gt_poses"])


def test_async_pipeline_matches_sync_to_the_bit(track_runs):
    a, s = track_runs
    st = a["stats"]
    # culls and the rollup ran inside the pipeline, which stayed active
    assert st["active"] and st["culls"] >= 1 and st["rollups"] >= 1 and st["host_rollups"] == 0
    assert a["guarded"] >= 8, a["guarded"]
    assert a["t1"] == s["t1"] and a["rollups"] == s["rollups"] and a["culls"] == s["culls"]
    for k in ("stamps", "poses", "disps", "ii", "jj", "age", "traj"):
        np.testing.assert_array_equal(a[k], s[k], err_msg=k)
