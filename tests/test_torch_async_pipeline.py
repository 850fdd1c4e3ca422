"""The asynchronous visual pipeline end to end on the CPU: the scenarios of
``tests/test_async_pipeline.py`` (its scene, oracle update operator and
configuration, ``:21-136``) through the port, with ``async_pipeline`` on and
off, and through the JAX package with it on.  One scenario per file: no
culls here (16 frames); ``_culls_rollups`` (28 frames), ``_rollup`` (the
rollup stays in the pipeline, 22 frames), ``_culls`` (18 frames),
``_rollups`` (26 frames), ``_late`` (every poll answers one poll late) and
``_gateonly`` (the gate rejects every frame after activation).

Each case holds port-async against port-sync with the JAX test's own
assertions (``t1``, keyframe timestamps, ``ii``/``jj``/``age`` equal,
poses within 1e-4; measured equal to the bit in all five scenarios), and
port-async against JAX-async with the same equalities and poses within
1e-4 as well: the oracle's targets and the dense BA are f32 on both sides,
and the two packages' poses differ by 1.7e-5 to 4.4e-5 across the five
scenarios (f32 sums in another order, compounded over the rounds).  The JAX run goes in a
spawned process, as in ``test_torch_coupled_async.py``.  Every frame after
the pipeline's activation runs under ``NoHostRead``, the CPU stand-in for
``torch.cuda.set_sync_debug_mode("error")``.
"""

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

from tests.test_async_pipeline import H8, W8, make_scene
from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_coupled_async import NoHostRead

INTR = np.asarray([16.0, 16.0, W8 / 2, H8 / 2], np.float32)
INTR_FULL = INTR * 8.0


def port_cfg(async_on, keyframe_thresh=-1.0, rollup=None):
    """test_async_pipeline.py::make_cfg in the port."""
    from dbaf_tpu_torch.utils import config as c

    cfg = c.DBAFusionConfig(
        image_size=(8 * H8, 8 * W8), buffer=24,
        graph=c.GraphConfig(
            max_factors=20, edge_capacity=24, inactive_capacity=24,
            frontend_window=5, frontend_radius=2, frontend_nms=1,
            frontend_thresh=20.0, max_age=10, inac_range=3,
            far_threshold=-1.0, mask_threshold=-1.0),
        frontend=c.FrontendConfig(
            warmup=8, keyframe_thresh=keyframe_thresh, filter_thresh=-1.0,
            iters1=2, iters2=1, init_iters=4, rollup_start=1000, rollup_shift=8,
            active_window=12, async_pipeline=async_on),
        ba=c.BAConfig(window=24, iters=2))
    if rollup is not None:
        cfg.frontend.rollup_start, cfg.frontend.rollup_shift = rollup
    return cfg


def port_fns(gt_poses, gt_disps, buffer):
    """test_async_pipeline.py::make_fns in torch: the oracle maps a slot to
    the scene frame of the same index (clipped as the JAX gather clips)."""
    from dbaf_tpu_torch.ops import projective as pj

    gtp, gtd = torch.tensor(gt_poses), torch.tensor(gt_disps)
    intr8 = torch.tensor(INTR)
    last = min(gtp.shape[0], buffer) - 1

    def update_fn(net, inp, corr, motn, ii, jj, aux):
        zeros = torch.zeros(net.shape[:-1] + (2,), dtype=torch.float32)
        if "coords1" not in aux:
            return net, zeros, zeros  # the motion-gate probe
        target, valid = pj.projective_transform(gtp, gtd, intr8, torch.clamp(ii, 0, last),
                                                torch.clamp(jj, 0, last))
        delta = target - aux["coords1"]
        return net, delta.float(), valid.expand(delta.shape).float()

    def feat_fn(img):
        x = img[:, ::8, ::8, :].float() / 255.0
        return x[..., :1].repeat(1, 1, 1, 128).to(torch.bfloat16)

    def ctx_fn(img):
        f = feat_fn(img)
        return f, f

    return feat_fn, ctx_fn, update_fn


def frames(n_frames, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, size=(n_frames, 8 * H8, 8 * W8, 3)).astype(np.uint8)


def run_port(async_on, n_frames=16, keyframe_thresh=-1.0, slow=(), rollup=None, poll=None,
             thresh_at=None):
    """test_async_pipeline.py::run through the port.  The frames after the
    pipeline's activation run under NoHostRead; ``poll`` replaces the
    pipeline's flag polls; ``thresh_at`` maps a frame index to the
    filter_thresh set just before it."""
    from dbaf_tpu_torch.slam.graph import MegaPolls
    from dbaf_tpu_torch.slam.system import DBAFusion

    gt_poses, gt_disps = make_scene(n_frames, INTR, slow=slow)
    cfg = port_cfg(async_on, keyframe_thresh, rollup)
    feat_fn, ctx_fn, update_fn = port_fns(gt_poses, gt_disps, cfg.buffer)
    sysm = DBAFusion(cfg, device="cpu", feat_fn=feat_fn, ctx_fn=ctx_fn, update_fn=update_fn)
    a = sysm._async
    if poll is not None:
        a.polls = MegaPolls(poll(), poll())
    guarded = 0
    for k, img in enumerate(frames(n_frames)):
        if thresh_at and k in thresh_at:
            cfg.frontend.filter_thresh = thresh_at[k]
        if a is not None and a.active:
            with NoHostRead():
                sysm.track(float(k), img, intrinsics=INTR_FULL)
            guarded += 1
        else:
            sysm.track(float(k), img, intrinsics=INTR_FULL)
    out = {}
    if async_on:
        assert a.active, "the pipeline is not active at the end of the run"
        a.sync()
        out["stats"] = a.stats()
    t1 = sysm.frontend.t1
    g = sysm.graph
    out.update(poses=sysm.video.poses[:t1].numpy(), ii=np.asarray(g.ii), jj=np.asarray(g.jj),
               age=np.asarray(g.age), t1=t1, ts=np.asarray(sysm.video.tstamp[:t1]),
               guarded=guarded, rollups=sysm.frontend.rollup_count,
               traj=np.asarray(sysm.terminate()))
    return out


def _run_jax_spawned(kw):
    import jax

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    from tests.test_async_pipeline import run

    p, ii, jj, age, t1, ts = run(True, **kw)
    return dict(poses=p, ii=ii, jj=jj, age=age, t1=t1, ts=ts)


def run_all(port_kw=None, **kw):
    """Port-async (with ``port_kw``) and port-sync here, JAX-async in a
    spawned process, on one scenario."""
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=1, mp_context=ctx) as ex:
        jax_run = ex.submit(_run_jax_spawned, kw)
        a = run_port(True, **kw, **(port_kw or {}))
        s = run_port(False, **kw)
        return a, s, jax_run.result()


def assert_same(a, b, atol=1e-4):
    """test_async_pipeline.py's assertions."""
    assert a["t1"] == b["t1"]
    np.testing.assert_array_equal(a["ts"], b["ts"])
    np.testing.assert_array_equal(a["ii"], b["ii"])
    np.testing.assert_array_equal(a["jj"], b["jj"])
    np.testing.assert_array_equal(a["age"], b["age"])
    np.testing.assert_allclose(a["poses"], b["poses"], atol=atol)


def check_scenario(a, s, j):
    assert_same(a, s)
    assert_same(a, j)
    # the trajectory rows come from the packs: the synchronous flow's rows
    np.testing.assert_array_equal(a["traj"][:, 0], s["traj"][:, 0])
    np.testing.assert_allclose(a["traj"][:, 1:], s["traj"][:, 1:], atol=1e-4)


def test_async_matches_sync_and_jax():
    a, s, j = run_all()
    check_scenario(a, s, j)
    assert a["stats"]["steps"] == 16 - 8  # every frame after initialization
    assert a["guarded"] == a["stats"]["steps"] - 1  # all but the activation frame
