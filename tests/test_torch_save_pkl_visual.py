"""``save_pkl`` on the asynchronous visual pipeline (the host-rollup route),
port-async against port-sync on the CPU.

Under ``save_pkl`` the step never rolls; once the host's lagged keyframe
count passes ``rollup_start`` it drains the pipeline, runs the synchronous
flow's rollup with its archival, and re-enters.  The scene is
``test_torch_async_pipeline.py``'s (30 frames, buffer 24, keyframe
threshold 0.12 with near-duplicate frames 19 and 20) with rollup 18/3, so
that the rows a rollup retires lie below every edge's reach
(``rollup_start - rollup_shift`` = 15 = ``active_window + inac_range``)
and no round refines them between the synchronous flow's rollup and the
host's later one; it holds one slot of headroom, so the drain batch is
clamped to 1.  The
oracle that reads the scene frame of a slot from a slot-keyed aux leaf
(``id_map``), which both flows roll at a rollup and move at a cull.  The
pipeline culls a keyframe in the step that triggers a host
rollup, so that rollup's drain finishes a pending cull
(``AsyncPipeline.sync``): it must move ``id_map`` with the video rows, as
the step and the synchronous flow do, or the rounds after it pair the
rows with the wrong scene frames.

Held as ``test_torch_async_pipeline.py`` holds its scenarios: the same
``t1``, keyframe stamps, edges and ages, poses within 1e-4, the same
trajectory rows; and the same export sequence (archive, then the live
tail: stamps each once and in order, the culled keyframe in neither,
poses within 1e-4).  The host sees its count ``LAG`` to ``LAG +
drain_batch - 1`` frames late, so it rolls that much after the
synchronous flow; where a run ends between the two rollups, slots and
edge indices are compared in absolute numbering (slot + rollups x shift)
over the slots both runs still hold.  Between the two rollups the frames
sit in other slots of the dense BA's system, so the two runs are the same
arithmetic in another order, not bit-equal (the in-step rollup of
``test_torch_async_pipeline_rollup.py`` is): the disparities are held
within ten times the synchronous flow's own spread when the scene's
disparities move by 1e-6 (relative), or 1e-4 where that is larger.

The synchronous flow's archive is also held against the JAX package's
synchronous run (in a spawned process) on the oracle of
``test_async_pipeline.py``, which maps a slot to the scene frame of the
same index (after a rollup, not the frame the slot holds: the scene then
culls nothing), the same scene and configuration: the same exported
stamps, poses within 1e-4 (the two packages' f32 sums run in other orders;
``test_torch_async_pipeline.py`` measured their poses 1.7e-5 to 4.4e-5
apart) and disparities within 1e-3 of their value, ten times the 1.02e-4
measured here: the monocular run's scale is free, and the packages' f32
sums move it, so every disparity of a keyframe differs by about the same
share.  Every frame after the pipeline's
activation runs under ``NoHostRead``; the host rollups' drains are marked
deliberate waits (``utils.device.host_wait``) and pass through it.
"""

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

from tests.test_async_pipeline import make_scene
from tests.test_torch_async_pipeline import (INTR, INTR_FULL, assert_same, frames, port_cfg,
                                             port_fns)
from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_coupled_async import NoHostRead

N_FRAMES = 30
SLOW = (19, 20)
ROLLUP = (18, 3)


def id_map_fns(gt_poses, gt_disps, buffer):
    """test_torch_async_pipeline.py::port_fns with the slot -> scene frame
    map read from ``aux["id_map"]``."""
    from dbaf_tpu_torch.ops import projective as pj

    feat_fn, ctx_fn, _ = port_fns(gt_poses, gt_disps, buffer)
    gtp, gtd = torch.tensor(gt_poses), torch.tensor(gt_disps)
    intr8 = torch.tensor(INTR)

    def update_fn(net, inp, corr, motn, ii, jj, aux):
        zeros = torch.zeros(net.shape[:-1] + (2,), dtype=torch.float32)
        if "coords1" not in aux:
            return net, zeros, zeros  # the motion-gate probe
        idm = aux["id_map"]
        target, valid = pj.projective_transform(gtp, gtd, intr8, idm[ii], idm[jj])
        delta = target - aux["coords1"]
        return net, delta.float(), valid.expand(delta.shape).float()

    return feat_fn, ctx_fn, update_fn


def run(async_on: bool, monkeypatch=None, perturb: float = 0.0) -> dict:
    from dbaf_tpu_torch.slam import async_pipeline as ap
    from dbaf_tpu_torch.slam.system import DBAFusion

    pending_at_sync = []
    if monkeypatch is not None:
        sync = ap.AsyncPipeline.sync

        def recording_sync(self):
            pending_at_sync.append(bool(self.state["prev_cull"]))
            return sync(self)

        monkeypatch.setattr(ap.AsyncPipeline, "sync", recording_sync)
    gt_poses, gt_disps = make_scene(N_FRAMES, INTR, slow=SLOW)
    if perturb:
        noise = np.random.default_rng(0).normal(size=gt_disps.shape)
        gt_disps = (gt_disps * (1.0 + perturb * noise)).astype(gt_disps.dtype)
    cfg = port_cfg(async_on, keyframe_thresh=0.12, rollup=ROLLUP)
    cfg.save_pkl = True
    feat_fn, ctx_fn, update_fn = id_map_fns(gt_poses, gt_disps, cfg.buffer)
    system = DBAFusion(cfg, device="cpu", feat_fn=feat_fn, ctx_fn=ctx_fn, update_fn=update_fn)
    system.graph.aux = {"id_map": torch.clamp(torch.arange(cfg.buffer), max=N_FRAMES - 1)}
    a = system._async
    guarded = 0
    for k, img in enumerate(frames(N_FRAMES)):
        if a is not None and a.active:
            with NoHostRead():
                system.track(float(k), img, intrinsics=INTR_FULL)
            guarded += 1
        else:
            system.track(float(k), img, intrinsics=INTR_FULL)
    fe, g, v = system.frontend, system.graph, system.video
    out = dict(guarded=guarded, pending_at_sync=list(pending_at_sync),
               drain_batch=a.drain_batch if a is not None else None,
               rollups=fe.rollup_count, culls=fe.culls)
    if async_on:
        out["stats"] = a.stats()
        a.sync()
    t1 = fe.t1
    out.update(poses=v.poses[:t1].numpy(), ii=np.asarray(g.ii), jj=np.asarray(g.jj),
               age=np.asarray(g.age), t1=t1, ts=np.asarray(v.tstamp[:t1]),
               export=v.export_rows(t1), traj=np.asarray(system.terminate()))
    return out


def _jax_sync_export():
    """The JAX package's synchronous run with save_pkl on
    test_async_pipeline.py's oracle; its export inputs (archive, then the
    live tail).  Runs in a spawned process, on the CPU."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    from dbaf_tpu.slam.system import DBAFusion as JSystem
    from tests.test_async_pipeline import make_cfg, make_fns

    gt_poses, gt_disps = make_scene(N_FRAMES, INTR, slow=SLOW)
    cfg = make_cfg(False, keyframe_thresh=0.12)
    cfg.frontend.rollup_start, cfg.frontend.rollup_shift = ROLLUP
    cfg.save_pkl = True
    feat_fn, ctx_fn, update_fn = make_fns(gt_poses, gt_disps, INTR, cfg.buffer)
    system = JSystem(cfg, feat_fn=feat_fn, ctx_fn=ctx_fn, update_fn=update_fn)
    for k, img in enumerate(frames(N_FRAMES)):
        system.track(float(k), img, intrinsics=INTR_FULL)
    system.frontend._resolve_pending()
    v, t1 = system.video, system.frontend.t1
    lo = v.archive_mark
    return (np.asarray(v.saved_tstamps + list(v.tstamp[lo:t1])),
            np.asarray(v.saved_poses + [np.asarray(v.poses[i]) for i in range(lo, t1)]),
            np.asarray(v.saved_disps + [np.asarray(v.disps[i]) for i in range(lo, t1)]))


def _port_sync_export():
    """The port's synchronous run on the same oracle and configuration."""
    from dbaf_tpu_torch.slam.system import DBAFusion

    gt_poses, gt_disps = make_scene(N_FRAMES, INTR, slow=SLOW)
    cfg = port_cfg(False, keyframe_thresh=0.12, rollup=ROLLUP)
    cfg.save_pkl = True
    feat_fn, ctx_fn, update_fn = port_fns(gt_poses, gt_disps, cfg.buffer)
    system = DBAFusion(cfg, device="cpu", feat_fn=feat_fn, ctx_fn=ctx_fn, update_fn=update_fn)
    for k, img in enumerate(frames(N_FRAMES)):
        system.track(float(k), img, intrinsics=INTR_FULL)
    assert system.frontend.rollup_count >= 2  # rows archived at each
    return system.video.export_rows(system.frontend.t1)[:3]


def test_save_pkl_visual_pipeline_matches_sync(monkeypatch):
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=1, mp_context=ctx) as ex:
        jax_run = ex.submit(_jax_sync_export)
        a = run(True, monkeypatch)
        s = run(False)
        port = _port_sync_export()
        jst, jpo, jdi = jax_run.result()
    np.testing.assert_array_equal(port[0], jst)
    np.testing.assert_allclose(port[1], jpo, atol=1e-4)
    np.testing.assert_allclose(port[2], jdi, rtol=1e-3, atol=0)
    st = a["stats"]
    assert st["host_rollups"] >= 2 and st["rollups"] == 0  # every roll on the host
    assert a["rollups"] == st["host_rollups"] and s["rollups"] - 1 <= a["rollups"] <= s["rollups"]
    assert any(a["pending_at_sync"]), a["pending_at_sync"]  # a cull pending at a drain
    assert a["culls"] == s["culls"] >= 1
    assert a["guarded"] == st["steps"] - 1  # every frame after the activation one
    assert a["drain_batch"] == 1
    shift = ROLLUP[1]
    oa, os_ = a["rollups"] * shift, s["rollups"] * shift
    lo = os_ - oa  # slots of the async run below the synchronous run's first
    absolute = dict(a, t1=a["t1"] - lo, ts=a["ts"][lo:], poses=a["poses"][lo:],
                    ii=a["ii"] - lo, jj=a["jj"] - lo)
    assert_same(absolute, s)
    np.testing.assert_array_equal(a["traj"][:, 0], s["traj"][:, 0])
    np.testing.assert_allclose(a["traj"][:, 1:], s["traj"][:, 1:], atol=1e-4)
    (st_a, po_a, di_a, im_a), (st_s, po_s, di_s, im_s) = a["export"], s["export"]
    np.testing.assert_array_equal(st_a, st_s)
    assert len(st_a) == N_FRAMES - a["culls"] and np.all(np.diff(st_a) > 0)
    np.testing.assert_allclose(po_a, po_s, atol=1e-4)
    spread = np.abs(run(False, perturb=1e-6)["export"][2] - di_s).max()
    np.testing.assert_allclose(di_a, di_s, atol=max(1e-4, 10.0 * spread), rtol=0)
    np.testing.assert_array_equal(im_a, im_s)
