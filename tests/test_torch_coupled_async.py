"""The asynchronous coupled pipeline end to end on the CPU: the 26-frame VIO
scenario of ``tests/test_coupled_async.py:22-64`` (8x16 feature grid,
10 fps, 200 Hz IMU, oracle update operator, VI init at the 12-keyframe
warmup, the device factor graph and the fused step on) through the port's
harness (``test_torch_coupled.py::PortHarness``), without culls here; with
culls in ``test_torch_coupled_async_culls.py``; with a rollup inside the
pipeline in ``test_torch_coupled_async_rollup.py``.

Each case holds port-async against port-sync at the bounds of
``test_coupled_async.py:76-115`` -- the same keyframe count, keyframe stamps,
edge sets and window origin, the live window's positions within 2e-2 m, and
the ATE rule (sync under 0.08 x span, async within 1.3 x sync or
sync + 0.005 x span) -- and port-async against the JAX package's async run:
the same keyframes and culls, positions within 3e-2 m and biases within
1e-4, the bounds of the synchronous port test (``test_torch_coupled.py``).
The async and sync port runs share their frames up to the pipeline's
activation: the harness is copied there, and the copy continues on the
synchronous flow.  The buffer (48) holds the whole window, so the JAX
package's clamped window slice (ROADMAP Queue 3) does not arise.

The no-cull case also runs five steady-state async keyframes under a guard
that fails on any host read outside the deliberate waits
(``utils.device.host_wait``): the CPU stand-in for the card case's
``torch.cuda.set_sync_debug_mode("error")``.
"""

import copy
import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import jax.numpy as jnp
import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dbaf_tpu_torch.utils import device as devmod
from tests.test_slam_multisensor import MsHarness
from tests.test_torch_coupled import FPS, INTR, PortHarness, _cfg, plane_disparity, simulate
from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)

aten = torch.ops.aten
# ops that read a device value back to the host (a scalar, or a size that
# depends on the data)
HOST_READS = {aten._local_scalar_dense.default, aten.nonzero.default,
              aten.masked_select.default, aten.repeat_interleave.Tensor,
              aten._unique2.default}


class NoHostRead(TorchDispatchMode):
    """Fails on a host read made outside ``host_wait``."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in HOST_READS and devmod.WAITING["depth"] == 0:
            raise AssertionError(f"host read {func} in a steady-state async step")
        return func(*args, **(kwargs or {}))


def scene(n_frames, simulate_fn=simulate):
    """The IMU rows, true poses, camera poses and plane disparities of
    ``n_frames`` frames of ``simulate_fn``'s trajectory."""
    from dbaf_tpu_torch.ops import lie_np

    imu_rows, poses_at = simulate_fn(n_frames / FPS + 0.5)
    gt_cw, gt_disps = [], []
    for k in range(n_frames + 1):
        R, p = poses_at[k]
        Twc = np.eye(4)
        Twc[:3, :3], Twc[:3, 3] = R, p
        pose7 = lie_np.se3_from_matrix(np.linalg.inv(Twc)).astype(np.float32)
        gt_cw.append(pose7)
        gt_disps.append(plane_disparity(pose7, INTR, z0=4.0))
    return imu_rows, poses_at, np.stack(gt_cw), np.stack(gt_disps)


def config(m, coupled_async=True, rollup_start=1000, keyframe_thresh=-1.0,
           translation_threshold=-1.0):
    """test_coupled_async.py's configuration in package ``m``."""
    cfg = _cfg(m)
    cfg.frontend.keyframe_thresh = keyframe_thresh
    cfg.frontend.translation_threshold = translation_threshold
    cfg.frontend.rollup_start = rollup_start
    cfg.frontend.rollup_shift = 8
    cfg.sensors.coupled_async = coupled_async
    return cfg


def summary(h, poses_at):
    """test_coupled_async.py::_run's readings after the drain."""
    h.frontend.drain_async()
    t1 = h.frontend.t1
    c = h.graph.coupled
    lo = c.last_t0
    stamps = np.asarray(h.video.tstamp[:t1])
    gt = np.round(stamps * FPS).astype(int)
    disps = h.video.disps[lo:t1]
    ca = h.frontend._casync
    return dict(
        t1=t1, lo=lo, stamps=stamps, est=np.asarray([c.state.wTbs[k].t for k in range(lo, t1)]),
        bs=np.asarray([c.state.bs[k] for k in range(lo, t1)]),
        ref=np.stack([poses_at[g][1] for g in gt[lo:t1]]),
        traj=np.stack([np.asarray(p, np.float64) for _, p in h.frontend.trajectory]),
        ii=np.sort(np.asarray(h.graph.ii)), jj=np.sort(np.asarray(h.graph.jj)),
        disps=np.asarray(disps.numpy() if isinstance(disps, torch.Tensor) else disps),
        steps=ca.total_steps if ca else 0, culls=ca.culls if ca else 0,
        active_steps=ca.steps if ca else 0, rollups=h.frontend.rollup_count,
        gnss=int(sum(map(bool, c.state.gnss_valid))), odo=int(sum(map(bool, c.state.odo_valid))))


def move_reinit(h, done: bool, reinit_after) -> bool:
    """Once VI init has run, move its recorded time back so the bias
    reinitialization (5 s after VI init) fires ``reinit_after`` s after it,
    inside a short scenario.  Returns whether it has been moved."""
    if reinit_after is None or done or not h.video.imu_enabled:
        return done
    h.graph.coupled.vi_init_time -= 5.0 - reinit_after
    return True


def attach_sensors(h, imu_rows, sensors):
    """Give a harness GNSS and odometry rows (``sensors``: ``gnss``, ``odo``
    and ``ten0``).  The GNSS rows are in the estimated world frame, so the
    run starts georeferenced, as ``test_coupled_async.py:246-249`` sets it
    (init_gnss's 10 m baseline is out of a room-scale scene's reach)."""
    if sensors is None:
        return
    h.frontend.set_multisensor(imu_rows, all_gnss=sensors["gnss"], all_odo=sensors["odo"],
                               visual_only=False)
    c = h.graph.coupled
    c.gnss_init_t1 = 1
    c.gnss_init_time = 1e-6
    c.ten0 = np.asarray(sensors["ten0"], float)


def run_port(n_frames, poll=None, guard=0, reinit_after=None, sensors=None, **kw):
    """The port's async run and, from a copy taken at the pipeline's
    activation, its sync run.  ``poll`` replaces the pipeline's FlagPolls;
    the first ``guard`` steady-state async frames run under NoHostRead;
    ``reinit_after`` moves the bias reinitialization (move_reinit);
    ``sensors`` attaches GNSS and odometry rows (attach_sensors)."""
    from dbaf_tpu_torch.slam.coupled_fused import RoundPolls
    from dbaf_tpu_torch.utils import config as tconfig

    imu_rows, poses_at, gt_cw, gt_disps = scene(n_frames)
    h = PortHarness(config(tconfig, **kw), gt_cw, gt_disps, imu_rows)
    attach_sensors(h, imu_rows, sensors)
    sync = None
    guarded = 0
    moved = False
    drains = []  # per drain inside a frame: whether the last async step culled
    for k in range(n_frames):
        ca = h.frontend._casync
        active = ca is not None and ca.active
        if guarded < guard and active:
            with NoHostRead():
                h.feed(k)
            guarded += 1
        else:
            pend_cull = active and bool(ca.state["prev_cull"])
            h.feed(k)
            if active and not ca.active:
                drains.append(pend_cull)
        moved = move_reinit(h, moved, reinit_after)
        ca = h.frontend._casync
        if sync is None and ca is not None and ca.active:
            sync = copy.deepcopy(h)
            sync.frontend.cfg.sensors.coupled_async = False
            sync.frontend._casync = None
            if poll is not None:
                ca.polls = RoundPolls(poll(), poll())
        elif sync is not None:
            sync.feed(k)
    assert sync is not None, "the async pipeline never activated"
    out = summary(h, poses_at), summary(sync, poses_at)
    out[0]["guarded"] = guarded
    out[0]["drains"] = drains
    out[0]["stats"] = h.frontend._casync.stats()
    return out


def run_jax(n_frames, reinit_after=None, sensors=None, **kw):
    from dbaf_tpu.utils import config as jconfig

    imu_rows, poses_at, gt_cw, gt_disps = scene(n_frames)
    cfg = config(jconfig, **kw)
    h = MsHarness(cfg, jnp.asarray(gt_cw), jnp.asarray(gt_disps), INTR, imu_rows)
    attach_sensors(h, imu_rows, sensors)
    moved = False
    for k in range(n_frames):
        h.feed(k)
        moved = move_reinit(h, moved, reinit_after)
    return summary(h, poses_at)


def _move_aux_at_drain():
    """Give the JAX package's drain the aux move of the port's.  Its
    ``CoupledAsync.sync`` finishes a pending cull on the host (video rows,
    edge stores, state merge) but leaves slot-keyed aux leaves -- the
    oracle's ``id_map`` -- in their pre-cull rows, which its own step moves
    when it applies a cull.  The rounds that follow a reinit drain in the
    same frame then pair the two slots above the culled one with the wrong
    frames, and that keyframe's decision-time row leaves the 2e-2 m bound
    from the synchronous flow's, in both packages and under input noise
    too.  The port's drain moves the rows (``coupled_async._cull_rows``)."""
    from dbaf_tpu.slam import coupled_async as jca

    sync = jca.CoupledAsync.sync

    def sync_moving_aux(self):
        pend_cull = self.active and bool(np.asarray(self.state["prev_cull"]))
        t1, in_flight = self._last_t1, self.fe.t1 - self._last_t1
        sync(self)
        if pend_cull:
            c, n, B = t1 - 2, 1 + in_flight, self.cfg.buffer
            g = self.fe.graph
            g.aux = {k: a.at[c:c + n].set(a[c + 1:c + 1 + n])
                     if getattr(a, "ndim", 0) >= 1 and a.shape[0] == B else a
                     for k, a in g.aux.items()}

    jca.CoupledAsync.sync = sync_moving_aux


def _run_jax_spawned(n_frames, kw):
    """run_jax in a spawned process, on the CPU as conftest pins JAX."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    if kw.get("reinit_after") is not None:
        _move_aux_at_drain()
    return run_jax(n_frames, **kw)


def run_both(n_frames, port_kw=None, **kw):
    """run_port here and run_jax in a spawned process, on the same scene.
    In a second thread the two runs' Python would take turns on the
    interpreter lock and finish later together than one after the other."""
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=1, mp_context=ctx) as ex:
        jax_run = ex.submit(_run_jax_spawned, n_frames, kw)
        a, s = run_port(n_frames, **(port_kw or {}), **kw)
        return a, s, jax_run.result()


def check_case(a, s, j, min_steps):
    """Port-async (a) against port-sync (s) and JAX-async (j)."""
    from dbaf_tpu_torch.eval.ate import ate_rmse

    assert a["steps"] >= min_steps, a["steps"]
    assert s["steps"] == 0
    # against the port's synchronous flow (test_coupled_async.py:76-115)
    assert a["t1"] == s["t1"]
    np.testing.assert_array_equal(a["stamps"], s["stamps"])
    np.testing.assert_array_equal(a["ii"], s["ii"])
    np.testing.assert_array_equal(a["jj"], s["jj"])
    assert a["lo"] == s["lo"]
    np.testing.assert_allclose(a["est"], s["est"], atol=2e-2)
    span = np.linalg.norm(s["ref"].max(0) - s["ref"].min(0))
    ate_a = ate_rmse(a["est"], a["ref"], align="se3")
    ate_s = ate_rmse(s["est"], s["ref"], align="se3")
    assert ate_s < 0.08 * span, (ate_s, span)
    assert ate_a < max(1.3 * ate_s, ate_s + 0.005 * span), (ate_a, ate_s)
    assert a["traj"].shape == s["traj"].shape
    # against the JAX package's asynchronous run
    assert j["steps"] >= min_steps and j["culls"] == a["culls"]
    assert a["t1"] == j["t1"] and a["lo"] == j["lo"]
    np.testing.assert_array_equal(a["stamps"], j["stamps"])
    np.testing.assert_allclose(a["est"], j["est"], atol=3e-2)
    np.testing.assert_allclose(a["bs"], j["bs"], atol=1e-4)
    np.testing.assert_allclose(a["traj"][:, :3], j["traj"][:, :3], atol=3e-2)


def test_async_matches_sync_and_jax_no_culls():
    a, s, j = run_both(26, port_kw=dict(guard=5))
    check_case(a, s, j, min_steps=6)
    assert a["culls"] == 0 and a["guarded"] == 5
    # no cull: every async keyframe pose agrees tightly, disparities too
    np.testing.assert_allclose(a["disps"], s["disps"], atol=5e-3)
    np.testing.assert_allclose(a["traj"][:, :3], s["traj"][:, :3], atol=2e-2)
    assert np.mean(np.linalg.norm(a["traj"][:, :3] - s["traj"][:, :3], axis=1)) < 5e-3
