"""ZUPT stop-and-go at phase 13b's BA window of 44 against the JAX package:
there the asynchronous pipeline misses two of ``tests/test_zupt.py:317``'s
bounds in the JAX package, positions within 5e-2 m of the synchronous flow
and its ATE rule, and the port misses them by as much (ROADMAP Queue 3).
At the test's own window of 32 both packages meet them
(``test_torch_zupt_e2e.py``).

The scene and feeds of ``tests/test_zupt.py`` (100 frames, the plateau fed
at one frame in eight) on ``chip_smoke.multisensor_config("zupt", ...)``
(``coupled_config``: window 44, rollup 36/15, the test's cull and ZUPT
settings) at a 64x128 image, the tests' 8x16 feature grid, with the
reference test's buffer of 80; keyframes fed straight into the video and
the oracle in the rounds.  The port's two runs share their frames up to the
pipeline's activation; the JAX package's two runs go in a spawned process.

Measured on one thread: the JAX package's async run ends 5.27e-2 m from
its sync run, the port's 5.12e-2 m; ATE 1.72e-2 m async and 2.85e-3 m sync
(JAX), 1.71e-2 and 2.94e-3 m (port), over a window spanning 1.06 m.
"""

import copy
import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest
import torch

from tests.test_torch_coupled import FPS, PortHarness
from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_coupled_async import scene
from tests.test_zupt import N_FRAMES, _admit, _simulate_warped

REF_TOL = 5e-2    # tests/test_zupt.py:345, async against sync
PORT_TOL = 3e-2   # the port against the JAX package (test_torch_coupled.py)


def port_config(coupled_async: bool):
    """chip_smoke's 13b configuration at a 64x128 image, buffer 80."""
    import chip_smoke
    from dbaf_tpu_torch.utils import config as tconfig

    orig = tconfig.tumvi_config

    def small():
        cfg = orig()
        cfg.image_size = (64, 128)
        return cfg

    tconfig.tumvi_config = small
    try:
        cfg = chip_smoke.multisensor_config("zupt", coupled_async)
    finally:
        tconfig.tumvi_config = orig
    cfg.buffer = 80
    return cfg


def jax_config(coupled_async: bool):
    from dbaf_tpu.utils import config as m

    pc = port_config(coupled_async)
    return m.DBAFusionConfig(
        image_size=pc.image_size, buffer=pc.buffer, graph=m.GraphConfig(**vars(pc.graph)),
        frontend=m.FrontendConfig(**vars(pc.frontend)), ba=m.BAConfig(**vars(pc.ba)),
        sensors=m.SensorConfig(**vars(pc.sensors)))


def window(h):
    """(keyframe stamps, positions) of the live window after the drain."""
    h.frontend.drain_async()
    c, t1 = h.graph.coupled, h.frontend.t1
    lo = c.last_t0
    return (np.asarray(h.video.tstamp[lo:t1]),
            np.asarray([c.state.wTbs[i].t for i in range(lo, t1)]))


def run_jax() -> dict:
    """The JAX package's async and sync runs, in a spawned process."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    from tests.test_slam_multisensor import MsHarness
    from tests.test_torch_coupled import INTR

    imu_rows, _, gt_cw, gt_disps = scene(N_FRAMES, _simulate_warped)
    out = {}
    for coupled_async in (True, False):
        h = MsHarness(jax_config(coupled_async), jnp.asarray(gt_cw), jnp.asarray(gt_disps), INTR,
                      imu_rows)
        for k in range(N_FRAMES):
            if _admit(k):
                h.feed(k)
        out[coupled_async] = window(h)
    return out


def run_port() -> dict:
    imu_rows, _, gt_cw, gt_disps = scene(N_FRAMES, _simulate_warped)
    h = PortHarness(port_config(True), gt_cw, gt_disps, imu_rows)
    sync = None
    for k in range(N_FRAMES):
        if not _admit(k):
            continue
        h.feed(k)
        ca = h.frontend._casync
        if sync is None and ca is not None and ca.active:
            sync = copy.deepcopy(h)
            sync.frontend.cfg.sensors.coupled_async = False
            sync.frontend._casync = None
        elif sync is not None:
            sync.feed(k)
    assert sync is not None, "the async pipeline never activated"
    assert h.frontend._casync.total_steps >= 10, h.frontend._casync.total_steps
    return {True: window(h), False: window(sync)}


@pytest.fixture(scope="module")
def runs():
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)  # a module fixture is set up before the autouse one
    try:
        with ProcessPoolExecutor(max_workers=1,
                                 mp_context=multiprocessing.get_context("spawn")) as ex:
            jax_runs = ex.submit(run_jax)
            port = run_port()
            return port, jax_runs.result()
    finally:
        torch.set_num_threads(n_threads)


def ate_rule(ate_s: float, span: float) -> float:
    """tests/test_zupt.py:347's bound on the async run's ATE."""
    return max(1.3 * ate_s, ate_s + 0.005 * span)


def test_async_gap_at_window_44_matches_jax(runs):
    from dbaf_tpu_torch.eval.ate import ate_rmse

    port, jx = runs
    stamps = port[False][0]
    for flows in (port, jx):
        for st, _ in flows.values():
            np.testing.assert_array_equal(st, stamps)  # the same keyframes in all four runs
    _, poses_at, _, _ = scene(N_FRAMES, _simulate_warped)
    ref = np.stack([poses_at[int(round(t * FPS))][1] for t in stamps])
    span = float(np.linalg.norm(ref.max(0) - ref.min(0)))
    gap, ate = {}, {}
    for name, f in (("port", port), ("jax", jx)):
        gap[name] = float(np.linalg.norm(f[True][1] - f[False][1], axis=1).max())
        ate[name] = {flow: ate_rmse(f[flow][1], ref, align="se3") for flow in (True, False)}
    print("async against sync at window 44:", gap, "ATE (async, sync):", ate, "span", span)
    # the reference's fault: its async run leaves its sync run past its own
    # test's bound at this window, and misses its ATE rule
    assert gap["jax"] > REF_TOL, gap
    assert ate["jax"][True] >= ate_rule(ate["jax"][False], span), ate
    # the port: each flow within the port's bound of the JAX package's, its
    # gap no larger than the reference's by more than that bound, and its
    # async run as accurate as the reference's by the reference's own rule
    for flow in (True, False):
        np.testing.assert_allclose(port[flow][1], jx[flow][1], atol=PORT_TOL)
    assert gap["port"] <= gap["jax"] + PORT_TOL, gap
    assert ate["port"][True] < ate_rule(ate["jax"][True], span), ate
    assert ate["port"][False] < 0.08 * span, ate
