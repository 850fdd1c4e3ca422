"""The save_pkl archive across a window advance that marginalizes no edge
(ROADMAP Queue 3: the reference can leave rows out of the archive).

The scenario: ``test_torch_coupled_async.py``'s 30-frame VIO scene on the
synchronous coupled flow (device factor graph, fused step) with culls
(``keyframe_thresh`` 0.05, ``translation_threshold`` 0.35), rollup 22/8
and ``save_pkl``.  Its first window advance moves the origin from frame 0
to 1 with no edge to marginalize, so nothing is archived there; the next
advance archives.  The port archives from its archive mark (``[0, t0)``),
the JAX package from the last window origin (``[1, t0)``,
``dbaf_tpu/slam/coupled.py:300-304``), and its later rollup archives only
from its mark on, so keyframe 0 never reaches its export.

Held on the port: every kept keyframe is exported exactly once and in
order (the frames fed less the culls), keyframe 0 among them.  The JAX
package's run of the same scene (in a spawned process) shows the gap: its
export is the port's without keyframe 0's stamp.
"""

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_coupled import INTR, PortHarness
from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_coupled_async import config, scene

N = 30
KW = dict(coupled_async=False, keyframe_thresh=0.05, translation_threshold=0.35, rollup_start=22)


def jax_export(n):
    """The JAX package's run: its export stamps (the archive, then the
    live rows from its archive mark) and its cull count."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    from dbaf_tpu.utils import config as jconfig
    from tests.test_slam_multisensor import MsHarness

    imu_rows, _, gt_cw, gt_disps = scene(n)
    cfg = config(jconfig, **KW)
    cfg.save_pkl = True
    h = MsHarness(cfg, jnp.asarray(gt_cw), jnp.asarray(gt_disps), INTR, imu_rows)
    for k in range(n):
        h.feed(k)
    v, t1 = h.video, h.frontend.t1
    stamps = list(v.saved_tstamps) + [float(t) for t in v.tstamp[v.archive_mark:t1]]
    return np.asarray(stamps), h.frontend.rollup_count


def test_archive_keeps_rows_below_an_advance_without_edges():
    from dbaf_tpu_torch.slam import coupled as tcoupled
    from dbaf_tpu_torch.utils import config as tconfig

    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=1, mp_context=ctx) as ex:
        jax_run = ex.submit(jax_export, N)
        # record each window advance: (old origin, new origin, edges marginalized)
        advances = []
        marg = tcoupled.MultiSensorBA._marginalize_device

        def recording(self, t0, t1):
            advances.append((self.last_t0, t0, int(np.sum(self._marg_idx(t0)))))
            return marg(self, t0, t1)

        tcoupled.MultiSensorBA._marginalize_device = recording
        try:
            imu_rows, _, gt_cw, gt_disps = scene(N)
            cfg = config(tconfig, **KW)
            cfg.save_pkl = True
            h = PortHarness(cfg, gt_cw, gt_disps, imu_rows)
            for k in range(N):
                h.feed(k)
        finally:
            tcoupled.MultiSensorBA._marginalize_device = marg
        j_stamps, j_rollups = jax_run.result()

    # the input: an advance with no marginalized edge, then one with edges
    assert advances[0] == (0, 1, 0), advances
    assert any(e > 0 for _, _, e in advances[1:]), advances
    fe = h.frontend
    assert fe.rollup_count >= 1 and fe.culls >= 1
    stamps, _, _, _ = h.video.export_rows(fe.t1)
    assert len(np.unique(stamps)) == len(stamps) and np.all(np.diff(stamps) > 0)
    assert len(stamps) == N - fe.culls
    assert stamps[0] == 0.0
    # the reference's export lacks keyframe 0, and nothing else
    assert j_rollups == fe.rollup_count
    np.testing.assert_array_equal(j_stamps, stamps[1:])
