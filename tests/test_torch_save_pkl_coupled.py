"""``save_pkl`` on the asynchronous coupled pipeline, port-async against
port-sync: ``tests/test_flagship_outputs.py::test_save_pkl_rides_flagship_pipeline``
(slow in the JAX package) through the port, under its own assertions.

The step returns the rows an in-step rollup retires (``roll_out``) and the
host archives them at its next drain; the synchronous flow archives at the
window advance's marginalization and at its rollup.  The scenario is
``test_torch_coupled_async.py``'s 26-frame VIO scene with rollup 22/8,
the JAX test's configuration (no culls here; with culls in
``test_torch_save_pkl_coupled_culls.py``).  The JAX test runs 34 frames;
26 keep the file inside its time budget and still run the rollup inside
the pipeline (frame 22) with three async steps after it, the first of
which drains and archives the retired rows.  The synchronous run is a copy
of the harness taken at the pipeline's activation.

Held: the pipeline never drains (one activation, every later keyframe an
async step), a rollup runs in it, the same rollups in both runs, no archive
left pending; the export sequences (archive, then the live tail) have the
same stamps, each once and in order, and no culled keyframe (their count
is the frames fed less the culls); positions within 5e-2 m and
disparities within 2e-2 (the JAX test's bounds, ``:90-91``: the
synchronous flow archives a row's pose when the window leaves it, the
pipeline when the roll retires it); the full export writes one point
block per exported keyframe.
"""

import copy
import types

import numpy as np
import torch

from tests.test_torch_coupled import PortHarness
from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_coupled_async import config, scene


def run_pair(n_frames, **kw):
    """The port's async run with save_pkl, and its sync run from a copy
    taken at the pipeline's activation."""
    from dbaf_tpu_torch.utils import config as tconfig

    imu_rows, _, gt_cw, gt_disps = scene(n_frames)
    cfg = config(tconfig, rollup_start=22, **kw)
    cfg.save_pkl = True
    h = PortHarness(cfg, gt_cw, gt_disps, imu_rows)
    sync = None
    for k in range(n_frames):
        h.feed(k)
        ca = h.frontend._casync
        if sync is None and ca is not None and ca.active:
            sync = copy.deepcopy(h)
            sync.frontend.cfg.sensors.coupled_async = False
            sync.frontend._casync = None
        elif sync is not None:
            sync.feed(k)
    assert sync is not None, "the async pipeline never activated"
    h.frontend.drain_async()
    return h, sync


def check_pair(a, s, n_frames, tmp_path=None):
    ca = a.frontend._casync
    assert ca.total_steps >= 4, ca.total_steps
    assert ca.steps == ca.total_steps, (ca.steps, ca.total_steps)  # never drained
    assert a.frontend.rollup_count >= 1
    assert a.frontend.rollup_count == s.frontend.rollup_count
    assert ca.rollups >= 1  # inside the pipeline
    assert len(a.video.saved_tstamps) > 0 and not ca._pending_archive
    st_a, po_a, di_a, _ = a.video.export_rows(a.frontend.t1)
    st_s, po_s, di_s, _ = s.video.export_rows(s.frontend.t1)
    np.testing.assert_array_equal(st_a, st_s)
    assert len(np.unique(st_a)) == len(st_a) and np.all(np.diff(st_a) > 0)
    assert len(st_a) == n_frames - a.frontend.culls
    assert len(st_s) == n_frames - s.frontend.culls
    np.testing.assert_allclose(po_a[:, :3], po_s[:, :3], atol=5e-2)
    np.testing.assert_allclose(di_a, di_s, atol=2e-2)
    if tmp_path is not None:
        from dbaf_tpu_torch.eval.export import save_reconstruction
        from dbaf_tpu_torch.eval.visualize import load_reconstruction

        out = str(tmp_path / "recon.pkl")
        save_reconstruction(types.SimpleNamespace(video=a.video, frontend=a.frontend,
                                                  device=torch.device("cpu")), out)
        d = load_reconstruction(out)
        assert len(d["points"]) == len(d["cameras"]) == len(st_a)
        np.testing.assert_array_equal(list(d["stamps"].values()), st_a)
    return ca


def test_save_pkl_rides_the_coupled_pipeline(tmp_path):
    n = 26
    a, s = run_pair(n)
    ca = check_pair(a, s, n, tmp_path)
    assert ca.culls == 0
