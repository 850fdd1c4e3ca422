"""The port's streaming runner (``apps/runner.py``) on the CPU: a
``DBAFusion(device="cpu")`` with the oracle of ``test_torch_async_pipeline``
and ``save_pkl`` driven by ``runner.run`` writes the TUM trajectory, both
reconstruction files and the JSON line; the JAX package's ``run`` on the
same trajectory gives the same line and the same files.  Also the weights
self-test on a reference-format checkpoint.
"""

import importlib
import json
import types

import numpy as np
import pytest
import torch

from tests.test_torch_async_pipeline import INTR_FULL, frames, port_cfg, port_fns
from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)


def _jax_runner(monkeypatch):
    """dbaf_tpu.apps.runner without its import-time persistent-cache setup
    (it would persist this worker's later JAX compiles)."""
    import dbaf_tpu.utils.jax_setup as js

    monkeypatch.setattr(js, "setup", lambda *a, **k: None)
    import dbaf_tpu.apps.runner as jr

    return importlib.reload(jr)


def _stub(traj, ecef=None):
    """Duck-typed system for both runners: a fixed trajectory."""
    return types.SimpleNamespace(track=lambda *a, **k: None, terminate=lambda: traj,
                                 trajectory_ecef=ecef or {},
                                 cfg=types.SimpleNamespace(save_pkl=False))


def test_run_writes_trajectory_export_and_ate(tmp_path, monkeypatch):
    from dbaf_tpu_torch.apps import runner
    from dbaf_tpu_torch.eval.traj_io import read_tum, write_tum
    from dbaf_tpu_torch.eval.visualize import load_reconstruction
    from dbaf_tpu_torch.ops import lie_np
    from dbaf_tpu_torch.slam.system import DBAFusion
    from tests.test_async_pipeline import make_scene

    n = 20
    cfg = port_cfg(False, rollup=(14, 4))
    cfg.save_pkl = True
    gt_poses, gt_disps = make_scene(n, INTR_FULL / 8.0)
    feat_fn, ctx_fn, update_fn = port_fns(gt_poses, gt_disps, cfg.buffer)
    system = DBAFusion(cfg, device="cpu", feat_fn=feat_fn, ctx_fn=ctx_fn, update_fn=update_fn)
    twc = lie_np.se3_inv(gt_poses.astype(np.float64))
    gt = np.concatenate([np.arange(n)[:, None], twc], 1)
    p_gt, p_traj, p_pkl = (str(tmp_path / x) for x in ("gt.txt", "traj.txt", "recon.pkl"))
    write_tum(p_gt, gt)
    stream = ((float(k), img, INTR_FULL) for k, img in enumerate(frames(n)))
    out = runner.run(system, stream, result_path=p_traj, pkl_path=p_pkl, gt_path=p_gt)

    fe = system.frontend
    assert fe.rollup_count >= 1 and len(system.video.saved_tstamps) > 0
    assert out["frames"] == n and out["keyframes"] == fe.keyframe_steps
    traj = read_tum(p_traj)
    assert traj.shape == (out["keyframes"], 8) and np.isfinite(traj).all()
    # monocular: the SE3-aligned ATE carries the unknown scale, so only its
    # matching is checked here
    assert out["matched"] == out["keyframes"] and np.isfinite(out["ate_rmse"])
    filt, raw = load_reconstruction(p_pkl), load_reconstruction(str(tmp_path / "recon_raw.pkl"))
    # one point block per keyframe: archived, then live, each once and in order
    stamps = list(filt["stamps"].values())
    assert stamps == list(raw["stamps"].values()) == sorted(set(stamps))
    assert len(stamps) == n  # every frame a keyframe (no culls here)

    # the JAX package's run on the same trajectory: the same line and file
    jr = _jax_runner(monkeypatch)
    p_j = str(tmp_path / "traj_jax.txt")
    jout = jr.run(_stub(traj), iter([(0.0, None, None)] * n), result_path=p_j, gt_path=p_gt)
    tout = runner.run(_stub(traj), iter([(0.0, None, None)] * n), gt_path=p_gt)
    assert jout.keys() == out.keys() == tout.keys()
    for k in jout:
        np.testing.assert_allclose(tout[k], jout[k], rtol=1e-12, err_msg=k)
    np.testing.assert_allclose(read_tum(p_j), traj, atol=1e-6)


def test_run_writes_ecef_columns_as_the_jax_runner(tmp_path, monkeypatch):
    from dbaf_tpu_torch.apps import runner

    traj = np.concatenate([np.arange(5)[:, None], np.ones((5, 7))], 1)
    ecef = {2: np.asarray([-2.1e6, 4.4e6, 4.0e6]), 4: np.asarray([1.5, 2.5, 3.5])}
    jr = _jax_runner(monkeypatch)
    a, b = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    jr.run(_stub(traj, ecef), iter([]), result_path=a)
    runner.run(_stub(traj, ecef), iter([]), result_path=b)
    with open(a) as fa, open(b) as fb:
        assert fa.read() == fb.read()


def test_weights_selftest_on_a_reference_checkpoint(tmp_path, capsys):
    from dbaf_tpu_torch.apps.runner import weights_selftest
    from dbaf_tpu_torch.models.convert import synth_reference_state_dict
    from tests.test_golden_trace import DATA

    with open(f"{DATA}/droid_sd_manifest.json") as f:
        manifest = json.load(f)
    sd = {k: torch.as_tensor(v) for k, v in synth_reference_state_dict(manifest, 5).items()}
    path = str(tmp_path / "droid.pth")
    torch.save(sd, path)
    out = weights_selftest(path)
    assert out == {"selftest": "ok", "weights": path, "fmap_shape": [1, 8, 10, 128],
                   "delta_ch": 2}
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    sd.pop("module.update.weight.2.weight")
    torch.save(sd, path)
    with pytest.raises((RuntimeError, ValueError)):
        weights_selftest(path)
