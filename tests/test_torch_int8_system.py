"""``cfg.graph.corr_int8`` end to end on the CPU: ``DBAFusion`` with the
golden-trace configuration (``test_torch_system.py``) at 64 x 128 px, whose
8 x 16 feature grid holds one int8 tile of 128 pixels (the group-8 tile of
``corr_blk_layout``), the port's seeded random weights and procedural
frames.  Every update round -- initialization and fused keyframe steps --
runs the int8 variant's plain version, and the trajectory stays finite and
within 3e-2 of the same run with the bf16 correlation (measured 5.0e-3 to
7.4e-3 on 1, 3 and all CPU threads: the int8 volume moves the correlation
features by up to about 1% of their range, test_torch_corr.py, and the
random-weight update operator carries that onto the poses)."""

import numpy as np
import pytest

from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)

H, W, N_FRAMES = 64, 128, 12


def frame(k: int) -> np.ndarray:
    """tests/test_golden_trace.py::frame at this width."""
    y, x = np.mgrid[0:H, 0:W].astype(np.float64)
    img = np.zeros((H, W, 3))
    for c, (fx, fy, ph) in enumerate(((0.31, 0.17, 0.0), (0.12, 0.41, 1.3), (0.23, 0.29, 2.1))):
        img[..., c] = np.sin(fx * (x + 3.0 * k) + fy * (y + 1.5 * k) + ph)
    img += (0.4 * np.sin(0.05 * (x + 5.0 * k)) * np.cos(0.07 * y))[..., None]
    return np.clip(127.5 + 90.0 * img, 0, 255).astype(np.uint8)


def run(params, int8: bool, monkeypatch=None):
    from dbaf_tpu_torch.ops import corr_cuda
    from dbaf_tpu_torch.slam.system import DBAFusion
    from dbaf_tpu_torch.utils import config
    from tests.test_torch_system import golden_cfg

    cfg = golden_cfg(config)
    cfg.image_size = (H, W)
    cfg.graph.corr_int8 = int8
    calls = []
    if monkeypatch is not None:
        plain = corr_cuda.corr_fused_xy_int8

        def counted(*args):
            calls.append(args[-1])  # the tile
            return plain(*args)

        monkeypatch.setattr(corr_cuda, "corr_fused_xy_int8", counted)
    system = DBAFusion(cfg, params=params, device="cpu")
    intr = np.asarray([70.0, 70.0, W / 2, H / 2], np.float32)
    for k in range(N_FRAMES):
        system.track(float(k), frame(k), intrinsics=intr)
    fe = system.frontend
    return system.terminate(), fe.update_rounds, fe.keyframe_steps, calls


@pytest.fixture(scope="module")
def params():
    import json
    import os

    from dbaf_tpu_torch.models.convert import load_reference_state_dict, synth_reference_state_dict

    path = os.path.join(os.path.dirname(__file__), "data", "droid_sd_manifest.json")
    with open(path) as f:
        manifest = json.load(f)
    return load_reference_state_dict(synth_reference_state_dict(manifest, 20260820), manifest)


def test_int8_runs_in_every_round(params, monkeypatch):
    traj8, rounds, steps, calls = run(params, True, monkeypatch)
    traj, rounds_bf16, _, _ = run(params, False)
    assert steps >= 3 and rounds == rounds_bf16
    assert len(calls) == rounds and set(calls) == {128}
    assert traj8.shape == traj.shape and np.all(np.isfinite(traj8))
    np.testing.assert_array_equal(traj8[:, 0], traj[:, 0])
    np.testing.assert_allclose(traj8[:, 1:], traj[:, 1:], atol=3e-2)
