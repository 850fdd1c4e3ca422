"""The port's DBAFusion entry points on the CPU, a source scan that keeps the
port free of JAX, and the shared pieces of the 16-frame golden trace of
``test_golden_trace.py`` (same config, weights and frames), whose two runs
have files of their own: ``test_torch_system_bf16_trace.py`` (the bf16
trace against the recorded one) and ``test_torch_system_f32_trace.py``
(the f32 network's trace against the JAX DBAFusion).
"""

import os
import re

import numpy as np
import pytest
import torch

from dbaf_tpu.models.convert import convert_state_dict
from tests.test_golden_trace import H, W, frame, synth_state_dict
from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)

N_FRAMES = 16
INTR = np.asarray([70.0, 70.0, W / 2, H / 2], np.float32)


def golden_cfg(m):
    return m.DBAFusionConfig(
        image_size=(H, W), buffer=24,
        graph=m.GraphConfig(
            max_factors=32, edge_capacity=48, inactive_capacity=48,
            frontend_window=5, frontend_radius=2, frontend_nms=1,
            frontend_thresh=20.0, max_age=25, inac_range=3,
            far_threshold=-1.0, mask_threshold=-1.0),
        frontend=m.FrontendConfig(
            warmup=8, keyframe_thresh=-1.0, filter_thresh=0.0,
            iters1=2, iters2=1, init_iters=4, rollup_start=1000,
            rollup_shift=8, active_window=12),
        ba=m.BAConfig(window=20, iters=2))


def _summary(system):
    for k in range(N_FRAMES):
        system.track(float(k), frame(k), intrinsics=INTR)
    traj = np.asarray(system.terminate(), np.float32)
    t1 = system.frontend.t1
    disps, fmap0 = system.video.disps[:t1], system.video.fmaps[0]
    if isinstance(disps, torch.Tensor):
        disps, fmap0 = disps.numpy(), fmap0.float().numpy()
    disps, fmap0 = np.asarray(disps), np.asarray(fmap0, np.float32)
    return {
        "traj": traj,
        "disp_mean": disps.mean(axis=(1, 2)),
        "disp_std": disps.std(axis=(1, 2)),
        "fmap0_absmean": np.abs(fmap0).mean(),
        "fmap0_slice": fmap0[2, 3, :8],
    }


@pytest.fixture(scope="module")
def params():
    return convert_state_dict(synth_state_dict())


def _port(params, dtype):
    from dbaf_tpu_torch.models.convert import from_jax_params
    from dbaf_tpu_torch.slam.system import DBAFusion
    from dbaf_tpu_torch.utils import config

    return DBAFusion(golden_cfg(config), params=from_jax_params(params), device="cpu",
                     dtype=dtype)


def test_port_imports_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = [os.path.join(root, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(root, "dbaf_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|dbaf_tpu(?!_torch))\b", re.M)
    bad = [f for f in files if pat.search(open(f).read())]
    assert not bad, bad
    assert len(files) > 10


def test_entry_points_need_a_card_or_an_explicit_cpu(params):
    from dbaf_tpu_torch.models.convert import from_jax_params
    from dbaf_tpu_torch.models.net import DroidNet
    from dbaf_tpu_torch.slam.system import DBAFusion
    from dbaf_tpu_torch.slam.video import DepthVideo
    from dbaf_tpu_torch.utils import config
    from dbaf_tpu_torch.utils.device import resolve_device

    assert resolve_device("cpu").type == "cpu"
    assert DepthVideo(golden_cfg(config), "cpu").poses.device.type == "cpu"
    if not torch.cuda.is_available():
        for make in (lambda: resolve_device(None), lambda: DroidNet(),
                     lambda: DepthVideo(golden_cfg(config)),
                     lambda: DBAFusion(golden_cfg(config), params=from_jax_params(params))):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
