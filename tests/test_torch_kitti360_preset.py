"""The KITTI-360 preset at the frames its stream yields: a 376 x 1408 image
through ``data/streams.kitti360_stream`` (resized to the area of 320 x 896,
cropped to multiples of 8) is ``kitti360_config().image_size``, 272 x 1032,
and ``DBAFusion`` built from the preset on the CPU takes it (a 34 x 129
feature grid, K1's wide path on the card)."""

import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")


def test_preset_is_the_streams_frame_and_the_system_takes_it(tmp_path):
    from dbaf_tpu_torch.data.streams import kitti360_stream
    from dbaf_tpu_torch.models.net import DroidNet
    from dbaf_tpu_torch.slam.system import DBAFusion
    from dbaf_tpu_torch.utils.config import kitti360_config

    imdir = tmp_path / "data_rgb"
    os.makedirs(imdir)
    rng = np.random.default_rng(0)
    image = cv2.GaussianBlur(rng.integers(0, 255, (376, 1408, 3)).astype(np.uint8), (5, 5), 1.5)
    cv2.imwrite(str(imdir / "0000000000.png"), image)
    calib = tmp_path / "kitti_360.txt"
    calib.write_text("552.554261 552.554261 682.049453 238.769549 -0.05 0.01 0.001 -0.001\n")
    (t, frame, intr), = list(kitti360_stream(str(imdir), str(calib), stride=1))

    cfg = kitti360_config()
    assert frame.shape == cfg.image_size + (3,) == (272, 1032, 3)
    assert cfg.feat_size == (34, 129)
    assert cfg.corr_whole_blocks  # 8 divides neither side: DROID's pyramid

    torch.manual_seed(0)
    torch.set_num_threads(2)
    model = DroidNet(dtype=torch.bfloat16, device=torch.device("cpu"), agg=False).eval()
    system = DBAFusion(cfg, device="cpu", feat_fn=model.features_only,
                       ctx_fn=model.context_only, update_fn=model.update_fn)
    system.track(t, frame, intrinsics=intr)
    assert system.video.counter == 1
    assert tuple(system.video.fmaps.shape[1:3]) == (34, 129)
    assert torch.isfinite(system.video.fmaps[0].float()).all()
