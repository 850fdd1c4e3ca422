"""The port's WHU demo end to end on the CPU at the preset's full width
(320x640): ``demo_whu.setup`` from a user's argv (``--use_gnss --use_odo
--use_zupt``) over ``chip_smoke.py`` phase 11's sensor files, the real image
stream over PNG frames written with cv2 (400x800, the preset's aspect, so
the stream's resize gives 320x640), the seeded reference-format weights
from a ``.pth``, and ``runner.run``.  Held: the JSON line, the result
file (written, and empty: no keyframe step ran), every frame admitted at
the stream's stamps with finite features at the preset's grid, and the
sensors loaded as the demo loads them.

The seeded network's flow is no motion estimate, so, as phase 11 does, the
run admits every frame (``filter_thresh`` -1 after setup).  7 frames: the
8th starts initialization, 24 update rounds at 40x80, which take about
530 s on one CPU thread here (the plain correlation volume is 3200 x 3200
an edge); the frames before it run the stream, the gate and admission at
full width in a few seconds.  Phase 11 runs the keyframe steps on the card.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)

cv2 = pytest.importorskip("cv2")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
N_FRAMES = 7  # the 8th frame initializes (see above)


def test_demo_whu_runs_at_full_width(tmp_path, capsys):
    import chip_smoke as cs
    from dbaf_tpu_torch.apps import demo_whu, runner
    from dbaf_tpu_torch.utils.config import whu_config

    scene = cs.DemoScene("whu", 2 * N_FRAMES, whu_config().image_size)
    weights = cs.write_demo_weights(str(tmp_path / "droid.pth"))
    result = str(tmp_path / "result_whu.txt")
    argv = cs.write_demo_files("whu", scene, str(tmp_path / "whu"), weights, result,
                               str(tmp_path / "recon.pkl"))
    arg = dict(zip(argv, argv[1:]))
    rng = np.random.default_rng(0)
    base = cv2.GaussianBlur(rng.integers(0, 255, (464, 864, 3)).astype(np.uint8), (7, 7), 2.0)
    names = [line.split(",")[1].strip() for line in open(arg["--imagestamp"])]
    for j, name in enumerate(names[:2 * N_FRAMES]):  # the demo's stride 2 takes every other
        cv2.imwrite(os.path.join(arg["--imagedir"], name), base[j:j + 400, 2 * j:2 * j + 800])

    args = demo_whu.parse_args(argv)
    system, stream = demo_whu.setup(args, device="cpu")
    assert system.cfg.image_size == (320, 640) and not system.cfg.sensors.device_solver
    assert system.graph.coupled.ten0 is not None and len(system.frontend.all_gnss) > 0
    system.cfg.frontend.filter_thresh = -1.0
    capsys.readouterr()
    out = runner.run(system, stream, args.resultpath, args.pklpath, args.gtpath, args.max_frames)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    fe, v = system.frontend, system.video
    assert line == out == {"frames": N_FRAMES, "keyframes": 0}
    assert os.path.isfile(result) and open(result).read() == ""
    assert v.counter == N_FRAMES and not fe.is_initialized  # every frame admitted
    stamps = np.loadtxt(arg["--imagestamp"], str, delimiter=",")[::2, 0].astype(np.float64)
    np.testing.assert_array_equal(v.tstamp[:N_FRAMES], stamps[:N_FRAMES])
    assert v.fmaps.shape[1:3] == (40, 80)
    assert torch.isfinite(v.fmaps[:N_FRAMES].float()).all()
    assert torch.isfinite(v.nets[:N_FRAMES].float()).all()
    # the sensors as the demo loads them: IMU in seconds and deg/s, the GNSS
    # rows and the first fix as ten0, odometry at whole seconds
    np.testing.assert_allclose(fe.all_imu[:, 1:4], scene.imu[:, 1:4], rtol=1e-12)
    np.testing.assert_array_equal(system.graph.coupled.ten0, fe.all_gnss[0, 1:4])
    assert len(fe.all_odo) == 2 and list(fe.all_odo[:, 0]) == [0.0, 1.0]  # of 14 rows at 10 Hz
