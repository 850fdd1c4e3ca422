"""The port's dataset streams (``data/streams.py``) against the JAX package's
on the same files: image folders written with cv2 into ``tmp_path`` in the
TUM-VI layout (4-coefficient fisheye calib, CLAHE, ``mav0/cam0/data.csv``),
the KITTI-360 layout (plain undistortion, whitespace stamp map) and the
generic layout (stamps from the file names, a stride).  Every ``(t, image,
intrinsics)`` must be equal bit for bit, and so must the calib, IMU (rad
and deg gyro), stamp and mocap readers.
"""

import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")


def _images(d, names, shape, seed):
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, size=(shape[0] + 16, shape[1] + 16, 3)).astype(np.uint8)
    base = cv2.GaussianBlur(base, (5, 5), 1.5)
    for k, name in enumerate(names):
        cv2.imwrite(os.path.join(d, name), base[k:k + shape[0], 2 * k:2 * k + shape[1]])


def _same_stream(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for (ta, ia, ka), (tb, ib, kb) in zip(a, b):
        assert ta == tb and type(ta) is type(tb)
        assert ia.dtype == ib.dtype == np.float32 and ia.shape == ib.shape
        np.testing.assert_array_equal(ia, ib)
        assert ka.dtype == kb.dtype
        np.testing.assert_array_equal(ka, kb)
    return a


def test_tumvi_stream_matches_jax(tmp_path):
    from dbaf_tpu.data import streams as js

    from dbaf_tpu_torch.data import streams as ps

    root = tmp_path / "dataset-room1_512_16"
    imdir = root / "mav0/cam0/data"
    ns = [1520530308199447626 + k * 50_000_000 for k in range(9)]
    names = [f"{t}.png" for t in ns]
    _images(str(imdir), names, (512, 512), 0)
    with open(root / "mav0/cam0/data.csv", "w") as f:
        f.write("#timestamp [ns],filename\n")
        for t, name in zip(ns, names):
            f.write(f"{t},{name}\n")
    calib = tmp_path / "tumvi.txt"
    calib.write_text("190.978 190.973 254.932 256.897 0.0034823 0.000715 -0.0020532 0.00020293\n")
    np.testing.assert_array_equal(ps.load_calib(str(calib)), js.load_calib(str(calib)))
    out = _same_stream(ps.tumvi_stream(str(root), str(calib), stride=4),
                       js.tumvi_stream(str(root), str(calib), stride=4))
    assert len(out) == 3 and out[0][1].shape == (440, 440, 3)  # area 384 x 512, multiples of 8
    assert out[1][0] == ns[4] * 1e-9
    # CLAHE: the three channels are one grey image
    np.testing.assert_array_equal(out[0][1][..., 0], out[0][1][..., 2])
    # the stamp reader of the demo's all_stamp
    np.testing.assert_array_equal(ps.load_stamps(str(root / "mav0/cam0/data.csv")),
                                  js.load_stamps(str(root / "mav0/cam0/data.csv")))


def test_kitti360_stream_matches_jax(tmp_path):
    from dbaf_tpu.data import streams as js

    from dbaf_tpu_torch.data import streams as ps

    imdir = tmp_path / "data_rgb"
    names = [f"{k:010d}.png" for k in range(4)]
    _images(str(imdir), names, (376, 1408), 1)
    stamps = tmp_path / "timestamps.txt"
    stamps.write_text("".join(f"{10.0 + 0.1 * k:.6f} {n}\n" for k, n in enumerate(names)))
    calib = tmp_path / "kitti_360.txt"
    calib.write_text("552.554261 552.554261 682.049453 238.769549 -0.05 0.01 0.001 -0.001\n")
    out = _same_stream(
        ps.kitti360_stream(str(imdir), str(calib), stride=2, stamp_path=str(stamps)),
        js.kitti360_stream(str(imdir), str(calib), stride=2, stamp_path=str(stamps)))
    assert len(out) == 2 and out[0][1].shape == (272, 1032, 3)  # area 320 x 896, multiples of 8
    assert out[1][0] == 10.2


def test_generic_stream_matches_jax(tmp_path):
    from dbaf_tpu.data import streams as js

    from dbaf_tpu_torch.data import streams as ps

    imdir = tmp_path / "cam_0"
    names = [f"{1600000000 + k * 0.125:.6f}.png" for k in range(7)]
    _images(str(imdir), names, (480, 640), 2)
    calib = tmp_path / "plain.txt"
    calib.write_text("400.0 401.0 320.5 240.5\n")  # no distortion: no remap
    for kw in (dict(stride=3, stamp_scale=1.0), dict(stride=2, stamp_scale=1.0, clahe=True,
                                                      target_area=320 * 640)):
        out = _same_stream(ps.image_stream(str(imdir), str(calib), **kw),
                           js.image_stream(str(imdir), str(calib), **kw))
        assert out[0][0] == 1600000000.0
    # a file that is no image is skipped by both
    (imdir / "zzz.png").write_text("not an image")
    _same_stream(ps.image_stream(str(imdir), str(calib), stamp_scale=1.0),
                 js.image_stream(str(imdir), str(calib), stamp_scale=1.0))


@pytest.mark.parametrize("unit,scale", [("rad", 1e-9), ("deg", 1.0)])
def test_imu_and_gt_readers_match_jax(tmp_path, unit, scale):
    from dbaf_tpu.data import streams as js

    from dbaf_tpu_torch.data import streams as ps

    rng = np.random.default_rng(3)
    t = (np.arange(50) * 5e-3 / scale).round(0 if scale < 1 else 6)
    rows = np.column_stack([t, rng.normal(size=(50, 6)), rng.normal(size=(50, 2))])
    path = tmp_path / "imu.csv"
    np.savetxt(path, rows, delimiter=",", fmt="%.9f")
    got = ps.load_imu(str(path), time_scale=scale, gyro_unit=unit)
    np.testing.assert_array_equal(got, js.load_imu(str(path), time_scale=scale, gyro_unit=unit))
    assert got.shape == (50, 7)
    raw = np.loadtxt(path, delimiter=",")
    np.testing.assert_array_equal(got[:, 0], raw[:, 0] * scale)
    np.testing.assert_array_equal(got[:, 1:4], raw[:, 1:4] if unit == "deg"
                                  else np.rad2deg(raw[:, 1:4]))

    gt = tmp_path / "mocap.csv"
    q = rng.normal(size=(20, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    body = np.column_stack([1e9 + np.arange(20) * 1e7, rng.normal(size=(20, 3)), q])
    with open(gt, "w") as f:
        f.write("#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], q_w, q_x, q_y, q_z\n")
        np.savetxt(f, body, delimiter=",", fmt="%.9f")
    got = ps.load_mocap_gt(str(gt))
    np.testing.assert_array_equal(got, js.load_mocap_gt(str(gt)))
    np.testing.assert_allclose(got[:, 7], body[:, 4], atol=1e-9)  # qw last (the file's 9 digits)
