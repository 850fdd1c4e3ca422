"""Dataset input streams: TUM-VI, EuRoC, KITTI-360, WHU, SubT (port of
``dbaf_tpu/data/streams.py``).

Host generators of ``(t, image_bgr (H, W, 3) float32, intrinsics[4])`` with
the reference's preprocessing: (fisheye) undistortion, an area-preserving
resize to multiples of 8 and optional CLAHE (demo_vio_tumvi.py:24-74,
163-168; demo_vio_kitti360.py:25-60).  The image functions need OpenCV and
import it when they run (``ImportError`` names ``cv2`` where it is
missing); the IMU, stamp and ground-truth readers are numpy alone.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np


def load_calib(path: str) -> np.ndarray:
    """Space-separated ``fx fy cx cy [dist...]`` (calib/*.txt)."""
    return np.loadtxt(path, delimiter=" ")


def _resize_multiple8(image: np.ndarray, target_area: int):
    import cv2

    h0, w0 = image.shape[:2]
    s = np.sqrt(target_area / (h0 * w0))
    h1, w1 = int(h0 * s), int(w0 * s)
    image = cv2.resize(image, (w1, h1))
    image = image[: h1 - h1 % 8, : w1 - w1 % 8]
    return image, (w1 / w0, h1 / h0)


def image_stream(imagedir: str, calib_path: str, stride: int = 1,
                 stamp_path: Optional[str] = None, stamp_scale: float = 1e-9,
                 stamp_delim: Optional[str] = ",", fisheye: Optional[bool] = None,
                 target_area: int = 384 * 512, clahe: bool = False,
                 undistort_size: Tuple[int, int] = (512, 512),
                 ) -> Iterator[Tuple[float, np.ndarray, np.ndarray]]:
    """Generic dataset stream.

    stamp_path: ``timestamp<delim>filename`` rows (TUM-VI/EuRoC csv; with
    ``stamp_delim=None`` whitespace, the KITTI-360 layout); without it the
    stamps parse from the file names.  ``fisheye=None`` takes the fisheye
    model when the calib has 4 distortion coefficients."""
    import cv2

    calib = load_calib(calib_path)
    fx, fy, cx, cy = calib[:4]
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    dist = calib[4:]
    if fisheye is None:
        fisheye = len(dist) == 4

    maps = None
    if len(dist) > 0:
        init = cv2.fisheye.initUndistortRectifyMap if fisheye else cv2.initUndistortRectifyMap
        maps = init(K, dist, np.eye(3), K, undistort_size, cv2.CV_32FC1)

    stamps = None
    if stamp_path is not None:
        raw = np.loadtxt(stamp_path, str, delimiter=stamp_delim)
        stamps = {row[1]: float(row[0]) * stamp_scale for row in raw}

    enhancer = cv2.createCLAHE(2.0, tileGridSize=(8, 8)) if clahe else None

    for imfile in sorted(os.listdir(imagedir))[::stride]:
        image = cv2.imread(os.path.join(imagedir, imfile))
        if image is None:
            continue
        if maps is not None:
            image = cv2.remap(image, maps[0], maps[1], interpolation=cv2.INTER_LINEAR,
                              borderMode=cv2.BORDER_CONSTANT)
        if stamps is not None:
            t = stamps[imfile]
        else:
            t = float(os.path.splitext(imfile)[0]) * stamp_scale

        image, (sx, sy) = _resize_multiple8(image, target_area)
        if enhancer is not None:
            mm = enhancer.apply(cv2.cvtColor(image, cv2.COLOR_BGR2GRAY))
            image = np.repeat(mm[:, :, None], 3, axis=2)

        intr = np.array([fx * sx, fy * sy, cx * sx, cy * sy], dtype=np.float32)
        yield t, image.astype(np.float32), intr


def tumvi_stream(datadir: str, calib_path: str, stride: int = 4):
    """TUM-VI: fisheye + CLAHE (demo_vio_tumvi.py:50-61, 163-168)."""
    return image_stream(os.path.join(datadir, "mav0/cam0/data"), calib_path, stride=stride,
                        stamp_path=os.path.join(datadir, "mav0/cam0/data.csv"),
                        fisheye=True, clahe=True)


def kitti360_stream(datadir: str, calib_path: str, stride: int = 2,
                    stamp_path: Optional[str] = None, stamp_scale: float = 1.0):
    """KITTI-360: plain undistortion (demo_vio_kitti360.py:25-60).

    stamp_path: whitespace ``timestamp filename`` rows mapping the
    frame-index file names to camera times (kitti360_to_hdf5.py:35-36)."""
    return image_stream(datadir, calib_path, stride=stride, stamp_path=stamp_path,
                        stamp_scale=stamp_scale, stamp_delim=None, fisheye=False,
                        target_area=320 * 896, undistort_size=(1408, 376))


def load_imu(path: str, time_scale: float = 1e-9, gyro_unit: str = "rad") -> np.ndarray:
    """IMU csv -> rows [t, gx, gy, gz (deg/s), ax, ay, az] (the internal
    convention, demo_vio_tumvi.py:156-159)."""
    raw = np.loadtxt(path, delimiter=",")
    out = raw[:, :7].astype(np.float64).copy()
    out[:, 0] *= time_scale
    if gyro_unit == "rad":
        out[:, 1:4] = np.rad2deg(out[:, 1:4])
    return out


def load_stamps(path: str, time_scale: float = 1e-9) -> np.ndarray:
    """The first column of a ``timestamp,filename`` csv, scaled, as (N, 1)."""
    raw = np.loadtxt(path, str, delimiter=",")
    return (raw[:, 0].astype(np.float64) * time_scale)[:, None]


def load_mocap_gt(path: str, time_scale: float = 1e-9) -> np.ndarray:
    """EuRoC/TUM-VI mocap csv (ns, p_xyz, q_wxyz) -> TUM rows
    [t(s), x, y, z, qx, qy, qz, qw] for the evaluation tools."""
    raw = np.loadtxt(path, delimiter=",", comments="#")
    out = np.zeros((len(raw), 8))
    out[:, 0] = raw[:, 0] * time_scale
    out[:, 1:4] = raw[:, 1:4]
    out[:, 4:7] = raw[:, 5:8]  # qx qy qz
    out[:, 7] = raw[:, 4]      # qw
    return out
