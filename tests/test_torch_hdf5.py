"""The port's HDF5 frame cache (``data/hdf5.py``) against the JAX package's:
a round trip, a cache written by each package read by the other (one
pickled ``(t, image, intrinsics)`` tuple a key in both), and the converter's
command line for each ``--dataset`` against the JAX converter on the same
folder.
"""

import os

import numpy as np
import pytest

pytest.importorskip("h5py")
cv2 = pytest.importorskip("cv2")


def _stream(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [(0.1 * k, rng.uniform(0, 255, (16, 24, 3)).astype(np.float32),
             np.asarray([20.0, 21.0, 12.0, 8.0], np.float32)) for k in range(n)]


def _same(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for (ta, ia, ka), (tb, ib, kb) in zip(a, b):
        assert ta == tb
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(ka, kb)
        assert ia.dtype == ib.dtype and ka.dtype == kb.dtype


def test_round_trip_and_cross_package(tmp_path):
    from dbaf_tpu.data import hdf5 as jh

    from dbaf_tpu_torch.data import hdf5 as ph

    items = _stream()
    ph.convert_stream(iter(items), str(tmp_path / "port.h5"))
    jh.convert_stream(iter(items), str(tmp_path / "jax.h5"))
    _same(ph.h5_stream(str(tmp_path / "port.h5")), items)
    _same(jh.h5_stream(str(tmp_path / "port.h5")), items)  # the port's cache in JAX
    _same(ph.h5_stream(str(tmp_path / "jax.h5")), items)   # and the other way


def _folder(root, layout):
    """An image folder, calib and (by layout) stamp file; returns the CLI args."""
    rng = np.random.default_rng(1)
    base = cv2.GaussianBlur(rng.integers(0, 255, (120, 170, 3)).astype(np.uint8), (5, 5), 1.0)
    calib = root / "calib.txt"
    if layout == "tumvi":
        imdir = root / "seq/mav0/cam0/data"
        names = [f"{1000000000 + 50000000 * k}.png" for k in range(5)]
        calib.write_text("90.0 90.0 48.0 48.0 0.003 0.0007 -0.002 0.0002\n")
        shape = (96, 96)
    elif layout == "kitti360":
        imdir = root / "data_rgb"
        names = [f"{k:010d}.png" for k in range(5)]
        calib.write_text("100.0 100.0 80.0 30.0 -0.05 0.01 0.001 -0.001\n")
        shape = (64, 160)
    else:
        imdir = root / "cam_0"
        names = [f"{1000 + k}.png" for k in range(5)]
        calib.write_text("80.0 80.0 60.0 40.0\n")
        shape = (80, 120)
    os.makedirs(imdir)
    for k, n in enumerate(names):
        cv2.imwrite(str(imdir / n), base[k:k + shape[0], k:k + shape[1]])
    args = ["--dataset", layout, "--calib", str(calib), "--stride", "2"]
    if layout == "tumvi":
        with open(root / "seq/mav0/cam0/data.csv", "w") as f:
            f.writelines(f"{os.path.splitext(n)[0]},{n}\n" for n in names)
        return args + ["--datadir", str(root / "seq")]
    if layout == "kitti360":
        stamps = root / "timestamps.txt"
        stamps.write_text("".join(f"{1.5 + 0.1 * k:.3f} {n}\n" for k, n in enumerate(names)))
        args += ["--imagestamp", str(stamps)]
    return args + ["--datadir", str(imdir)]


@pytest.mark.parametrize("layout", ["tumvi", "kitti360", "generic"])
def test_cli_matches_jax(tmp_path, layout, capsys):
    from dbaf_tpu.data import hdf5 as jh

    from dbaf_tpu_torch.data import hdf5 as ph

    args = _folder(tmp_path, layout)
    ph.main(args + ["--out", str(tmp_path / "port.h5")])
    assert capsys.readouterr().out.strip() == f"wrote {tmp_path / 'port.h5'}"
    jh.main(args + ["--out", str(tmp_path / "jax.h5")])
    got = list(ph.h5_stream(str(tmp_path / "port.h5")))
    assert len(got) == 3  # five frames at stride 2
    _same(got, jh.h5_stream(str(tmp_path / "jax.h5")))
