"""Port parity for the dense export and the trajectory files: the port's
``eval/export.py``, ``eval/traj_io.py``, ``eval/evaluate.py`` and the numpy
part of ``eval/visualize.py`` against the JAX package's, on the same numpy
inputs (CPU).

Tolerances.  ``build_reconstruction``: the same keyframes, masks and point
counts (the masks compare votes and a disparity floor, and no vote of this
scene lies within f32 round-off of its threshold), points within 1e-5 of
the largest |point| (f32 back-projection, sums in another order), colours
and the other entries equal.  ``evaluate``: the same matches and alignment
length, errors within 1e-9 (the same f64 numpy arithmetic).
"""

import pickle
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbaf_tpu.ops import lie as jl
from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)


def _keyframes(seed, N=12, H=12, W=16):
    """Keyframes moving along x in front of a slanted plane, with thumbnails."""
    rng = np.random.default_rng(seed)
    xi = np.zeros((N, 6), np.float32)
    xi[:, 0] = 0.04 * np.arange(N)
    xi[:, 3:] = 0.01 * rng.normal(size=(N, 3))
    poses = np.asarray(jl.se3_exp(jnp.asarray(xi)))
    v = np.arange(H, dtype=np.float32)[:, None]
    disps = np.broadcast_to(0.4 + 0.02 * v, (N, H, W)).astype(np.float32)
    disps = disps * (1.0 + 0.03 * rng.normal(size=(N, H, W))).astype(np.float32)
    images = rng.integers(0, 255, size=(N, H, W, 3)).astype(np.uint8)
    intr = np.asarray([14.0, 14.0, W / 2, H / 2], np.float32)
    return np.arange(N) * 0.1, poses, disps, images, intr


@pytest.mark.parametrize("filtered", [True, False], ids=["filtered", "raw"])
def test_build_reconstruction_matches_jax(filtered):
    from dbaf_tpu.eval.export import build_reconstruction as jbuild
    from dbaf_tpu_torch.eval.export import build_reconstruction

    args = _keyframes(3)
    j = jbuild(*args, filtered=filtered)
    t = build_reconstruction(*args, filtered=filtered, device="cpu")
    assert set(t) == {"points", "cameras", "stamps"}
    assert list(t["points"]) == list(j["points"]) == list(range(len(args[0])))
    scale = max(np.abs(e["pts"]).max() for e in j["points"].values() if len(e["pts"]))
    n_pts = 0
    for i in j["points"]:
        a, b = j["points"][i], t["points"][i]
        assert set(a) == set(b)
        assert len(b["pts"]) == len(a["pts"]), i
        np.testing.assert_allclose(b["pts"], a["pts"], atol=1e-5 * scale, rtol=0)
        np.testing.assert_array_equal(b["clr"], a["clr"])
        np.testing.assert_array_equal(b["disp"], a["disp"])
        np.testing.assert_array_equal(b["rgb"], a["rgb"])
        np.testing.assert_allclose(t["cameras"][i], np.asarray(j["cameras"][i]), atol=1e-12)
        assert t["stamps"][i] == j["stamps"][i]
        n_pts += len(a["pts"])
    # the vote drops some points; the raw mask keeps every pixel over the
    # disparity floor, which this scene's pixels all clear
    assert 0 < n_pts < args[2].size if filtered else n_pts == args[2].size


def _system(tmp_path, rollup_at=5):
    """A stand-in system for save_reconstruction: a DepthVideo with
    save_pkl whose rows went through one rollup (archiving them) and a
    live tail."""
    from dbaf_tpu_torch.slam.video import DepthVideo
    from dbaf_tpu_torch.utils.config import DBAFusionConfig

    stamps, poses, disps, images, intr = _keyframes(4)
    N, H, W = disps.shape
    cfg = DBAFusionConfig(image_size=(8 * H, 8 * W), buffer=16, save_pkl=True)
    v = DepthVideo(cfg, "cpu")
    for k in range(N):
        z = torch.zeros(H, W, 128)
        v.append(stamps[k], images[k], torch.tensor(poses[k]), None, torch.tensor(intr), z, z, z)
        v.disps[k] = torch.tensor(disps[k])
    v.rollup(rollup_at)
    frontend = types.SimpleNamespace(t1=v.counter)
    return types.SimpleNamespace(video=v, frontend=frontend, device=torch.device("cpu"),
                                 cfg=cfg), (stamps, poses, disps, images, intr)


def test_save_reconstruction_writes_both_files_and_reads_back(tmp_path):
    """The archive (a rollup's rows) and the live tail export in order, once
    each; the filtered and raw files load back and merge."""
    from dbaf_tpu_torch.eval.export import build_reconstruction, save_reconstruction
    from dbaf_tpu_torch.eval.visualize import camera_frustum, load_reconstruction, merge_points

    system, (stamps, poses, disps, images, intr) = _system(tmp_path)
    assert len(system.video.saved_tstamps) == 5 and system.video.archive_mark == 0
    out = str(tmp_path / "recon.pkl")
    save_reconstruction(system, out)
    filt = load_reconstruction(out)
    raw = load_reconstruction(str(tmp_path / "recon_raw.pkl"))
    np.testing.assert_array_equal(list(filt["stamps"].values()), stamps)
    for d, filtered in ((filt, True), (raw, False)):
        want = build_reconstruction(stamps, poses, disps, images, intr, filtered, "cpu")
        assert [len(e["pts"]) for e in d["points"].values()] == \
            [len(e["pts"]) for e in want["points"].values()]
    n_filt = sum(len(e["pts"]) for e in filt["points"].values())
    n_raw = sum(len(e["pts"]) for e in raw["points"].values())
    assert 0 < n_filt <= n_raw
    pts, clr = merge_points(raw)
    assert pts.shape == clr.shape == (n_raw, 3)
    assert merge_points(raw, max_points=100)[0].shape == (100, 3)
    assert len(merge_points(raw, z_clip=-1e9)[0]) == 0
    f = camera_frustum(filt["cameras"][0])
    np.testing.assert_allclose(f[0], filt["cameras"][0][:3, 3])
    assert f.shape == (5, 3)


def test_visualize_matches_jax(tmp_path):
    from dbaf_tpu.eval import visualize as jv
    from dbaf_tpu_torch.eval import visualize as tv
    from dbaf_tpu_torch.eval.export import save_reconstruction

    system, _ = _system(tmp_path)
    out = str(tmp_path / "r.pkl")
    save_reconstruction(system, out)
    recon = tv.load_reconstruction(out)
    for kw in ({}, {"max_points": 50}, {"z_clip": 2.0}):
        for a, b in zip(jv.merge_points(recon, **kw), tv.merge_points(recon, **kw)):
            np.testing.assert_array_equal(a, b)
    T = recon["cameras"][3]
    np.testing.assert_array_equal(jv.camera_frustum(T, 0.2), tv.camera_frustum(T, 0.2))
    with open(out, "rb") as f:
        assert pickle.load(f).keys() == recon.keys()


def test_traj_io_round_trip_and_evaluate_matches_jax(tmp_path):
    from dbaf_tpu.eval.evaluate import evaluate as jevaluate
    from dbaf_tpu_torch.eval import evaluate as tev
    from dbaf_tpu_torch.eval.traj_io import read_tum, write_tum

    rng = np.random.default_rng(7)
    t = np.arange(60) * 0.05
    ref = np.zeros((60, 8))
    ref[:, 0] = t
    ref[:, 1:4] = np.stack([np.sin(t), np.cos(0.7 * t), 0.3 * t], 1)
    ref[:, 7] = 1.0
    ref[30:, 0] += 150.0  # a ground-truth gap: the first alignment stops there
    est = ref.copy()
    est[:, 1:4] = 1.7 * est[:, 1:4] + 0.01 * rng.normal(size=(60, 3))
    est[:, 0] += 0.002
    p_est, p_ref = str(tmp_path / "est.txt"), str(tmp_path / "ref.txt")
    write_tum(p_est, est)
    with open(p_ref, "w") as f:
        f.write("# t x y z qx qy qz qw\n\n")
        f.write("\n".join(",".join(f"{x:.6f}" for x in r) for r in ref) + "\n")
    e2, r2 = read_tum(p_est), read_tum(p_ref)
    np.testing.assert_allclose(e2, est, atol=5e-7)
    np.testing.assert_allclose(r2, ref, atol=5e-7)
    for scale in (False, True):
        a = jevaluate(e2, r2, scale)
        b = tev.evaluate(e2, r2, scale)
        assert a.keys() == b.keys()
        assert a["matched"] == b["matched"] == 60 and a["n_to_align"] == b["n_to_align"] == 28
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-9, atol=1e-12, err_msg=k)
    assert tev.main([p_est, p_ref, "--scale"]) == tev.evaluate(e2, r2, True)
    assert tev.evaluate(e2[:2], r2)["matched"] == 2
