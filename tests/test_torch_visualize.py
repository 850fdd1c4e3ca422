"""The port's reconstruction viewers (``eval/visualize.py``): the still
view's PNG, the animation's frames and the command line, on a
reconstruction the port's ``save_reconstruction`` layout describes."""

import pickle

import numpy as np
import pytest

pytest.importorskip("matplotlib")


def _recon(n=5, seed=0):
    rng = np.random.default_rng(seed)
    cams, points = {}, {}
    for k in range(n):
        T = np.eye(4)
        T[:3, 3] = [0.3 * k, 0.05 * k, 0.0]
        cams[k] = T
        points[k] = dict(pts=rng.normal(size=(40, 3)) + T[:3, 3], clr=rng.random((40, 3)))
    points[n - 1] = dict(pts=np.zeros((0, 3)), clr=np.zeros((0, 3)))  # an empty block
    return {"cameras": cams, "points": points}


def test_view_matplotlib_writes_a_png(tmp_path, capsys):
    from dbaf_tpu_torch.eval.visualize import view_matplotlib

    out = tmp_path / "view.png"
    view_matplotlib(_recon(), str(out))
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n" and out.stat().st_size > 5000
    assert capsys.readouterr().out.strip() == f"saved {out}"


@pytest.mark.parametrize("stride,n_frames", [(1, 7), (3, 3)])
def test_animation_frame_count(tmp_path, stride, n_frames):
    from dbaf_tpu_torch.eval.visualize import _chase_pose, animate_matplotlib

    recon = _recon(7)
    frames = animate_matplotlib(recon, str(tmp_path / "anim"), stride=stride, dpi=40)
    assert len(frames) == n_frames
    assert [f.rsplit("_", 1)[1] for f in frames] == [f"{n:05d}.png" for n in
                                                     range(0, 7, stride)]
    # the chase view: the window mean of the last 5 poses, then the offset
    keys = sorted(recon["cameras"])
    v = _chase_pose(recon["cameras"], keys, 6, back=3.0, up=1.5)
    np.testing.assert_allclose(v[:3, :3] @ v[:3, :3].T, np.eye(3), atol=1e-12)
    np.testing.assert_allclose(v[:3, 3], np.mean([recon["cameras"][k][:3, 3] for k in keys[2:]],
                                                 axis=0) + [0.0, -1.5, -3.0], atol=1e-12)


def test_cli_picks_the_headless_viewer(tmp_path, capsys):
    """Without Open3D the CLI renders with matplotlib: ``--out`` a PNG,
    ``--animate DIR`` the frames (the JAX ``main``'s choice)."""
    from dbaf_tpu_torch.eval import visualize

    pkl = tmp_path / "recon.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(_recon(4), f)
    visualize.main([str(pkl), "--out", str(tmp_path / "v.png")])
    assert (tmp_path / "v.png").stat().st_size > 5000
    visualize.main([str(pkl), "--animate", str(tmp_path / "a"), "--stride", "2"])
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == ["frame_00000.png",
                                                                  "frame_00002.png"]
    assert capsys.readouterr().out.strip().splitlines()[-1] == f"wrote 2 frames to {tmp_path / 'a'}"
