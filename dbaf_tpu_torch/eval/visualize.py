"""Viewers of exported reconstructions (port of ``dbaf_tpu/eval/visualize.py``).

The reference's Open3D check scripts
(visualization/check_reconstruction_*.py:53-101): the per-keyframe point
clouds of a ``.pkl`` that :func:`dbaf_tpu_torch.eval.export.save_reconstruction`
writes, with camera frusta, as a still view or a growing animation.  Open3D
opens an interactive window where it is installed; matplotlib renders
headless.  Both are imported when a viewer runs.

    python -m dbaf_tpu_torch.eval.visualize reconstruction.pkl [--out view.png]
"""

from __future__ import annotations

import argparse
import os
import pickle
from typing import Optional, Tuple

import numpy as np


def load_reconstruction(path: str) -> dict:
    """A reconstruction this package wrote (pickle: load only trusted files)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def merge_points(recon: dict, max_points: int = 500000,
                 z_clip: Optional[float] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Every keyframe's points and colours, (M, 3) each, points at or above
    ``z_clip`` dropped; above ``max_points`` a seeded random subset."""
    pts_all, clr_all = [], []
    for entry in recon["points"].values():
        pts = np.asarray(entry["pts"])
        clr = np.asarray(entry["clr"])
        if len(pts) == 0:
            continue
        if z_clip is not None:
            m = pts[:, 2] < z_clip
            pts, clr = pts[m], clr[m]
        pts_all.append(pts)
        clr_all.append(clr)
    if not pts_all:
        return np.zeros((0, 3)), np.zeros((0, 3))
    pts = np.concatenate(pts_all)
    clr = np.concatenate(clr_all)
    if len(pts) > max_points:
        sel = np.random.default_rng(0).choice(len(pts), max_points, replace=False)
        pts, clr = pts[sel], clr[sel]
    return pts, clr


def camera_frustum(T: np.ndarray, scale: float = 0.1) -> np.ndarray:
    """The 5 points of a camera frustum wireframe (centre, 4 corners) in
    world coordinates, for a camera-to-world ``T`` (4, 4)."""
    corners = scale * np.array([[-1, -0.75, 1.5], [1, -0.75, 1.5], [1, 0.75, 1.5],
                                [-1, 0.75, 1.5]])
    pts = np.vstack([np.zeros(3), corners])
    return pts @ T[:3, :3].T + T[:3, 3]


def view_matplotlib(recon: dict, out: Optional[str] = None):
    """The merged points and every camera's frustum in one 3D view, saved
    to ``out`` (headless) or shown."""
    import matplotlib

    if out:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts, clr = merge_points(recon)
    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(projection="3d")
    if len(pts):
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c=np.clip(clr, 0, 1), s=0.5, linewidths=0)
    for T in recon["cameras"].values():
        f = camera_frustum(np.asarray(T))
        for i in range(1, 5):
            ax.plot(*zip(f[0], f[i]), c="r", lw=0.5)
    ax.set_box_aspect((1, 1, 1))
    if out:
        fig.savefig(out, dpi=150)
        print(f"saved {out}")
    else:
        plt.show()


def view_open3d(recon: dict):  # pragma: no cover - needs open3d and a display
    import open3d as o3d

    pts, clr = merge_points(recon)
    pcd = o3d.geometry.PointCloud()
    pcd.points = o3d.utility.Vector3dVector(pts)
    pcd.colors = o3d.utility.Vector3dVector(np.clip(clr, 0, 1))
    geoms = [pcd]
    for T in recon["cameras"].values():
        frame = o3d.geometry.TriangleMesh.create_coordinate_frame(size=0.1)
        frame.transform(np.asarray(T))
        geoms.append(frame)
    o3d.visualization.draw_geometries(geoms)


def _chase_pose(cameras: dict, keys, ix_pos: int, tilt_deg: float = 30.0, back: float = 21.0,
                up: float = 10.5) -> np.ndarray:
    """The follow camera: the mean of the last 5 keyframe poses (rotations
    through their rotation-vector mean), offset by a view tilted back (the
    reference animation's chase view,
    check_reconstruction_tumvi_animation.py:99-119)."""
    lo = max(0, ix_pos - 4)
    window = [np.asarray(cameras[k], np.float64) for k in keys[lo: ix_pos + 1]]
    pose = np.asarray(cameras[keys[ix_pos]], np.float64).copy()
    if len(window) > 1:
        from scipy.spatial.transform import Rotation as R

        rotvec = np.mean([R.from_matrix(T[:3, :3]).as_rotvec() for T in window], axis=0)
        pose[:3, :3] = R.from_rotvec(rotvec).as_matrix()
        pose[:3, 3] = np.mean([T[:3, 3] for T in window], axis=0)
    th = np.deg2rad(tilt_deg)
    view = np.array([
        [1.0, 0.0, 0.0, 0.0],
        [0.0, np.cos(th), np.sin(th), -up],
        [0.0, -np.sin(th), np.cos(th), -back],
        [0.0, 0.0, 0.0, 1.0],
    ])
    return pose @ view


def animate_matplotlib(recon: dict, out_dir: str, stride: int = 1, follow: bool = True,
                       dpi: int = 100):
    """The growing reconstruction, one PNG per ``stride`` keyframes (put
    them together with ffmpeg): points accumulate keyframe by keyframe, a
    red frustum marks the current camera and the view follows a smoothed
    trajectory window (the headless counterpart of the reference's Open3D
    animation, check_reconstruction_tumvi_animation.py:73-126)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    keys = sorted(recon["points"].keys())
    acc_pts, acc_clr = [], []
    written = []
    for n, k in enumerate(keys):
        entry = recon["points"][k]
        pts = np.asarray(entry["pts"])
        if len(pts):
            acc_pts.append(pts)
            acc_clr.append(np.asarray(entry["clr"]))
        if n % stride:
            continue
        fig = plt.figure(figsize=(8, 6))
        ax = fig.add_subplot(projection="3d")
        if acc_pts:
            P = np.concatenate(acc_pts)
            C = np.clip(np.concatenate(acc_clr), 0, 1)
            if len(P) > 200000:
                sel = np.random.default_rng(0).choice(len(P), 200000, replace=False)
                P, C = P[sel], C[sel]
            ax.scatter(P[:, 0], P[:, 1], P[:, 2], c=C, s=0.5, linewidths=0)
        T = np.asarray(recon["cameras"][k])
        f = camera_frustum(T, scale=0.2)
        for i in range(1, 5):
            ax.plot(*zip(f[0], f[i]), c="r", lw=1.0)
        if follow:
            fwd = _chase_pose(recon["cameras"], keys, n, back=3.0, up=1.5)[:3, 2]
            tgt = T[:3, 3]
            ax.set_xlim(tgt[0] - 3, tgt[0] + 3)
            ax.set_ylim(tgt[1] - 3, tgt[1] + 3)
            ax.set_zlim(tgt[2] - 3, tgt[2] + 3)
            ax.view_init(elev=30.0, azim=np.degrees(np.arctan2(fwd[1], fwd[0])))
        ax.set_axis_off()
        path = os.path.join(out_dir, f"frame_{n:05d}.png")
        fig.savefig(path, dpi=dpi)
        plt.close(fig)
        written.append(path)
    print(f"wrote {len(written)} frames to {out_dir}")
    return written


def animate_open3d(recon: dict, stride: int = 1,
                   screenshot_dir: Optional[str] = None):  # pragma: no cover - open3d, display
    """Interactive growing animation with the reference's chase camera
    (check_reconstruction_tumvi_animation.py:57-126)."""
    import open3d as o3d

    vis = o3d.visualization.Visualizer()
    vis.create_window()
    vis.get_render_option().point_size = 4
    vis.get_render_option().background_color = np.zeros(3)
    keys = sorted(recon["points"].keys())
    for n, k in enumerate(keys):
        if n % stride:
            continue
        entry = recon["points"][k]
        pts = np.asarray(entry["pts"])
        if len(pts):
            pcd = o3d.geometry.PointCloud()
            pcd.points = o3d.utility.Vector3dVector(pts)
            pcd.colors = o3d.utility.Vector3dVector(np.clip(np.asarray(entry["clr"]), 0, 1))
            vis.add_geometry(pcd, reset_bounding_box=(n == 0))
        frame = o3d.geometry.TriangleMesh.create_coordinate_frame(size=0.2)
        frame.transform(np.asarray(recon["cameras"][k]))
        vis.add_geometry(frame, reset_bounding_box=False)
        ctr = vis.get_view_control()
        params = ctr.convert_to_pinhole_camera_parameters()
        params.extrinsic = np.linalg.inv(_chase_pose(recon["cameras"], keys, n))
        ctr.convert_from_pinhole_camera_parameters(params)
        vis.poll_events()
        vis.update_renderer()
        if screenshot_dir:
            os.makedirs(screenshot_dir, exist_ok=True)
            vis.capture_screen_image(f"{screenshot_dir}/frame_{n:05d}.png")
    vis.destroy_window()


def main(argv=None):
    """View or animate a reconstruction: Open3D where it is installed (and
    no ``--out`` is given), else matplotlib, as the JAX viewer chooses."""
    ap = argparse.ArgumentParser()
    ap.add_argument("pkl")
    ap.add_argument("--out", default=None, help="save a PNG instead of showing")
    ap.add_argument("--animate", default=None, metavar="DIR",
                    help="per-keyframe animation: interactive (Open3D) or "
                         "PNG frames into DIR (headless)")
    ap.add_argument("--stride", type=int, default=1)
    args = ap.parse_args(argv)
    recon = load_reconstruction(args.pkl)
    if args.animate is not None:
        try:
            animate_open3d(recon, stride=args.stride, screenshot_dir=args.animate or None)
            return
        except ImportError:
            pass
        animate_matplotlib(recon, args.animate, stride=args.stride)
        return
    try:
        if args.out is None:
            view_open3d(recon)
            return
    except ImportError:
        pass
    view_matplotlib(recon, args.out)


if __name__ == "__main__":
    main()
