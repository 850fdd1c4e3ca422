"""The reference's live monitor as file dumps (port of
``dbaf_tpu/eval/monitor.py``).

The reference opens a live matplotlib window with three panels (trajectory
against ground truth, attitude or attitude error, gyroscope bias) refreshed
at every rollup (dbaf/dbaf_frontend.py:76-83, 278-314), and optional cv2
debug windows: the oldest keyframe's disparity, the newest edge's
flow/weight overlay and the covisibility graph
(dbaf/covisible_graph.py:252-307).  Without a display this module renders
the same content to PNG files in a monitor directory: one summary figure a
rollup, and the debug views with it when enabled.  It is switched on by
``cfg.frontend.monitor_dir`` (``--monitor DIR`` on the demos).

Rendering needs matplotlib and OpenCV, imported when a dump runs; recording
a keyframe needs neither.  The attitude is recorded in degrees
(``matrix_to_ypr`` gives degrees; the JAX module converts them once more).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

import numpy as np

from ..utils.geodesy import matrix_to_ypr

__all__ = ["Monitor"]


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


class Monitor:
    """File-based counterpart of the reference's ``show_plot`` monitor.

    outdir: directory for the PNG dumps (created if missing).
    gt_lookup: optional ``t -> 4x4 T_wb`` ground truth; with it the
    trajectory panel overlays the reference track and the attitude panel
    shows the attitude error (dbaf_frontend.py:283-291).
    debug_views: also dump the disparity, flow/weight and covisibility
    images at each summary (covisible_graph.py:252-307).
    """

    def __init__(self, outdir: str,
                 gt_lookup: Optional[Callable[[float], Optional[np.ndarray]]] = None,
                 debug_views: bool = True):
        self.outdir = outdir
        os.makedirs(outdir, exist_ok=True)
        self.gt_lookup = gt_lookup
        self.debug_views = debug_views
        self.t: List[float] = []
        self.pos: List[np.ndarray] = []       # world position
        self.pos_ref: List[np.ndarray] = []
        self.att: List[np.ndarray] = []       # yaw, pitch, roll in degrees (error with gt)
        self.bg: List[np.ndarray] = []        # gyro bias
        self.dumps: Dict[str, int] = {}

    # -- recording ------------------------------------------------------
    def record_keyframe(self, t: float, T_wb: np.ndarray,
                        gyro_bias: Optional[np.ndarray] = None) -> None:
        """Append one keyframe sample (dbaf_frontend.py:278-295); ``T_wb``
        is the 4x4 world-from-body pose."""
        T_wb = np.asarray(T_wb, np.float64)
        self.t.append(float(t))
        self.pos.append(T_wb[:3, 3].copy())
        a1 = matrix_to_ypr(T_wb[:3, :3])
        if self.gt_lookup is not None:
            gt = self.gt_lookup(float(t))
            if gt is not None:
                gt = np.asarray(gt, np.float64)
                self.pos_ref.append(gt[:3, 3].copy())
                a1 = a1 - matrix_to_ypr(gt[:3, :3])
        self.att.append(a1)
        self.bg.append(np.zeros(3) if gyro_bias is None
                       else np.asarray(gyro_bias, np.float64).copy())

    # -- summary figure (per rollup) -------------------------------------
    def dump_summary(self, tag: Optional[str] = None) -> str:
        """Write the 3-panel monitor figure (dbaf_frontend.py:298-314)."""
        plt = _plt()
        n = self.dumps.get("summary", 0)
        self.dumps["summary"] = n + 1
        path = os.path.join(self.outdir, f"{tag or f'monitor_{n:04d}'}.png")

        fig, axes = plt.subplots(1, 3, figsize=(13, 4))
        ax = axes[0]
        ax.set_title("Trajectory")
        if self.pos:
            p = np.asarray(self.pos)
            ax.plot(p[:, 0], p[:, 1], marker="^", ms=2, label="estimate")
        if self.pos_ref:
            pr = np.asarray(self.pos_ref)
            ax.plot(pr[:, 0], pr[:, 1], marker="^", ms=2, label="reference")
            ax.legend(fontsize=7)
        ax.set_aspect("equal", adjustable="datalim")

        ax = axes[1]
        ax.set_title("Attitude Error/Attitude")
        if self.att:
            a = np.asarray(self.att)
            for k, c in enumerate("rgb"):
                ax.plot(self.t, a[:, k], c=c, lw=0.8)
            if self.gt_lookup is not None:
                ax.set_ylim([-10, 10])

        ax = axes[2]
        ax.set_title("Gyroscope Bias")
        if self.bg:
            b = np.asarray(self.bg)
            for k, c in enumerate("rgb"):
                ax.plot(self.t, b[:, k], c=c, lw=0.8)

        fig.tight_layout()
        fig.savefig(path, dpi=90)
        plt.close(fig)
        return path

    # -- debug views (covisible_graph.py:252-307) ------------------------
    def dump_disparity(self, disp: np.ndarray, tag: str = "") -> str:
        """The oldest keyframe's disparity, magma-mapped, upsampled 8x by
        repetition (covisible_graph.py:253-263)."""
        import matplotlib.cm as cm
        import matplotlib.colors as mcolors

        disp = np.asarray(disp, np.float32)
        disp = np.repeat(np.repeat(disp, 8, axis=0), 8, axis=1)
        mapper = cm.ScalarMappable(norm=mcolors.Normalize(vmin=-0.2, vmax=1.0), cmap="magma")
        im = (mapper.to_rgba(disp)[:, :, :3] * 255).astype(np.uint8)
        return self._save_image(im, f"disparity{tag}")

    def dump_flow_weight(self, image: np.ndarray, target: np.ndarray, coords0: np.ndarray,
                         weight: np.ndarray, tag: str = "") -> str:
        """Flow and confidence-weight overlay of one edge
        (covisible_graph.py:266-283).  image: (H/8, W/8, 3) uint8 RGB
        (upsampled 8x here); target, coords0, weight: (H/8, W/8, 2)."""
        import cv2
        import matplotlib.cm as cm
        import matplotlib.colors as mcolors

        w = np.linalg.norm(np.asarray(weight, np.float32), axis=-1)
        mapper = cm.ScalarMappable(norm=mcolors.Normalize(vmin=0.0, vmax=1.5), cmap="jet")
        wim = (mapper.to_rgba(w)[:, :, :3] * 255).astype(np.uint8)
        H8, W8 = w.shape
        rgb = cv2.resize(np.asarray(image, np.uint8), (W8 * 8, H8 * 8),
                         interpolation=cv2.INTER_NEAREST)
        wim = cv2.resize(wim, (W8 * 8, H8 * 8))
        im = cv2.addWeighted(rgb, 0.5, wim, 0.5, 0)
        absflow = np.asarray(target, np.float32) - np.asarray(coords0, np.float32)
        for i in range(0, H8, 4):
            for j in range(0, W8, 4):
                im = cv2.line(im, (j * 8, i * 8),
                              (int(round((j - absflow[i, j, 0]) * 8)),
                               int(round((i - absflow[i, j, 1]) * 8))),
                              (255, 255, 255), 1, cv2.LINE_AA)
        return self._save_image(im, f"flow_weight{tag}")

    def dump_covisible(self, positions: np.ndarray, ii: np.ndarray, jj: np.ndarray,
                       ii_inac: Optional[np.ndarray] = None,
                       jj_inac: Optional[np.ndarray] = None, tag: str = "") -> str:
        """The covisibility graph: keyframe nodes (camera centres, top-down)
        and active/inactive edges (covisible_graph.py:287-307).
        positions: (N, >=2) world camera centres indexed by the edge ids."""
        import cv2

        all_idx = [np.asarray(ii), np.asarray(jj)]
        if ii_inac is not None and len(ii_inac):
            all_idx += [np.asarray(ii_inac), np.asarray(jj_inac)]
        cat = np.concatenate([a.ravel() for a in all_idx])
        im = np.zeros((1000, 1000), np.uint8)
        if len(cat) == 0:
            return self._save_image(im, f"covisible{tag}")
        # edges of a step in progress may name the incoming slot: clamp to
        # the poses there are
        i0 = int(np.min(cat))
        i1 = min(int(np.max(cat)), len(positions) - 1)
        ppp = np.asarray(positions, np.float64)[i0: i1 + 1, :2].copy()
        span = max(np.ptp(ppp[:, 0]), np.ptp(ppp[:, 1]), 1e-6)
        ppp -= ppp.mean(axis=0)
        ppp[:, 1] *= -1.0
        ppp *= max(round(1.0 / span * 200 / 50) * 50, 50)
        ppp += 500.0

        def pt(k):
            k = min(max(k, 0), len(ppp) - 1)
            return (int(round(ppp[k, 0])), int(round(ppp[k, 1])))

        for k in range(i1 + 1 - i0):
            im = cv2.circle(im, pt(k), 4, 255, 0)
        if ii_inac is not None:
            for a, b in zip(np.ravel(ii_inac), np.ravel(jj_inac)):
                im = cv2.line(im, pt(int(a) - i0), pt(int(b) - i0), 128, 1)
        for a, b in zip(np.ravel(ii), np.ravel(jj)):
            im = cv2.line(im, pt(int(a) - i0), pt(int(b) - i0), 255, 1)
        return self._save_image(im, f"covisible{tag}")

    def _save_image(self, im: np.ndarray, stem: str) -> str:
        import cv2

        n = self.dumps.get(stem, 0)
        self.dumps[stem] = n + 1
        path = os.path.join(self.outdir, f"{stem}_{n:04d}.png")
        if im.ndim == 3:
            im = im[:, :, ::-1]  # RGB -> BGR for imwrite
        cv2.imwrite(path, im)
        return path
