"""System facade (port of ``dbaf_tpu/slam/system.py``): wires the network,
keyframe store, motion filter, covisibility graph and frontend, the
tightly-coupled multi-sensor solve (:meth:`DBAFusion.set_multisensor`) and,
with ``cfg.frontend.async_pipeline``, the asynchronous visual pipeline
(``slam/async_pipeline.py``).
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Union

import numpy as np
import torch

from ..models.net import DroidNet
from ..ops.corr_cuda import check_k1_shape
from ..utils.config import DBAFusionConfig
from ..utils.device import resolve_device, to_host
from .frontend import Frontend
from .graph import CovisibleGraph
from .motion_filter import MotionFilter
from .video import DepthVideo


class DBAFusion:
    """Streaming VIO/SLAM: feed frames with :meth:`track`; enable the
    tightly-coupled IMU/GNSS/odometry solve with :meth:`set_multisensor`.

    ``params`` is the port's DroidNet ``state_dict``
    (:mod:`dbaf_tpu_torch.models.convert` makes one from JAX parameters or a
    reference checkpoint); without it ``cfg.weights_path`` names a
    reference-format ``droid.pth``.  ``feat_fn``/``ctx_fn``/``update_fn``
    may be injected instead (test oracles), with the signatures of
    ``DroidNet.features_only``/``context_only``/``update_fn`` (the update
    operator's signature is ``(net, inp, corr, motn, ii, jj, aux)``, as in
    the JAX package).  ``device`` defaults to the
    card and raises without one; pass ``device="cpu"`` for the plain path.
    On the card the image may be at most 1024 px wide (kernel K1's limit,
    :func:`~dbaf_tpu_torch.ops.corr_cuda.check_k1_shape`); a wider
    ``cfg.image_size`` raises ``ValueError`` here.
    ``dtype`` is the network's compute type.  With
    ``cfg.frontend.async_pipeline``, frames of a visual-only run go through
    the asynchronous pipeline from the first frame after initialization on.
    With ``cfg.save_pkl`` the keyframes that leave the buffer are archived
    for the dense export (:func:`dbaf_tpu_torch.eval.export.save_reconstruction`).
    ``cfg.frontend.monitor_dir`` (the per-keyframe panel dump) is not ported
    and raises ``NotImplementedError``.
    """

    def __init__(self, cfg: DBAFusionConfig, params: Optional[Mapping[str, torch.Tensor]] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 feat_fn: Optional[Callable] = None, ctx_fn: Optional[Callable] = None,
                 update_fn: Optional[Callable] = None, dtype: torch.dtype = torch.bfloat16):
        self.cfg = cfg
        if cfg.frontend.monitor_dir:
            raise NotImplementedError(
                "dbaf_tpu_torch: cfg.frontend.monitor_dir (the keyframe monitor's panel dump) "
                "is not ported yet")
        if torch.device("cuda" if device is None else device).type == "cuda":
            # K1 runs in every update round: refuse a feature grid it does
            # not take here rather than in the first round (fnet's 128 channels)
            check_k1_shape(cfg.feat_size[1], 128)
        self.device = resolve_device(device)
        self.video = DepthVideo(cfg, self.device)
        self.model = None
        if update_fn is None or feat_fn is None or ctx_fn is None:
            if params is None:
                if cfg.weights_path is None:
                    raise ValueError("need weights_path/params or injected feat/ctx/update fns")
                from ..models.convert import load_reference_state_dict

                params = load_reference_state_dict(
                    torch.load(cfg.weights_path, map_location="cpu", weights_only=True))
            self.model = DroidNet(dtype=dtype, device=self.device)
            self.model.load_state_dict(params)
            self.model.eval()
            feat_fn = feat_fn or self.model.features_only
            ctx_fn = ctx_fn or self.model.context_only
            update_fn = update_fn or self.model.update_fn
        self.graph = CovisibleGraph(self.video, update_fn, cfg)
        self.filter = MotionFilter(self.video, cfg, feat_fn, ctx_fn, update_fn)
        self.frontend = Frontend(self.video, self.graph, cfg)
        self._async = None
        if cfg.frontend.async_pipeline:
            from .async_pipeline import AsyncPipeline

            self._async = AsyncPipeline(self)

    def set_multisensor(self, all_imu, Tbc, all_gnss=None, all_odo=None, all_stamp=None,
                        tbg=None, ten0=None, imu_noise=None, visual_only: bool = False):
        """Enable tightly-coupled fusion (demo_vio_whu.py:190-211).

        Tbc: 4x4 body<-camera extrinsic; tbg: GNSS lever arm (body); ten0:
        ECEF reference for GNSS; imu_noise: (acc, gyro, acc_walk, gyro_walk)
        sigmas.  With ``cfg.sensors.device_solver``, ``coupled_mega`` and
        ``coupled_async`` on, keyframes after VI initialization run the
        asynchronous coupled pipeline (``slam/coupled_async.py``)."""
        from ..fusion.se3np import Pose
        from .coupled import MultiSensorBA

        self.frontend.set_multisensor(all_imu, all_gnss, all_odo, all_stamp,
                                      visual_only=visual_only)
        coupled = MultiSensorBA(self.video, self.cfg)
        coupled.Tbc = Pose.from_matrix(np.asarray(Tbc, float))
        if tbg is not None:
            coupled.tbg = np.asarray(tbg, float)
        if ten0 is not None:
            coupled.ten0 = np.asarray(ten0, float)
        if imu_noise is not None:
            coupled.state.set_imu_params(imu_noise)
        self.graph.coupled = coupled
        return coupled

    def track(self, tstamp: float, image: np.ndarray, depth: Optional[np.ndarray] = None,
              intrinsics: Optional[np.ndarray] = None, image_right: Optional[np.ndarray] = None):
        """Feed one (H, W, 3) BGR frame (dbaf.py:50-58)."""
        if depth is not None or image_right is not None:
            raise NotImplementedError("dbaf_tpu_torch: RGB-D and stereo input are not ported yet")
        a = self._async
        if a is not None and (a.active or a.can_activate()):
            if not a.active:
                a.activate()
            a.track(tstamp, image)
            return
        self.filter.track(tstamp, image, intrinsics)
        self.frontend()

    @property
    def trajectory(self):
        return self.frontend.trajectory

    @property
    def trajectory_ecef(self):
        """f64 ECEF positions keyed by trajectory row index (rows written
        after GNSS initialization; dbaf_frontend.py:270-272)."""
        return self.frontend.trajectory_ecef

    def terminate(self) -> np.ndarray:
        """Keyframe trajectory as (N, 8) ``[t, x, y, z, qx, qy, qz, qw]``
        (camera-to-world on the visual path, body-to-world on the coupled
        path), the rows still on the device pulled in one transfer.  Once
        georeferenced, rows without an ECEF position get one.  The
        asynchronous pipelines are drained first."""
        if self._async is not None and self._async.active:
            self._async.sync()
        self.frontend.drain_async()
        traj = self.frontend.trajectory
        if not traj:
            return np.zeros((0, 8))
        dev_idx = [k for k, (_, p) in enumerate(traj) if isinstance(p, torch.Tensor)]
        rows = np.zeros((len(traj), 8))
        rows[:, 0] = [ts for ts, _ in traj]
        if dev_idx:
            rows[dev_idx, 1:] = to_host(torch.stack([traj[k][1] for k in dev_idx]))
        for k, (_, p) in enumerate(traj):
            if not isinstance(p, torch.Tensor):
                rows[k, 1:] = p
        coupled = self.graph.coupled
        if coupled is not None and coupled.gnss_init_t1 > 0 and coupled.ten0 is not None:
            from ..utils import geodesy

            Cen = geodesy.Cen(coupled.ten0)
            ecef = self.frontend.trajectory_ecef
            for k in dev_idx:
                if k not in ecef:
                    ecef[k] = coupled.ten0 + Cen @ rows[k, 1:4]
        return rows
