"""System facade (port of ``dbaf_tpu/slam/system.py``): wires the network,
keyframe store, motion filter, covisibility graph and frontend, the
tightly-coupled multi-sensor solve (:meth:`DBAFusion.set_multisensor`) and,
with ``cfg.frontend.async_pipeline``, the asynchronous visual pipeline
(``slam/async_pipeline.py``); saves and restores the streaming state.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Union

import numpy as np
import torch

from ..models.net import DroidNet
from ..ops.corr_cuda import check_int8_tile, check_k1_shape, int8_tile
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
    ``cfg.image_size`` raises ``ValueError`` here, and so does a
    ``cfg.graph.corr_group`` whose int8 tile K1-int8 does not take
    (:func:`~dbaf_tpu_torch.ops.corr_cuda.check_int8_tile`, with ``corr_int8``).
    ``dtype`` is the network's compute type.  With
    ``cfg.frontend.async_pipeline``, frames of a visual-only run go through
    the asynchronous pipeline from the first frame after initialization on.
    With ``cfg.save_pkl`` the keyframes that leave the buffer are archived
    for the dense export (:func:`dbaf_tpu_torch.eval.export.save_reconstruction`).
    With ``cfg.upsample`` and weights that carry the GraphAgg head
    (``update.agg``), every keyframe step of the synchronous flow ends with
    ``CovisibleGraph.run_upsample``: the frames with edges take GraphAgg's
    damping and a full-resolution ``video.disps_up``; the asynchronous
    pipelines do not activate then.
    With ``cfg.stereo`` :meth:`track` takes each frame's right image, and
    it takes a depth map for RGB-D input; both run the synchronous flow.
    :meth:`save_state` and :meth:`load_state` snapshot and restore the
    streaming state.
    With ``cfg.frontend.monitor_dir`` the frontend's monitor dumps its
    panels there (:mod:`dbaf_tpu_torch.eval.monitor`); the visual
    asynchronous pipeline is then not built, as in the JAX package.
    """

    def __init__(self, cfg: DBAFusionConfig, params: Optional[Mapping[str, torch.Tensor]] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 feat_fn: Optional[Callable] = None, ctx_fn: Optional[Callable] = None,
                 update_fn: Optional[Callable] = None, dtype: torch.dtype = torch.bfloat16):
        self.cfg = cfg
        if torch.device("cuda" if device is None else device).type == "cuda":
            # K1 runs in every update round: refuse a feature grid it does
            # not take here rather than in the first round (fnet's 128 channels)
            check_k1_shape(cfg.feat_size[1], 128)
            h8, w8 = cfg.feat_size
            tile = int8_tile(h8, w8, cfg.graph.corr_group) if cfg.graph.corr_int8 else None
            if tile is not None:  # K1-int8 in every round instead
                check_int8_tile(h8 * w8, tile)
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
            has_agg = any(k.startswith("update.agg.") for k in params)
            self.model = DroidNet(dtype=dtype, device=self.device, agg=has_agg)
            self.model.load_state_dict(params)
            self.model.eval()
            feat_fn = feat_fn or self.model.features_only
            ctx_fn = ctx_fn or self.model.context_only
            update_fn = update_fn or self.model.update_fn
        self.graph = CovisibleGraph(self.video, update_fn, cfg)
        if cfg.upsample and self.model is not None and self.model.update.agg is not None:
            self.graph.agg_fn = self.model.agg_fn
        self.filter = MotionFilter(self.video, cfg, feat_fn, ctx_fn, update_fn)
        self.frontend = Frontend(self.video, self.graph, cfg)
        self._async = None
        if cfg.frontend.async_pipeline and not cfg.frontend.monitor_dir:
            # the monitor reads each keyframe's host state: stay synchronous
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
        """Feed one (H, W, 3) BGR frame (dbaf.py:50-58), with an (H, W)
        depth map for RGB-D input and the right camera's frame with
        ``cfg.stereo``.  A depth map runs the synchronous flow: an active
        asynchronous visual pipeline is drained first (the JAX package hands
        the pipeline the image alone and drops the depth map), and once a
        depth frame is in, the pipeline no longer activates."""
        a = self._async
        if a is not None and depth is not None and a.active:
            a.sync()
        if a is not None and depth is None and (a.active or a.can_activate()):
            if not a.active:
                a.activate()
            a.track(tstamp, image)
            return
        self.filter.track(tstamp, image, depth, intrinsics, image_right)
        self.frontend()

    @property
    def trajectory(self):
        return self.frontend.trajectory

    @property
    def trajectory_ecef(self):
        """f64 ECEF positions keyed by trajectory row index (rows written
        after GNSS initialization; dbaf_frontend.py:270-272)."""
        return self.frontend.trajectory_ecef

    # ------------------------------------------------------------------
    _VIDEO_ARRAYS = ("poses", "disps", "disps_sens", "damping", "fmaps", "nets", "inps",
                     "fmaps_right", "disps_up", "intrinsics")
    _GRAPH_HOST = ("ii", "jj", "age", "ii_inac", "jj_inac")

    def _graph_dev(self) -> dict:
        """The edge stores a state file keeps, by its names."""
        g = self.graph
        return dict(net=g.edges.net, target=g.edges.target, weight=g.edges.weight,
                    t_inac=g.t_inac, w_inac=g.w_inac)

    def save_state(self, path: str):
        """Pickle the streaming state for a resume (dbaf_tpu/slam/system.py:
        167-218, in its dict layout): the asynchronous pipelines are drained
        first, and every video, edge and trajectory array is a numpy array
        (bf16 buffers as their 16-bit patterns, ``int16``), so the file
        loads without a card.  ``video_host`` also keeps ``has_depth``,
        which the JAX file leaves out; the port's graph has no quarantined
        edges, so ``ii_bad``/``jj_bad`` are not in it."""
        import pickle

        if self._async is not None and self._async.active:
            self._async.sync()
        v, g, fe = self.video, self.graph, self.frontend
        fe.drain_async()
        g._flush()
        traj = fe.trajectory
        dev_idx = [k for k, (_, p) in enumerate(traj) if isinstance(p, torch.Tensor)]
        rows = to_host(torch.stack([traj[k][1] for k in dev_idx])) if dev_idx else None
        traj_np = list(traj)
        for n, k in enumerate(dev_idx):
            traj_np[k] = (traj[k][0], rows[n])
        state = {
            "video": {name: (None if getattr(v, name) is None else _state_array(getattr(v, name)))
                      for name in self._VIDEO_ARRAYS},
            "video_host": {
                "tstamp": v.tstamp.copy(),
                "images_small": v.images_small.copy(),
                "counter": v.counter,
                "saved": (v.saved_tstamps, v.saved_poses, v.saved_disps, v.saved_images),
                "imu_enabled": v.imu_enabled,
                "has_depth": v.has_depth,
            },
            "graph": {name: getattr(g, name).copy() for name in self._GRAPH_HOST},
            "graph_dev": {name: _state_array(t) for name, t in self._graph_dev().items()},
            "frontend": {
                "t0": fe.t0, "t1": fe.t1, "count": fe.count,
                "is_initialized": fe.is_initialized, "trajectory": traj_np,
                "cur_imu_ii": fe.cur_imu_ii, "cur_stamp_ii": fe.cur_stamp_ii,
            },
            "coupled": None if g.coupled is None else g.coupled.snapshot(),
        }
        with open(path, "wb") as f:
            pickle.dump(state, f)

    def load_state(self, path: str):
        """Restore a :meth:`save_state` file into this system's buffers, on
        its own device (dbaf_tpu/slam/system.py:220-254), and the motion
        gate's keyframe features from the newest row, so that ``track``
        goes on."""
        import pickle

        with open(path, "rb") as f:
            state = pickle.load(f)
        v, g, fe = self.video, self.graph, self.frontend
        for name, arr in state["video"].items():
            if arr is not None:
                _load_array(getattr(v, name), arr)
        vh = state["video_host"]
        v.tstamp = vh["tstamp"]
        v.images_small = vh["images_small"]
        v.counter = vh["counter"]
        v.saved_tstamps, v.saved_poses, v.saved_disps, v.saved_images = vh["saved"]
        v.imu_enabled = vh["imu_enabled"]
        v.has_depth = vh["has_depth"]
        for name, arr in state["graph"].items():
            setattr(g, name, arr)
        stores = self._graph_dev()
        for name, arr in state["graph_dev"].items():
            _load_array(stores[name], arr)
        g._perm = np.arange(g.e_cap, dtype=np.int64)
        g._is_new[:] = False
        g._dirty = False
        for k, val in state["frontend"].items():
            setattr(fe, k, val)
        if self.filter is not None and v.counter > 0:
            # the motion gate's last keyframe: the newest row (a cull never
            # removes it), which the JAX file leaves out
            last = v.counter - 1
            self.filter._store(v.fmaps[last], v.nets[last], v.inps[last])
        if state["coupled"] is not None:
            state["coupled"].attach(v)
            g.coupled = state["coupled"]

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


def _state_array(t: torch.Tensor) -> np.ndarray:
    """A device tensor as a numpy array for a state file (one read); bf16
    as its bit patterns, which numpy has no type for."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return to_host(t)


def _load_array(dst: torch.Tensor, arr: np.ndarray) -> None:
    """In place: ``dst`` (on its device) takes a :func:`_state_array`."""
    src = torch.from_numpy(np.ascontiguousarray(arr))
    dst.copy_(src.view(torch.bfloat16) if dst.dtype == torch.bfloat16 else src)
