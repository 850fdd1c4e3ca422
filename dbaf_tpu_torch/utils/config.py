"""Typed configuration tree with per-dataset presets.

The port's own copy of ``dbaf_tpu/utils/config.py``: the same dataclasses,
field names and defaults, so one set of keyword arguments builds the same
configuration in both packages.  Fields that only the JAX package's
unported paths read (sharding) are kept so the two trees stay
interchangeable; the port ignores them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclass
class GraphConfig:
    """Covisibility-graph shape & edge-selection knobs."""

    max_factors: int = 48            # active-edge budget (demo_vio_tumvi.py:87)
    edge_capacity: int = 48          # static padded edge-array size
    inactive_capacity: int = 64      # static padded inactive-edge store
    corr_group: int = 16             # pixel packing of the JAX package's
    # Pallas correlation kernel; the port reads it only for the int8 tile
    # (ops/corr_cuda.int8_tile)
    corr_int8: bool = False          # every update round quantizes the
    # correlation volume to int8 per (edge, pixel tile) before the x stage
    # (ops/corr_cuda.corr_fused_xy_int8: kernel K1-int8 on the card, its
    # plain version on the CPU); off by default
    frontend_window: int = 5         # proximity window (demo:98)
    frontend_radius: int = 2         # forced radius edges (demo:99)
    frontend_nms: int = 1            # NMS suppression radius (demo:100)
    frontend_thresh: float = 16.0    # distance threshold for edges (demo:97)
    beta: float = 0.3                # flow blend in frame distance (demo:88)
    max_age: int = 25                # edge retirement age (dbaf_frontend.py:58)
    inac_range: int = 3              # inactive edges kept in BA (demo:113)
    skip_edge: Sequence[int] = ()    # opportunistic long-range edges (demo:118)
    far_threshold: float = 0.02      # far-disparity down-weight (demo:110)
    mask_threshold: float = -1.0     # short-baseline down-weight (demo:112)
    upsample: bool = False


@dataclass
class FrontendConfig:
    keyframe_thresh: float = 3.5     # cull distance (demo:96)
    filter_thresh: float = 2.4       # motion-filter flow gate (demo:92)
    translation_threshold: float = 0.2  # cull translation hysteresis (demo:111)
    warmup: int = 8                  # keyframes before init (demo:93)
    vi_warmup: int = 12              # keyframes before VI init (dbaf_frontend.py:31)
    iters1: int = 4                  # update rounds per keyframe (demo:90)
    iters2: int = 2                  # post-cull update rounds (demo:91)
    init_iters: int = 8              # per round at initialization (dbaf_frontend.py:826-837)
    rollup_start: int = 65           # window shift trigger (dbaf_frontend.py:254)
    rollup_shift: int = 30           # shift amount (dbaf_frontend.py:255)
    active_window: int = 12          # multi-sensor active window (demo:109)
    async_pipeline: bool = False     # after initialization, every frame of a
    # visual-only configuration runs as one device step (gate, admission,
    # edge transition, cull, rollup, update rounds) with no host read; the
    # host mirrors follow from packs drained two frames late
    # (slam/async_pipeline.py)
    async_drain_batch: int = 8       # packs applied per drain (one blocking
    # wait per drain)
    monitor_dir: str = ""
    monitor_debug: bool = True


@dataclass
class BAConfig:
    window: int = 80                 # static pose-window capacity for DBA
    iters: int = 2                   # GN iterations per ba() call
    lm_iters: int = 2                # coupled-mode passes per round
    lm: float = 1e-4
    ep: float = 0.1
    alpha: float = 0.05              # depth-sensor prior weight (droid_kernels.cu:1477)
    eps_damping: float = 1e-7        # EP in graph.update (covisible_graph.py:330)


@dataclass
class SensorConfig:
    """IMU / GNSS / odometry fusion knobs (demo_vio_whu.py:95-119,190-211)."""

    use_imu: bool = True
    use_gnss: bool = False
    use_odo: bool = False
    use_zupt: bool = False
    zupt_vel_thresh: float = 0.025
    imu_rate: float = 200.0
    acc_noise: float = 0.1
    gyro_noise: float = 0.01
    acc_walk: float = 1e-3
    gyro_walk: float = 1e-5
    gravity: float = 9.807           # multi_sensor.py:5
    Tbc: Optional[np.ndarray] = None  # 4x4 T_body_camera
    tbg: Optional[np.ndarray] = None  # GNSS lever arm in body frame
    device_solver: bool = False
    device_marg: bool = True
    coupled_mega: bool = True
    coupled_async: bool = True
    fg_cap: int = 20


@dataclass
class DBAFusionConfig:
    image_size: Tuple[int, int] = (384, 512)
    buffer: int = 256                # keyframe ring-buffer slots
    stereo: bool = False
    graph: GraphConfig = field(default_factory=GraphConfig)
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    ba: BAConfig = field(default_factory=BAConfig)
    sensors: SensorConfig = field(default_factory=SensorConfig)
    save_pkl: bool = False
    upsample: bool = False
    weights_path: Optional[str] = None
    shard_video: bool = False

    @property
    def feat_size(self) -> Tuple[int, int]:
        return self.image_size[0] // 8, self.image_size[1] // 8


def tumvi_config(**overrides) -> DBAFusionConfig:
    """TUM-VI rooms preset (batch_tumvi.py:28-41) with 3+1 visual update
    rounds and one coupled LM pass, as in the JAX package's preset."""
    cfg = DBAFusionConfig(
        image_size=(384, 512),
        graph=GraphConfig(
            max_factors=48,
            frontend_window=5,
            frontend_radius=2,
            frontend_nms=1,
            far_threshold=0.02,
            mask_threshold=-1.0,
            skip_edge=(-4, -5, -6),
        ),
        frontend=FrontendConfig(
            keyframe_thresh=3.5,
            translation_threshold=0.2,
            active_window=12,
            iters1=3,
            iters2=1,
        ),
        ba=BAConfig(lm_iters=1),
    )
    return dataclasses.replace(cfg, **overrides)


def kitti360_config(**overrides) -> DBAFusionConfig:
    """KITTI-360 preset (batch_kitti360.py:13-25)."""
    cfg = DBAFusionConfig(
        image_size=(320, 896),
        graph=GraphConfig(
            max_factors=48,
            far_threshold=-1.0,
            mask_threshold=1.0,
            skip_edge=(-4, -5, -6),
        ),
        frontend=FrontendConfig(translation_threshold=0.5),
    )
    return dataclasses.replace(cfg, **overrides)


def whu_config(**overrides) -> DBAFusionConfig:
    """WHU multi-sensor preset (batch_whu.py:5-85)."""
    cfg = DBAFusionConfig(
        image_size=(320, 640),
        graph=GraphConfig(max_factors=48, mask_threshold=0.0),
        sensors=SensorConfig(use_gnss=True, use_odo=True, use_zupt=True),
        ba=BAConfig(lm_iters=1),
    )
    return dataclasses.replace(cfg, **overrides)


def subt_config(**overrides) -> DBAFusionConfig:
    """SubT handheld preset (batch_subt.py:8-29)."""
    cfg = DBAFusionConfig(
        image_size=(384, 512),
        graph=GraphConfig(max_factors=48, far_threshold=0.02),
    )
    return dataclasses.replace(cfg, **overrides)
