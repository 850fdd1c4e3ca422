"""Keyframe state store (port of ``dbaf_tpu/slam/video.py``).

Poses, disparities, damping and the feature/context buffers are
preallocated tensors on the device, written in place where the JAX package
donates its buffers; timestamps and thumbnails stay on the host.  The
visual path's rows: ring buffers, ``append``, ``rm_keyframe``, ``rollup``,
``distance``, ``seed_next`` and ``normalize``, and the device-index row
moves of the asynchronous steps (``move_rows_device``, ``rollup_device``);
the initializations of the coupled path rewrite poses and rescale
disparities in place.  With ``cfg.save_pkl`` the rows that leave the
buffer are archived on the host (``saved_*``, the dense export's input):
at a rollup, and at the coupled path's window advance (``archive_mark``
keeps the two from archiving a row twice).  With ``cfg.upsample`` the
full-resolution ``disps_up`` rows (filled by the GraphAgg head,
``CovisibleGraph.run_upsample``) move with every other row, and so do
the depth sensor's disparities (``disps_sens``, written by ``append`` from an
RGB-D frame) and, with ``cfg.stereo``, the right camera's features
(``fmaps_right``).

With ``cfg.shard_video`` in a job of more than one rank, the feature
buffers (``fmaps``, ``nets``, ``inps``, ``fmaps_right``: the large ones)
are split over the ranks by keyframe slot, rank r holding slots
``[r B/n, (r + 1) B/n)``, as the JAX package's ``kf`` mesh splits them
(``dbaf_tpu/slam/video.py:148-175``).  Every rank runs the same frames;
poses, disparities and the solver state stay replicated.  The buffers are
read through :meth:`DepthVideo.feature_rows` (each rank reads the rows it
owns and a gather combines them, exact) and written by their owner
(:meth:`DepthVideo.write_feature`); the row moves of culls and rollups
gather their source rows the same way.  With one rank, or the flag off,
these are the plain indexing.  The gathers of ranks that share a card go
through the host (gloo), so the sharded asynchronous steps read the
device.

Every rank must issue the same gathers, so the library holds the ranks to
one set of host decisions: while a sharded video lives, every counted
host read of the process is the first rank's value
(``utils/device.py::HOST_SYNC``; the newest ``DepthVideo`` sets it).  On
the card the flag also turns on PyTorch's deterministic algorithms for
the process (``torch.use_deterministic_algorithms``; in one process too,
so that a run of one rank has the numerics of a run of n): the ranks each
compute the replicated state, and deterministic kernels keep it bit-equal
across them on cards of one model (``index_add_``'s atomic order
otherwise varies, see ``ops/dba.py``).  An operation without a
deterministic algorithm then raises.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..ops import projective as pj
from ..parallel.collectives import gather_rows
from ..utils.config import DBAFusionConfig
from ..utils.device import HOST_SYNC, resolve_device, rows_at, set_row, to_host

# the keyframe buffers that cfg.shard_video splits over the ranks
FEATURE_BUFFERS = ("fmaps", "nets", "inps", "fmaps_right")


def _kf_group():
    """The job's process group when it has more than one rank, else None."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1):
        return None
    from ..parallel.mesh import make_mesh

    return make_mesh(axis="kf").get_group("kf")


def slot_keyed(a, B: int) -> bool:
    """An aux leaf keyed by video slot (a test oracle's id_map)."""
    return isinstance(a, torch.Tensor) and a.dim() >= 1 and a.shape[0] == B


def move_rows(buf: torch.Tensor, dst: torch.Tensor, src: torch.Tensor, on: torch.Tensor) -> None:
    """In place, where ``on`` (a 0-d device bool): rows ``src`` -> rows
    ``dst`` (device indices of one shape; every source row is read before
    any is written)."""
    dst, src = dst.reshape(-1), src.reshape(-1)
    buf.index_copy_(0, dst, torch.where(on, buf.index_select(0, src), buf.index_select(0, dst)))


def roll_rows(buf: torch.Tensor, shift: torch.Tensor, n: int) -> None:
    """In place: rows [shift, shift + n) -> [0, n), wrapping past the
    buffer's end, for a 0-d device shift (0: every row stays).  With ``n``
    the buffer's length this is ``torch.roll(buf, -shift, 0)``; with fewer,
    the rows past ``n`` keep what they held."""
    if n > 0:
        idx = (torch.arange(n, device=buf.device) + shift) % buf.shape[0]
        buf[:n] = buf.index_select(0, idx)


class DepthVideo:
    """Fixed-capacity keyframe ring with device-resident hot state.
    ``device`` defaults to the card and raises without one."""

    _SHIFT_BUFFERS = ("poses", "disps", "disps_sens", "damping", "fmaps", "nets", "inps")

    def __init__(self, cfg: DBAFusionConfig, device: Optional[Union[str, torch.device]] = None):
        self.cfg = cfg
        self.device = device = resolve_device(device)
        ht, wd = cfg.image_size
        h8, w8 = ht // 8, wd // 8
        B = cfg.buffer
        self.ht, self.wd, self.h8, self.w8 = ht, wd, h8, w8
        self.counter = 0
        self.tstamp = np.zeros(B, dtype=np.float64)
        kw = dict(device=device)
        self.poses = torch.zeros((B, 7), dtype=torch.float32, **kw)
        self.poses[:, 6] = 1.0
        self.disps = torch.ones((B, h8, w8), dtype=torch.float32, **kw)
        self.disps_sens = torch.zeros((B, h8, w8), dtype=torch.float32, **kw)
        self.damping = torch.full((B, h8, w8), 1e-6, dtype=torch.float32, **kw)
        # keyframe-sharded feature buffers: this rank's slots [kf_lo, kf_lo + rows)
        self.kf_group, self.kf_lo, rows = None, 0, B
        group = _kf_group() if cfg.shard_video else None
        if group is not None:
            import torch.distributed as dist

            n = dist.get_world_size(group)
            if B % n:
                raise ValueError(f"shard_video needs buffer ({B}) divisible by the rank "
                                 f"count ({n})")
            rows = B // n
            self.kf_group, self.kf_lo = group, dist.get_rank(group) * rows
        if cfg.shard_video and device.type == "cuda":
            # cuBLAS takes a fixed workspace for deterministic results
            os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
            torch.use_deterministic_algorithms(True)
        HOST_SYNC["group"] = self.kf_group
        self.fmaps = torch.zeros((rows, h8, w8, 128), dtype=torch.bfloat16, **kw)
        self.nets = torch.zeros((rows, h8, w8, 128), dtype=torch.bfloat16, **kw)
        self.inps = torch.zeros((rows, h8, w8, 128), dtype=torch.bfloat16, **kw)
        # the right camera's features of a stereo rig (the c=2 axis of the
        # reference's fmaps buffer, depth_video.py:64)
        self.fmaps_right = None
        if cfg.stereo:
            self.fmaps_right = torch.zeros((rows, h8, w8, 128), dtype=torch.bfloat16, **kw)
            self._SHIFT_BUFFERS = self._SHIFT_BUFFERS + ("fmaps_right",)
        self.disps_up = None
        if cfg.upsample:  # convex-upsampled disparities, 8x the features (depth_video.py:57)
            self.disps_up = torch.zeros((B, 8 * h8, 8 * w8), dtype=torch.float32, **kw)
            self._SHIFT_BUFFERS = self._SHIFT_BUFFERS + ("disps_up",)
        self.intrinsics = torch.zeros((4,), dtype=torch.float32, **kw)  # at 1/8 scale
        self.images_small = np.zeros((B, h8, w8, 3), dtype=np.uint8)
        self.imu_enabled = False
        self.has_depth = False  # a depth frame was appended (RGB-D input)
        # host archive of the keyframes that left the buffer (save_pkl);
        # live rows [0, archive_mark) are in it already
        self.saved_tstamps: List[float] = []
        self.saved_poses: List[np.ndarray] = []
        self.saved_disps: List[np.ndarray] = []
        self.saved_images: List[np.ndarray] = []
        self.archive_mark = 0

    # ------------------------------------------------------------------
    def append(self, tstamp: float, image_small: Optional[np.ndarray], pose: Optional[torch.Tensor],
               disp: Optional[float], intrinsics: torch.Tensor, fmap: torch.Tensor,
               net: torch.Tensor, inp: torch.Tensor, depth: Optional[torch.Tensor] = None,
               fmap_right: Optional[torch.Tensor] = None) -> int:
        """Add a keyframe at the next slot; returns its index.  ``depth``
        (H, W) is a full-resolution depth map on the device, ``fmap_right``
        the right camera's features."""
        idx = self.counter
        self.tstamp[idx] = tstamp
        if image_small is not None:
            self.images_small[idx] = image_small
        if pose is not None:
            self.poses[idx] = pose
        if disp is not None:
            self.disps[idx] = disp
        self.intrinsics = intrinsics
        self.set_features(idx, fmap, net, inp)
        self.set_sensors(idx, depth, fmap_right)
        self.counter += 1
        return idx

    def set_sensors(self, idx: int, depth: Optional[torch.Tensor],
                    fmap_right: Optional[torch.Tensor]) -> None:
        """Row ``idx`` of the depth sensor's disparities, 1/d where d > 0 at
        pixels [3::8, 3::8] of ``depth`` (depth_video.py:146-147), and of the
        right camera's features (kept only with ``cfg.stereo``)."""
        if depth is not None:
            d8 = depth[3::8, 3::8].float()
            self.disps_sens[idx] = torch.where(d8 > 0, 1.0 / d8, d8)
            self.has_depth = True
        if fmap_right is not None and self.fmaps_right is not None:
            self.write_feature("fmaps_right", idx, fmap_right)

    def set_features(self, idx: int, fmap, net, inp):
        self.write_feature("fmaps", idx, fmap)
        self.write_feature("nets", idx, net)
        self.write_feature("inps", idx, inp)

    # ------------------------------------------------------------------
    # the feature buffers, sharded or not
    def _sharded(self, name: str) -> bool:
        return self.kf_group is not None and name in FEATURE_BUFFERS

    def feature_rows(self, name: str, idx) -> torch.Tensor:
        """``buf[idx]`` of a feature buffer for a device index tensor (any
        shape), or for an int (one row); gathered from the owning ranks
        when the buffer is sharded."""
        buf = getattr(self, name)
        if not self._sharded(name):
            return buf[idx]
        if isinstance(idx, int):
            return gather_rows(buf, torch.tensor([idx], device=buf.device), self.kf_group)[0]
        return gather_rows(buf, idx, self.kf_group).reshape(idx.shape + buf.shape[1:])

    def write_feature(self, name: str, idx, row: torch.Tensor,
                      on: Optional[torch.Tensor] = None) -> None:
        """``buf[idx] = row`` for an int or a 0-d device index, where ``on``
        (a 0-d device bool; always without it), by the rank that owns the
        slot when the buffer is sharded."""
        buf = getattr(self, name)
        if self._sharded(name):
            n = buf.shape[0]
            if isinstance(idx, torch.Tensor):
                local = idx - self.kf_lo
                mine = (local >= 0) & (local < n)
                on = mine if on is None else on & mine
                idx = torch.clamp(local, 0, n - 1)
            elif not self.kf_lo <= idx < self.kf_lo + n:
                return
            else:
                idx = idx - self.kf_lo
        if on is not None:
            row = torch.where(on, row.to(buf.dtype), rows_at(buf, idx))
        set_row(buf, idx, row)

    def _move_sharded(self, name: str, dst: torch.Tensor, src: torch.Tensor,
                      on: Optional[torch.Tensor] = None) -> None:
        """Rows ``src`` -> rows ``dst`` of a sharded buffer, where ``on``:
        the source rows are gathered, then each rank writes the ones it
        owns (a destination slot named twice takes its first source)."""
        buf = getattr(self, name)
        dst, src = dst.reshape(-1), src.reshape(-1)
        rows = gather_rows(buf, src, self.kf_group)
        mine = self.kf_lo + torch.arange(buf.shape[0], device=buf.device)
        match = dst[None, :] == mine[:, None]
        take = match.any(1) if on is None else match.any(1) & on
        src_of = match.to(torch.int64).argmax(1)
        shape = (-1,) + (1,) * (buf.dim() - 1)
        buf.copy_(torch.where(take.reshape(shape), rows[src_of], buf))

    def full_buffer(self, name: str) -> torch.Tensor:
        """Every slot of a buffer (gathered when it is sharded)."""
        buf = getattr(self, name)
        if not self._sharded(name):
            return buf
        return self.feature_rows(name, torch.arange(self.poses.shape[0], device=buf.device))

    def owned_rows(self, name: str, full):
        """This rank's rows of a full-size array for buffer ``name``."""
        if not self._sharded(name):
            return full
        n = getattr(self, name).shape[0]
        return full[self.kf_lo:self.kf_lo + n]

    def set_pose(self, idx: int, pose: torch.Tensor):
        self.poses[idx] = pose

    def set_disp(self, idx: int, disp):
        self.disps[idx] = disp

    def set_poses_range(self, start: int, poses: np.ndarray):
        """Write poses for frames [start, start + len) in one copy."""
        p = torch.as_tensor(np.asarray(poses, np.float32), device=self.device)
        self.poses[start:start + p.shape[0]] = p

    def scale_disps(self, n: int, scale: float):
        """disps[:n] *= 1/scale (the VI/GNSS initialization's rescale)."""
        self.disps[:n] *= 1.0 / torch.tensor(scale, dtype=torch.float32)

    # ------------------------------------------------------------------
    def copy_row(self, dst: int, src: int):
        """Copy every per-frame row src -> dst (host rows included)."""
        for name in self._SHIFT_BUFFERS:
            buf = getattr(self, name)
            if self._sharded(name):
                self._move_sharded(name, torch.tensor([dst], device=buf.device),
                                   torch.tensor([src], device=buf.device))
                continue
            buf[dst] = buf[src]
        self.tstamp[dst] = self.tstamp[src]
        self.images_small[dst] = self.images_small[src]

    def rm_keyframe(self, ix: int):
        """Drop keyframe ``ix``, shifting slot ix+1 down (covisible_graph.py:180-195)."""
        self.copy_row(ix, ix + 1)
        self.counter -= 1

    def archive(self, lo: int, hi: Optional[int] = None):
        """With ``cfg.save_pkl``, append rows [lo, hi) (row ``lo`` alone by
        default) to the save buffers, their poses and disparities in one
        device read (depth_video.py:336-343)."""
        hi = lo + 1 if hi is None else hi
        if not self.cfg.save_pkl or hi <= lo:
            return
        n = hi - lo
        rows = to_host(torch.cat([self.poses[lo:hi], self.disps[lo:hi].reshape(n, -1)], 1))
        self.append_saved(self.tstamp[lo:hi], rows, self.images_small[lo:hi])
        self.archive_mark = max(self.archive_mark, hi)

    def append_saved(self, tstamps, rows: np.ndarray, images) -> None:
        """Append archived rows: ``rows`` (n, 7 + H8*W8) as [pose | disparity]."""
        for t, r, im in zip(tstamps, rows, images):
            self.saved_tstamps.append(float(t))
            self.saved_poses.append(r[:7].copy())
            self.saved_disps.append(r[7:].reshape(self.h8, self.w8).copy())
            self.saved_images.append(np.array(im, copy=True))

    def export_rows(self, n_live: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """The dense export's keyframes in order: the archive, then the live
        rows [archive_mark, n_live) (one device read).  Returns (tstamps (N,),
        poses (N, 7), disparities (N, H8, W8), thumbnails (N, H8, W8, 3))."""
        lo = min(self.archive_mark, n_live)
        n = n_live - lo
        live = to_host(torch.cat([self.poses[lo:n_live],
                                  self.disps[lo:n_live].reshape(n, -1)], 1)).reshape(n, -1)
        H8, W8 = self.h8, self.w8
        stamps = np.asarray(self.saved_tstamps + list(self.tstamp[lo:n_live]), np.float64)
        poses = np.concatenate([np.asarray(self.saved_poses, np.float32).reshape(-1, 7),
                                live[:, :7]])
        disps = np.concatenate([np.asarray(self.saved_disps, np.float32).reshape(-1, H8, W8),
                                live[:, 7:].reshape(n, H8, W8)])
        images = np.concatenate([np.asarray(self.saved_images, np.uint8).reshape(-1, H8, W8, 3),
                                 self.images_small[lo:n_live]])
        return stamps, poses, disps, images

    def rollup(self, shift: int):
        """Shift the whole buffer down by ``shift`` slots (dbaf_frontend.py:89-151),
        archiving the rows it retires that are not archived yet."""
        self.archive(self.archive_mark, shift)
        B = self.poses.shape[0]
        for name in self._SHIFT_BUFFERS:
            buf = getattr(self, name)
            if self._sharded(name):
                ar = torch.arange(B, device=buf.device)
                self._move_sharded(name, ar, (ar + shift) % B)
                continue
            buf.copy_(torch.roll(buf, -shift, dims=0))
        self.tstamp = np.roll(self.tstamp, -shift)
        self.images_small = np.roll(self.images_small, -shift, axis=0)
        self.counter -= shift
        self.archive_mark = max(self.archive_mark - shift, 0)

    def _moved_aux(self, aux: Optional[dict], move) -> dict:
        """``aux`` with ``move`` applied to copies of its slot-keyed leaves."""
        out = dict(aux or {})
        for k, a in out.items():
            if slot_keyed(a, self.poses.shape[0]):
                out[k] = a.clone()
                move(out[k])
        return out

    def rm_keyframe_aux(self, aux: Optional[dict], ix: int) -> dict:
        """``aux`` with :meth:`rm_keyframe`'s row move (ix + 1 -> ix) applied
        to copies of its slot-keyed leaves."""
        def move(a):
            a[ix] = a[ix + 1]
        return self._moved_aux(aux, move)

    def move_rows_device(self, dst: torch.Tensor, src: torch.Tensor, on: torch.Tensor,
                         aux: Optional[dict] = None) -> dict:
        """:func:`move_rows` on every per-frame buffer and on copies of
        ``aux``'s slot-keyed leaves (the asynchronous steps' culls, at
        device indices); returns the new aux.  Host rows are the drain's."""
        for name in self._SHIFT_BUFFERS:
            if self._sharded(name):
                self._move_sharded(name, dst, src, on)
            else:
                move_rows(getattr(self, name), dst, src, on)
        return self._moved_aux(aux, lambda a: move_rows(a, dst, src, on))

    def rollup_device(self, shift: torch.Tensor, aux: Optional[dict] = None) -> dict:
        """:meth:`rollup` by a 0-d device shift (0: nothing moves) on the
        rows that can be live, for the asynchronous steps: a rollup fires
        once the keyframe count passes ``rollup_start``, one keyframe a
        step, so rows at or above ``rollup_start + 1`` hold no keyframe and
        keep what they held (:meth:`rollup` rolls them around; each is
        written when a keyframe takes it).  Copies of ``aux``'s slot-keyed
        leaves roll whole, as the synchronous flow rolls them: a slot ->
        frame map holds the rows that later keyframes take.  Returns the
        new aux."""
        fc = self.cfg.frontend
        B = self.poses.shape[0]
        n = min(fc.rollup_start + 1, B) - fc.rollup_shift
        for name in self._SHIFT_BUFFERS:
            if self._sharded(name):
                if n > 0:
                    ar = torch.arange(n, device=self.poses.device)
                    self._move_sharded(name, ar, (ar + shift) % B)
            else:
                roll_rows(getattr(self, name), shift, n)
        return self._moved_aux(aux, lambda a: roll_rows(a, shift, B))

    # ------------------------------------------------------------------
    def _idx(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=self.device)

    def distance(self, ii, jj, beta: float = 0.3) -> np.ndarray:
        d = pj.frame_distance_bidirectional(
            self.poses, self.disps, self.intrinsics, self._idx(ii), self._idx(jj), beta)
        return to_host(d)

    def normalize(self):
        """Scale disparities of the live rows to unit mean (poses scale along)."""
        n = self.counter
        s = self.disps[:n].mean()
        self.disps[:n] /= s
        self.poses[:n, :3] *= s

    def seed_depth(self, idx: int):
        """disps[idx] = disps_sens[idx] where the sensor has a value
        (dbaf_frontend.py:247-248)."""
        self.disps[idx] = torch.where(self.disps_sens[idx] > 0, self.disps_sens[idx],
                                      self.disps[idx])

    def seed_next(self, idx: int):
        """poses[idx] = poses[idx-1]; disps[idx] = mean(disps[idx-1])
        (dbaf_frontend.py:371-373)."""
        self.poses[idx] = self.poses[idx - 1]
        self.disps[idx] = self.disps[idx - 1].mean()
