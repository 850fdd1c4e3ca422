"""Training data: covisibility graphs and the TartanAir reader (port of
``dbaf_tpu/train/data.py``).

The reference's data_readers package (base.py, tartan.py,
augmentation.py): flow-distance frame graphs over ground-truth depth and
poses, covisible tuple sampling, photometric augmentation and the
TartanAir scene layout.  Randomness comes from the numpy ``Generator``
handed in.  cv2 is imported where images are read.
"""

from __future__ import annotations

import os
import os.path as osp
import pickle
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..ops import lie
from ..ops import projective as pj
from ..utils.device import resolve_device, to_host


def build_frame_graph(poses: np.ndarray, disps: np.ndarray, intrinsics: np.ndarray,
                      max_flow: float = 256.0, subsample: int = 8,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> Dict[int, List[Tuple[int, float]]]:
    """Covisibility graph from the mean induced flow between frames
    (base.py:69-92), with the port's ``frame_distance`` on
    ``subsample``-downsampled ground truth.  ``device`` defaults to the
    card."""
    dev = resolve_device(device)
    N = len(poses)
    d8 = disps[:, subsample // 2::subsample, subsample // 2::subsample]
    intr8 = np.asarray(intrinsics, np.float32) / subsample

    ii, jj = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    ii, jj = ii.reshape(-1), jj.reshape(-1)
    keep = ii != jj

    def t(a, dt):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

    d = to_host(pj.frame_distance(t(poses, torch.float32), t(d8, torch.float32),
                                  t(intr8, torch.float32), t(ii[keep], torch.int64),
                                  t(jj[keep], torch.int64)))
    graph: Dict[int, List[Tuple[int, float]]] = {i: [] for i in range(N)}
    for (i, j, dist) in zip(ii[keep], jj[keep], d):
        if dist < max_flow:
            graph[int(i)].append((int(j), float(dist)))
    return graph


def sample_covisible_tuple(graph: Dict[int, List[Tuple[int, float]]], n_frames: int,
                           rng: np.random.Generator, fmin: float = 8.0,
                           fmax: float = 75.0) -> Optional[List[int]]:
    """Random walk over the covisibility graph picking frames whose mean
    flow lies in (fmin, fmax) (base.py's sampling)."""
    start = int(rng.integers(len(graph)))
    frames = [start]
    while len(frames) < n_frames:
        cands = [j for j, d in graph.get(frames[-1], []) if fmin < d < fmax and j not in frames]
        if not cands:
            cands = [j for j, d in graph.get(frames[-1], []) if d < fmax and j not in frames]
        if not cands:
            return None
        frames.append(int(rng.choice(cands)))
    return frames


def augment_image(image: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Photometric augmentation (augmentation.py:7-58): brightness and
    contrast jitter and a random eraser."""
    img = image.astype(np.float32)
    img *= rng.uniform(0.8, 1.25)  # brightness
    mean = img.mean()
    img = (img - mean) * rng.uniform(0.8, 1.2) + mean  # contrast
    if rng.random() < 0.5:  # random eraser
        h, w = img.shape[:2]
        for _ in range(rng.integers(1, 3)):
            x0 = int(rng.integers(0, w - 20))
            y0 = int(rng.integers(0, h - 20))
            dx = int(rng.integers(10, 50))
            dy = int(rng.integers(10, 50))
            img[y0:y0 + dy, x0:x0 + dx] = img.mean(axis=(0, 1))
    return np.clip(img, 0, 255)


class TartanAirDataset:
    """TartanAir scene reader (tartan.py).

    Scene layout: <scene>/image_left/*.png, <scene>/depth_left/*.npy,
    <scene>/pose_left.txt (NED, converted as the reference does).  The
    frame graphs are built on ``device`` (the card by default)."""

    INTRINSICS = np.array([320.0, 320.0, 320.0, 240.0], dtype=np.float32)

    def __init__(self, root: str, n_frames: int = 7, seed: int = 0,
                 graph_cache: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.root = root
        self.n_frames = n_frames
        self.rng = np.random.default_rng(seed)
        self.device = resolve_device(device)
        self.scenes = self._index_scenes()
        self.graphs: Dict[str, Tuple] = {}
        self.graph_cache = graph_cache
        if graph_cache and osp.isfile(graph_cache):
            with open(graph_cache, "rb") as f:
                self.graphs = pickle.load(f)

    def _index_scenes(self) -> List[str]:
        scenes = []
        for dirpath, dirnames, _ in os.walk(self.root):
            if "image_left" in dirnames and "depth_left" in dirnames:
                scenes.append(dirpath)
        return sorted(scenes)

    @staticmethod
    def load_pose_file(path: str) -> np.ndarray:
        """TartanAir pose_left.txt (NED, xyzw) -> world->camera 7-vectors
        (f32, inverted with the port's SE3 inverse)."""
        raw = np.loadtxt(path)
        perm = [1, 2, 0, 4, 5, 3, 6]  # NED -> camera axes (the reference loader's)
        poses_wc = torch.as_tensor(raw[:, perm], dtype=torch.float32)
        return lie.se3_inv(poses_wc).numpy()

    @staticmethod
    def _disparity(path: str) -> np.ndarray:
        return 1.0 / np.maximum(np.load(path), 1e-3)

    def _scene_graph(self, scene: str):
        if scene not in self.graphs:
            poses = self.load_pose_file(osp.join(scene, "pose_left.txt"))
            dfiles = sorted(os.listdir(osp.join(scene, "depth_left")))
            disps = np.stack([self._disparity(osp.join(scene, "depth_left", f)) for f in dfiles])
            self.graphs[scene] = (
                build_frame_graph(poses, disps, self.INTRINSICS, device=self.device), poses)
            if self.graph_cache:
                with open(self.graph_cache, "wb") as f:
                    pickle.dump(self.graphs, f)
        return self.graphs[scene]

    def sample(self) -> Optional[dict]:
        """One training tuple: images (F, H, W, 3), poses (F, 7) Tcw,
        disps (F, H, W), intrinsics (4,); None where the walk stalls."""
        import cv2

        scene = self.scenes[int(self.rng.integers(len(self.scenes)))]
        graph, poses = self._scene_graph(scene)
        idx = sample_covisible_tuple(graph, self.n_frames, self.rng)
        if idx is None:
            return None
        ifiles = sorted(os.listdir(osp.join(scene, "image_left")))
        dfiles = sorted(os.listdir(osp.join(scene, "depth_left")))
        imgs, disps = [], []
        for k in idx:
            img = cv2.imread(osp.join(scene, "image_left", ifiles[k]))
            imgs.append(augment_image(img, self.rng))
            disps.append(self._disparity(osp.join(scene, "depth_left", dfiles[k])))
        return {
            "images": np.stack(imgs),
            "poses": poses[idx],
            "disps": np.stack(disps),
            "intrinsics": self.INTRINSICS.copy(),
        }
