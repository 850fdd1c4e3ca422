"""The streaming runner shared by the demos (port of
``dbaf_tpu/apps/runner.py``): track a frame stream, write the TUM
trajectory (with ECEF columns once georeferenced), the dense export under
``cfg.save_pkl``, and the ATE against a ground-truth file.

No image, plotting or HDF5 library is imported here: the streams that need
one import it themselves.
"""

from __future__ import annotations

import json
from typing import Iterable, Optional

import numpy as np
import torch

from ..eval.ate import evaluate_trajectory
from ..eval.traj_io import read_tum, write_tum


def weights_selftest(weights_path: str) -> dict:
    """Checkpoint self-test (the reference's weight surgery, dbaf.py:38-48):
    load a reference-format ``.pth`` into the port's DroidNet (a key or
    shape it does not take raises), run the encoders and one f32 update
    step on the CPU, and check that delta and weight are finite and the
    weight within [0, 1]."""
    from ..models.convert import load_reference_state_dict
    from ..models.net import DroidNet

    params = load_reference_state_dict(
        torch.load(weights_path, map_location="cpu", weights_only=True))
    model = DroidNet(dtype=torch.float32, device="cpu")
    model.load_state_dict(params)
    model.eval()
    rng = np.random.default_rng(0)
    imgs = torch.as_tensor(rng.integers(0, 255, size=(1, 64, 80, 3)), dtype=torch.float32)
    fmaps = model.features_only(imgs)
    net, inp = model.context_only(imgs)
    corr = torch.as_tensor(rng.normal(size=(1, 8, 10, 196)), dtype=torch.float32)
    _, delta, weight = model.update_step(net, inp, corr)
    ok = (bool(torch.isfinite(delta).all()) and bool(torch.isfinite(weight).all())
          and float(weight.min()) >= 0.0 and float(weight.max()) <= 1.0)
    if not ok:
        raise RuntimeError("weights self-test: the update operator gave non-finite or "
                           "out-of-range outputs from " + weights_path)
    out = {"selftest": "ok", "weights": weights_path, "fmap_shape": list(fmaps.shape),
           "delta_ch": int(delta.shape[-1])}
    print(json.dumps(out))
    return out


def run(system, stream: Iterable, result_path: Optional[str] = None,
        pkl_path: Optional[str] = None, gt_path: Optional[str] = None,
        max_frames: Optional[int] = None) -> dict:
    """Track ``(t, image, intrinsics)`` from ``stream`` through a
    ``DBAFusion``; then write the trajectory (``result_path``), the
    filtered and raw reconstructions (``pkl_path``, with ``cfg.save_pkl``)
    and, with ``gt_path``, the SE3-aligned ATE.  Returns (and prints as one
    JSON line) ``{"frames", "keyframes"[, "ate_rmse", "matched"]}``."""
    n = 0
    try:
        for t, image, intrinsics in stream:
            system.track(t, image, intrinsics=intrinsics)
            n += 1
            if max_frames is not None and n >= max_frames:
                break
    except KeyboardInterrupt:
        pass
    finally:
        traj = system.terminate()
        if result_path:
            ecef = system.trajectory_ecef
            # once georeferenced, the reference's row: the 8 TUM fields and
            # 3 ECEF ones (dbaf_frontend.py:270-272)
            rows = [list(r) + list(ecef[k]) if k in ecef else list(r)
                    for k, r in enumerate(traj)]
            write_tum(result_path, rows)
        if pkl_path and system.cfg.save_pkl:
            from ..eval.export import save_reconstruction

            save_reconstruction(system, pkl_path)

    out = {"frames": n, "keyframes": int(len(traj))}
    if gt_path and len(traj) > 3:
        out.update(evaluate_trajectory(traj, read_tum(gt_path), align="se3"))
    print(json.dumps(out))
    return out
