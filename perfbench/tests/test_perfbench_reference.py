"""The benchmark's plain references at small sizes: the edge selection
against the program's device and host schedulers on random cases (a sound
program reads 0 mismatches), and the geometry behind ``solve``,
``traj_m``, ``traj_deg`` and ``ecef_m``."""

import numpy as np
import pytest
import torch

from perfbench import check
from perfbench.reference import edges, geometry

SKIP = (-4, -5, -6)


def _case(rng):
    t = int(rng.integers(8, 40))
    t0 = t1 = t - 5
    r, c = np.meshgrid(np.arange(5), np.arange(5), indexing="ij")
    ii = np.concatenate([t0 + r.reshape(-1), np.full(3, t - 1)])
    jj = np.concatenate([t1 + c.reshape(-1), t0 + np.asarray(SKIP)])
    d = rng.uniform(0.0, 24.0, len(ii))
    d[rng.random(len(ii)) < 0.1] = 150.0
    n_exist = int(rng.integers(0, 12))
    ei = rng.integers(max(0, t - 12), t, n_exist)
    ej = rng.integers(max(0, t - 12), t, n_exist)
    return dict(d=d.astype(np.float32).astype(np.float64), ii=ii, jj=jj, ei=ei, ej=ej,
                t0=t0, t1=t1, t=t, rad=int(rng.integers(1, 3)), nms=int(rng.integers(0, 3)),
                max_factors=int(rng.choice([8, 48])))


def _plain(case, max_out):
    return edges.select(list(case["d"]), list(case["ii"]), list(case["jj"]), 25,
                        list(zip(case["ei"], case["ej"])), case["t0"], case["t1"], case["t"],
                        src=5, win=5, rad=case["rad"], nms=case["nms"], thresh=16.0,
                        max_factors=case["max_factors"], max_out=max_out)


@pytest.mark.parametrize("seed", range(16))
def test_plain_selection_matches_the_device_scheduler(seed):
    from dbaf_tpu_torch.slam.edge_select import select_proximity_edges

    case = _case(np.random.default_rng(seed))
    T = lambda a: torch.as_tensor(np.asarray(a, np.int64))  # noqa: E731
    out_ii, out_jj, m = select_proximity_edges(
        torch.as_tensor(case["d"], dtype=torch.float32), T(case["ii"]), T(case["jj"]),
        T(case["ei"]), T(case["ej"]), torch.ones(len(case["ei"]), dtype=torch.bool),
        T(case["t0"]), T(case["t1"]), T(case["t"]), 16.0, src=5, win=5, n_skip=3,
        rad=case["rad"], nms=case["nms"], max_factors=case["max_factors"], max_out=160)
    prog = list(zip(out_ii[m].tolist(), out_jj[m].tolist()))
    assert edges.mismatches(prog, _plain(case, 160)) == 0


@pytest.mark.parametrize("seed", range(16))
def test_plain_selection_matches_the_host_scheduler(seed):
    from dbaf_tpu_torch.slam.graph import select_proximity_edges, select_proximity_edges_py

    case = _case(np.random.default_rng(100 + seed))
    args = (case["ii"], case["jj"], 25, case["ei"], case["ej"], case["t0"], case["t1"],
            case["t"], case["rad"], case["nms"], 16.0, case["max_factors"])
    out = select_proximity_edges(case["d"].copy(), *args)
    if out is None:
        out = select_proximity_edges_py(case["d"].copy(), *args, False)
    max_out = 4 * (case["max_factors"] + 4 * 5 * (case["rad"] + 2) + 8)
    assert edges.mismatches(list(zip(*out)), _plain(case, max_out)) == 0


def test_edge_mismatches_count_a_dropped_pair():
    ref = [(1, 0), (0, 1), (2, 1), (1, 2)]
    assert edges.mismatches(ref, ref) == 0
    assert edges.mismatches(ref[:2], ref) == 2
    assert edges.mismatches([(1, 0), (1, 2), (2, 1), (0, 1)], ref) == 2


def _random_poses(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q, rng.normal(size=(n, 3))


def test_trajectory_errors_ignore_a_rigid_motion():
    rng = np.random.default_rng(0)
    q, p = _random_poses(rng, 30)
    R = geometry.quat_to_matrix(torch.as_tensor(q)).numpy()
    A = geometry.quat_to_matrix(torch.as_tensor([0.2, -0.1, 0.3, 0.92]) /
                                torch.linalg.norm(torch.as_tensor([0.2, -0.1, 0.3, 0.92]))).numpy()
    est_R = np.einsum("ji,njk->nik", A, R)  # A^T R_k
    est_p = (p - [1.0, -2.0, 0.5]) @ A  # A^T (p_k - c)
    from scipy.spatial.transform import Rotation

    est = np.concatenate([est_p, Rotation.from_matrix(est_R).as_quat()], 1)
    got = geometry.trajectory_errors(est, R, p, est_ecef=p + 0.5, gt_ecef=p)
    assert got["traj_m"] < 1e-6 and got["traj_deg"] < 1e-5
    assert got["ecef_m"] == pytest.approx(0.5 * np.sqrt(3))
    est[7, :3] += (A.T @ [0.0, 0.0, 3.0])  # one row 3 m off
    got = geometry.trajectory_errors(est, R, p)
    assert 0.3 < got["traj_m"] < 0.6


def test_residual_is_zero_at_the_poses_that_made_the_targets():
    rng = np.random.default_rng(1)
    q, t = _random_poses(rng, 4)
    q[:, 3] += 8.0  # small turns between the frames
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    poses = torch.as_tensor(np.concatenate([0.05 * t, q], 1), dtype=torch.float32)
    disps = torch.full((4, 6, 8), 0.25)
    intr = torch.tensor([8.0, 8.0, 4.0, 3.0])
    ii, jj = torch.tensor([0, 1, 2, 3]), torch.tensor([1, 2, 3, 0])
    coords, valid = geometry.reproject(poses, disps, intr, ii, jj)
    grid, _ = geometry.reproject(poses, disps, intr, ii, ii)
    u, v = torch.meshgrid(torch.arange(8.0), torch.arange(6.0), indexing="xy")
    assert torch.allclose(grid, torch.stack([u, v], -1).expand_as(grid), atol=1e-4)
    s = dict(mask=torch.ones(4, dtype=torch.bool), ii=ii, jj=jj, intr=intr, target=coords,
             weight=valid.expand_as(coords))
    assert check.residual(s, poses, disps) < 1e-6
    moved = poses.clone()
    moved[1, 0] += 0.1
    assert check.residual(s, moved, disps) > 0.05
