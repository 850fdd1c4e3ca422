"""The comparison that decides a run's ``correct``.

Each stage's sampled calls (``perfbench/capture.py``) are recomputed by the
plain reference in ``perfbench/reference/`` from the same inputs, and the
program's outputs are judged against it:

* ``fnet``, ``cnet`` from the raw frame and the benchmark's own weights;
* ``k2_gate``, ``k1_round`` from the program's feature maps and
  reprojected coordinates (the fnet stage checks the first from the frame);
* ``update`` from the program's edge state, context features, correlation
  features and motion features (each checked where it is made, above);
* ``solve``: the weighted reprojection residual (pixels, root mean square
  over the round's valid edges) that a coupled round leaves, from the
  formulas in float64 on the program's poses and disparities after it, the
  largest over the samples (each sample's residual before and after the
  round is printed beside it);
* ``edges``: the proximity edge selection from the program's candidate
  distances and existing edges, by the plain selection in float64; the
  count of list positions that differ, summed over the samples.

The other stage numbers are gaps of the program's output to the
reference's: ``|prog - ref| / |ref|`` in the Frobenius norm over the rows
whose inputs are finite, the largest over a stage's samples.

The whole run's trajectory (``terminate()``) is held against the scene's
ground truth by :func:`trajectory`: ``traj_m`` and ``traj_deg`` after the
rigid alignment of the window's rows, and ``ecef_m`` where the system is
georeferenced.  It covers what the stages above take as given: the dense
BA and the factor graph's solve, the edges' and the window's upkeep (culls,
rollups, marginalization), the asynchronous packs and the GNSS handoff.

Each cell's limits file (``perfbench/limits/<cell>.json``) names the
numbers it compares and their limits.

``controls`` computes the stage numbers with the reference in the
program's place, one precision below the configuration's: the network and
the correlations in float8 (the configuration states bfloat16), the edge
selection on distances rounded to bfloat16 (the program's are float32).
A round's residual and the trajectory have no reference in the program's
place; their upper readings come from the faults of ``perfbench/faults.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .reference import corr as rcorr
from .reference import edges as redges
from .reference import geometry
from .reference.droid import Droid
from .reference.lowp import fp8

NUMBERS = ("fnet", "cnet", "k2_gate", "k1_round", "update", "solve", "edges", "traj_m",
           "traj_deg", "ecef_m")
# what every cell's limits file compares; a cell adds those of the others
# that separate its sound runs from its faults (PERF.md says which)
REQUIRED = ("fnet", "cnet", "k2_gate", "k1_round", "update", "edges", "traj_m")


def _finite_rows(*ts: torch.Tensor) -> torch.Tensor:
    ok = None
    for t in ts:
        r = torch.isfinite(t.float()).reshape(t.shape[0], -1).all(dim=1)
        ok = r if ok is None else ok & r
    return ok


def gap(prog: torch.Tensor, ref: torch.Tensor, rows: Optional[torch.Tensor] = None) -> float:
    """|prog - ref|_F / |ref|_F over ``rows`` (all rows by default)."""
    p, r = prog.double(), ref.double()
    if rows is not None:
        p, r = p[rows], r[rows]
    den = torch.linalg.vector_norm(r)
    if not bool(den > 0):
        return float("inf")
    return float(torch.linalg.vector_norm(p - r) / den)


def _grid(H: int, W: int, device) -> torch.Tensor:
    y, x = torch.meshgrid(torch.arange(H, device=device, dtype=torch.float32),
                          torch.arange(W, device=device, dtype=torch.float32), indexing="ij")
    return torch.stack([x, y], dim=-1)


def _ints(x) -> List[int]:
    return [int(v) for v in np.asarray(torch.as_tensor(x).cpu()).reshape(-1)]


def _edge_case(sample):
    """(program's edge list, the selection's inputs) of one sampled call."""
    if sample["kind"] == "device":
        d, ii, jj, eii, ejj, emask, t0, t1, t, thresh = sample["args"]
        kw = sample["kwargs"]
        out_ii, out_jj, mask = (_ints(o) for o in sample["out"])
        prog = [(a, b) for a, b, m in zip(out_ii, out_jj, mask) if m]
        exist = [(a, b) for a, b, m in zip(_ints(eii), _ints(ejj), _ints(emask)) if m]
        t0, t1, t = int(t0), int(t1), int(t)
        case = dict(d=torch.as_tensor(d).double().cpu().numpy(), ii=_ints(ii), jj=_ints(jj),
                    cc=kw["src"] * kw["win"], exist=exist, t0=t0, t1=t1, t=t,
                    src=kw["src"], win=kw["win"], rad=kw["rad"], nms=kw["nms"],
                    thresh=float(thresh), max_factors=kw["max_factors"], max_out=kw["max_out"])
    else:
        ii, jj, cc, eii, ejj, t0, t1, t, rad, nms, thresh, max_factors = sample["args"][:12]
        prog = list(zip(_ints(sample["out"][0]), _ints(sample["out"][1])))
        case = dict(d=np.asarray(sample["d"], np.float64), ii=_ints(ii), jj=_ints(jj),
                    cc=int(cc), exist=list(zip(_ints(eii), _ints(ejj))), t0=int(t0),
                    t1=int(t1), t=int(t), src=int(t) - int(t0), win=int(t) - int(t1),
                    rad=int(rad), nms=int(nms), thresh=float(thresh),
                    max_factors=int(max_factors),
                    max_out=4 * (int(max_factors) + 4 * (int(t) - int(t0)) * (int(rad) + 2) + 8))
    return prog, case


def _select(case, d):
    kw = {k: v for k, v in case.items() if k not in ("d", "ii", "jj", "cc", "exist", "t0",
                                                      "t1", "t")}
    return redges.select(list(d), case["ii"], case["jj"], case["cc"], case["exist"],
                         case["t0"], case["t1"], case["t"], **kw)


def residual(s, poses, disps) -> float:
    """Root mean square of sqrt(weight) * (target - reprojection) over the
    valid edges of a sampled round, in pixels, in float64."""
    m = s["mask"].bool()
    ii, jj = s["ii"][m], s["jj"][m]
    coords, valid = geometry.reproject(poses.double(), disps.double(), s["intr"].double(), ii, jj)
    w = s["weight"][m].double() * valid
    r2 = (w * (s["target"][m].double() - coords) ** 2).sum()
    return float(torch.sqrt(r2 / w.sum().clamp(min=1e-300)))


def _bf16(d: np.ndarray) -> np.ndarray:
    return torch.as_tensor(d).to(torch.bfloat16).double().numpy()


def edge_mismatches(samples: list, control: bool = False) -> Optional[int]:
    """List positions at which the program's selections (or, with
    ``control``, the plain selection on bfloat16 distances) differ from the
    plain selection's, summed over the samples."""
    if not samples:
        return None
    total = 0
    for s in samples:
        prog, case = _edge_case(s)
        ref = _select(case, case["d"])
        if control:
            prog = _select(case, _bf16(case["d"]))
        total += redges.mismatches(prog, ref)
    return total


def trajectory(rows: np.ndarray, gt_R: np.ndarray, gt_p: np.ndarray,
               ecef: Optional[np.ndarray] = None,
               gt_ecef: Optional[np.ndarray] = None) -> Dict[str, Optional[float]]:
    """The window's trajectory rows (N, 7) against the truth; every number
    None where there are fewer than three rows or a row is not finite."""
    out: Dict[str, Optional[float]] = dict(traj_m=None, traj_deg=None, ecef_m=None)
    rows = np.asarray(rows, np.float64)
    if len(rows) < 3 or not np.all(np.isfinite(rows)):
        return out
    if ecef is not None and not np.all(np.isfinite(ecef)):
        ecef = None
    out.update(geometry.trajectory_errors(rows, gt_R, gt_p, ecef, gt_ecef))
    # the errors along the window, for the diagnostics line: every tenth row
    dp, ang, ecef_err = geometry.row_errors(rows, gt_R, gt_p, ecef, gt_ecef)
    step = slice(None, None, 10)
    out["traj_rows"] = dict(m=np.round(dp[step], 4).tolist(), deg=np.round(ang[step], 3).tolist(),
                            ecef_m=None if ecef_err is None
                            else np.round(ecef_err[step], 3).tolist())
    return out


@torch.no_grad()
def readings(samples: Dict[str, list], sd: Dict[str, torch.Tensor],
             control: bool = False) -> Dict[str, Optional[float]]:
    """Each number over its stage's samples (None where a stage kept none).
    With ``control`` the reference in the lower precision takes the
    program's place."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _readings(samples, sd, control)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _readings(samples, sd, control):
    ref = Droid(sd)
    low = Droid(sd, q=fp8)
    q = fp8 if control else None
    out: Dict[str, Optional[float]] = {}

    vals = []
    for s in samples["fnet"]:
        r = ref.fnet(s["images"])
        p = low.fnet(s["images"]) if control else s["out"]
        vals.append(gap(p, r))
    out["fnet"] = max(vals) if vals else None

    vals = []
    for s in samples["cnet"]:
        rn, ri = ref.cnet(s["images"])
        pn, pi = low.cnet(s["images"]) if control else (s["net"], s["inp"])
        vals.append(max(gap(pn, rn), gap(pi, ri)))
    out["cnet"] = max(vals) if vals else None

    vals = []
    for s in samples["k2_gate"]:
        kf, cur = s["kf"][None], s["cur"][None]
        coords = _grid(kf.shape[1], kf.shape[2], kf.device)[None]
        r = rcorr.lookup(rcorr.pyramid(kf, cur), coords)
        p = rcorr.lookup(rcorr.pyramid(kf, cur, q), coords, q) if control else s["corr"]
        vals.append(gap(p, r))
    out["k2_gate"] = max(vals) if vals else None

    vals = []
    for s in samples["k1_round"]:
        rows = _finite_rows(s["coords"])
        f1, f2, c = s["f1"][rows], s["f2"][rows], s["coords"][rows]
        r = rcorr.lookup(rcorr.pyramid(f1, f2), c)
        p = rcorr.lookup(rcorr.pyramid(f1, f2, q), c, q) if control else s["corr"][rows]
        vals.append(gap(p, r))
        del r, p
    out["k1_round"] = max(vals) if vals else None

    vals = []
    for s in samples["update"]:
        rows = _finite_rows(s["net"], s["inp"], s["corr"], s["motn"])
        args = [s[k][rows] for k in ("net", "inp", "corr", "motn")]
        r = ref.update(*args)
        p = low.update(*args) if control else [o[rows] for o in s["outs"]]
        vals.append(max(gap(a, b) for a, b in zip(p, r)))
    out["update"] = max(vals) if vals else None

    after = [residual(s, s["poses1"], s["disps1"]) for s in samples["solve"]]
    before = [residual(s, s["poses0"], s["disps0"]) for s in samples["solve"]]
    out["solve"] = max(after) if after else None
    out["solve_pairs"] = [[round(b, 5), round(a, 5)] for b, a in zip(before, after)]
    out["edges"] = edge_mismatches(samples["edges"], control)
    return out


def verdict(values: Dict[str, Optional[float]], limits: Dict[str, float]):
    """(correct, [(name, value, limit)]): the cell's limits file names the
    numbers it compares, and each has to be there, finite and within its
    limit."""
    rows = [(n, values.get(n), lim) for n, lim in limits.items()]
    ok = bool(rows) and all(v is not None and v == v and v <= lim for _, v, lim in rows)
    return ok, rows
