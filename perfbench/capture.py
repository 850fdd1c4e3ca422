"""What a run keeps of its timed path for the comparison after the window.

Each stage the comparison covers keeps a sample of its calls in the window,
drawn from the seed by reservoir sampling (every call of the window equally
likely, whatever the window's length).  A kept call's inputs and outputs
are copied on the device (no host read), and the comparison runs once the
window has closed (``perfbench/check.py``).

The stages and where they are seen:

* ``fnet``, ``cnet``: the feature and context encoders, at the system's
  injected ``feat_fn``/``ctx_fn`` (``DBAFusion``'s documented hooks);
* ``k2_gate``: the motion gate's correlation lookup (kernel K2 on the card),
  at the injected ``update_fn``'s gate call: the features of the frame and of
  the last keyframe (every frame is admitted, so the frame before) and the
  correlation features the gate passed;
* ``k1_round``, ``update``: an update round's correlation (kernel K1) and
  update operator, at the injected ``update_fn``'s round call, with the
  video's feature rows of the round's edges;
* ``solve``: one coupled round (the dense BA's reduced camera system, the
  factor graph's LM, the retraction), at
  ``dbaf_tpu_torch.fusion.device_graph.coupled_rounds_body``, which both
  coupled flows call through the module: the window's poses and
  disparities before and after it, and the round's edges, targets and
  weights;
* ``edges``: the proximity edge selection, where it runs: on the device
  at ``dbaf_tpu_torch.slam.edge_select.select_proximity_edges`` (the
  asynchronous coupled step's) and on the host at
  ``dbaf_tpu_torch.slam.graph.select_proximity_edges`` and its Python
  route (the synchronous flow's); both are looked up through their module
  at each call.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

STAGES = ("fnet", "cnet", "k2_gate", "k1_round", "update", "solve", "edges")
PER_STAGE = 3
# an edge selection is a few tensors of tens of entries: more of them are kept
KEEP = dict(edges=16)


def clone(x: Any) -> Any:
    """A copy of every tensor (on its device) and array in a nest of tuples,
    lists and dicts."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, np.ndarray):
        return x.copy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(clone(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(clone(v) for v in x)
    if isinstance(x, dict):
        return {k: clone(v) for k, v in x.items()}
    return x


class Reservoir:
    """``k`` calls drawn uniformly from all the calls offered, from ``rng``."""

    def __init__(self, rng: np.random.Generator, k: int = PER_STAGE):
        self.rng, self.k = rng, k
        self.offered = 0
        self.kept: List[Any] = []

    def slot(self) -> Optional[int]:
        """Where this call goes, or None if it is not kept."""
        i = self.offered
        self.offered += 1
        if i < self.k:
            return i
        j = int(self.rng.integers(0, i + 1))
        return j if j < self.k else None

    def put(self, slot: int, item: Any) -> None:
        if slot == len(self.kept):
            self.kept.append(item)
        else:
            self.kept[slot] = item


class Capture:
    """The samples of one run; on only inside the window."""

    def __init__(self, seed: int):
        self.on = False
        self.samples: Dict[str, Reservoir] = {
            name: Reservoir(np.random.default_rng([int(seed) % (1 << 63), i]),
                            KEEP.get(name, PER_STAGE))
            for i, name in enumerate(STAGES)}
        self.feats: List[torch.Tensor] = []  # the last two fnet outputs
        self.video = None

    def _take(self, stage: str):
        return self.samples[stage].slot() if self.on else None

    # -- injected encoders --------------------------------------------------
    def wrap_feat(self, feat_fn):
        def feat(images):
            out = feat_fn(images)
            self.feats = (self.feats + [out])[-2:]
            s = self._take("fnet")
            if s is not None:
                self.samples["fnet"].put(s, dict(images=clone(images), out=clone(out)))
            return out
        return feat

    def wrap_ctx(self, ctx_fn):
        def ctx(images):
            net, inp = ctx_fn(images)
            s = self._take("cnet")
            if s is not None:
                self.samples["cnet"].put(s, dict(images=clone(images), net=clone(net),
                                                 inp=clone(inp)))
            return net, inp
        return ctx

    # -- the injected update operator ----------------------------------------
    def gate(self, corr):
        s = self._take("k2_gate")
        if s is not None and len(self.feats) == 2:
            self.samples["k2_gate"].put(s, dict(kf=clone(self.feats[0][0]),
                                                cur=clone(self.feats[1][0]),
                                                corr=clone(corr)))

    def round(self, net, inp, corr, motn, ii, jj, aux, outs):
        s = self._take("k1_round")
        if s is not None:
            self.samples["k1_round"].put(s, dict(
                f1=clone(self.video.feature_rows("fmaps", ii)),
                f2=clone(self.video.feature_rows("fmaps", jj)),
                coords=clone(aux["coords1"]), corr=clone(corr)))
        s = self._take("update")
        if s is not None:
            self.samples["update"].put(s, dict(net=clone(net), inp=clone(inp), corr=clone(corr),
                                               motn=clone(motn), outs=clone(outs)))

    # -- the coupled round ----------------------------------------------------
    def wrap_solve(self, body):
        def solve(poses_buf, disps_buf, damping_buf, intrinsics, target, weight, ii, jj, mask,
                  t0, n, *args, P, **kwargs):
            s = self._take("solve")
            if s is None:
                return body(poses_buf, disps_buf, damping_buf, intrinsics, target, weight, ii,
                            jj, mask, t0, n, *args, P=P, **kwargs)
            rows = torch.clamp(torch.as_tensor(t0, device=poses_buf.device)
                               + torch.arange(P, device=poses_buf.device),
                               max=poses_buf.shape[0] - 1)
            keep = dict(poses0=poses_buf[rows].clone(), disps0=disps_buf[rows].clone(),
                        intr=clone(intrinsics), target=clone(target), weight=clone(weight),
                        ii=clone(ii), jj=clone(jj), mask=clone(mask))
            out = body(poses_buf, disps_buf, damping_buf, intrinsics, target, weight, ii, jj,
                       mask, t0, n, *args, P=P, **kwargs)
            keep.update(poses1=out[0][rows].clone(), disps1=out[1][rows].clone())
            self.samples["solve"].put(s, keep)
            return out
        return solve

    # -- the edge selection -------------------------------------------------
    def wrap_device_select(self, select):
        def sel(*args, **kwargs):
            out = select(*args, **kwargs)
            s = self._take("edges")
            if s is not None:
                self.samples["edges"].put(s, dict(kind="device", args=clone(args),
                                                  kwargs=dict(kwargs), out=clone(out)))
            return out
        return sel

    def wrap_host_select(self, select):
        def sel(d, *args):
            d0 = np.array(d, dtype=np.float64)  # the native scheduler writes into d
            out = select(d, *args)
            if out is not None:
                s = self._take("edges")
                if s is not None:
                    self.samples["edges"].put(s, dict(kind="host", d=d0, args=clone(args),
                                                      out=clone(out)))
            return out
        return sel


def watch(cap: Capture):
    """Route the port's coupled rounds and edge selections through ``cap``;
    returns the undo."""
    from dbaf_tpu_torch.fusion import device_graph
    from dbaf_tpu_torch.slam import edge_select, graph

    wraps = [(device_graph, "coupled_rounds_body", cap.wrap_solve),
             (edge_select, "select_proximity_edges", cap.wrap_device_select),
             (graph, "select_proximity_edges", cap.wrap_host_select),
             (graph, "select_proximity_edges_py", cap.wrap_host_select)]
    undo = []
    for mod, name, wrap in wraps:
        orig = getattr(mod, name)
        setattr(mod, name, wrap(orig))
        undo.append(lambda mod=mod, name=name, orig=orig: setattr(mod, name, orig))
    return undo
