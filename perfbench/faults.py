"""Faults planted in the program, to show which compared number each one
fails (``perfbench/run.py --fault <name>``, and the CPU tests).  Nothing
plants one in a run of the check.

Each fault patches a function of ``dbaf_tpu_torch`` that the timed path
looks up through its module at each call; :func:`plant` returns the undo.

* ``state_unchanged``: the coupled round body (the dense BA's reduced
  camera system, the factor graph's LM and the retraction) returns the
  window's state as it came in;
* ``half_batch``: the update operator runs on the first half of a round's
  edges, and the rest take the mean of those outputs;
* ``answer_altered``: the feature encoder's output scaled by 1.25;
* ``wrong_edges``: each proximity selection loses its last edge pair;
* ``dropped_pack``: the asynchronous coupled pipeline's host skips every
  seventh pack it drains (its mirrors and its cull);
* ``cull_left_in``: the asynchronous pipeline's host keeps a keyframe
  that the device culled.
"""

from __future__ import annotations

from typing import Callable, List


def _patch(obj, name: str, new) -> Callable[[], None]:
    orig = getattr(obj, name)
    setattr(obj, name, new)
    return lambda: setattr(obj, name, orig)


def state_unchanged():
    import torch

    from dbaf_tpu_torch.fusion import device_graph

    def body(poses_buf, disps_buf, *args, fg=None, n_iters=1, **kwargs):
        fg = args[9] if fg is None else fg
        zero = torch.zeros((), dtype=torch.int64, device=poses_buf.device)
        return poses_buf, disps_buf, fg, [zero] * n_iters

    return [_patch(device_graph, "coupled_rounds_body", body)]


def half_batch():
    import torch

    from dbaf_tpu_torch.models.net import DroidNet

    step = DroidNet.update_step

    def half(self, net, inp, corr, flow=None):
        E = net.shape[0]
        k = (E + 1) // 2
        outs = step(self, net[:k], inp[:k], corr[:k], None if flow is None else flow[:k])
        return tuple(torch.cat([o, o.float().mean(0, keepdim=True).to(o.dtype)
                                .expand((E - k,) + o.shape[1:])]) for o in outs)

    return [_patch(DroidNet, "update_step", half)]


def answer_altered():
    from dbaf_tpu_torch.models.net import DroidNet

    feat = DroidNet.features_only

    def altered(self, images):
        return feat(self, images) * 1.25

    return [_patch(DroidNet, "features_only", altered)]


def wrong_edges():
    import torch

    from dbaf_tpu_torch.slam import edge_select, graph

    dev_sel = edge_select.select_proximity_edges

    def dev(*args, **kwargs):
        out_ii, out_jj, mask = dev_sel(*args, **kwargs)
        n = mask.long().sum()
        return out_ii, out_jj, torch.arange(mask.shape[0], device=mask.device) < n - 2

    def host(select):
        def sel(*args):
            out = select(*args)
            return out if out is None else (out[0][:-2], out[1][:-2])
        return sel

    return [_patch(edge_select, "select_proximity_edges", dev),
            _patch(graph, "select_proximity_edges", host(graph.select_proximity_edges)),
            _patch(graph, "select_proximity_edges_py", host(graph.select_proximity_edges_py))]


def dropped_pack():
    from dbaf_tpu_torch.slam.coupled_async import CoupledAsync

    drain = CoupledAsync._drain_one
    calls = [0]

    def drain_one(self):
        calls[0] += 1
        if calls[0] % 7 == 0:
            self.pending.pop(0).read()
            return
        drain(self)

    return [_patch(CoupledAsync, "_drain_one", drain_one)]


def cull_left_in():
    from dbaf_tpu_torch.slam.coupled_async import CoupledAsync

    return [_patch(CoupledAsync, "_host_apply_cull", lambda self, c: None)]


FAULTS = dict(state_unchanged=state_unchanged, half_batch=half_batch,
              answer_altered=answer_altered, wrong_edges=wrong_edges,
              dropped_pack=dropped_pack, cull_left_in=cull_left_in)


def plant(name: str) -> List[Callable[[], None]]:
    if name not in FAULTS:
        raise SystemExit(f"no fault {name!r}; the faults are {sorted(FAULTS)}")
    return FAULTS[name]()
