"""One run of one benchmark cell: set-up, the measured window, the traced
frames, the comparison, the result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything about a cell is found by name: the cell and its metrics in
``BENCHMARK.json``, the configuration in ``perfbench/configs/<config>.json``,
the traffic mix in ``perfbench/traffic/<traffic>.json``, each metric's
reader in ``perfbench/metrics/<metric>.py`` and the cell's limits in
``perfbench/limits/<cell>.json``.

A run, in order:

1. set-up: the scene from the seed, the weights on the card, the system
   (``dbaf_tpu_torch``'s ``DBAFusion`` with the network's encoders and an
   update operator that folds the scene's oracle into the network's outputs
   at 1e-30, as the port's coupled smoke phases do), then frames until the
   configuration's window-opening events (VI initialization, and the GNSS
   handoff where the configuration names it) and ``warm_frames`` more;
2. the window: frames, each fed when the last call returned, until
   ``--seconds`` have passed;
3. with ``--trace 1``, ``profiled_frames`` more frames under
   ``torch.profiler``;
4. the peak memory, ``terminate()``, the system freed, and the comparison
   of the window's sampled calls against the plain reference and of the
   trajectory of the window's first ``compared_frames`` frames against the
   scene's ground truth.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "dbaf_tpu")
HOST_THREADS = 4  # torch's CPU threads: one process, few threads, steady host times


def pin_host_threads() -> None:
    """Keep the process on the last ``HOST_THREADS`` cores it may use, so
    that its threads do not wander between cores."""
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, cores[-HOST_THREADS:])


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_spec(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: str):
    """(end-to-end metrics, per-layer metrics) the cell reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


def load_reader(name: str, root: str = HERE):
    path = os.path.join(root, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def build_config(spec: dict):
    """The port's DBAFusionConfig from a configuration file's ``dbafusion``
    tree (every field given; a field the port lacks raises)."""
    from dbaf_tpu_torch.utils import config as C

    d = dict(spec)
    groups = dict(graph=C.GraphConfig, frontend=C.FrontendConfig, ba=C.BAConfig,
                  sensors=C.SensorConfig)
    kw = {k: (groups[k](**v) if k in groups else v) for k, v in d.items()}
    kw["image_size"] = tuple(kw["image_size"])
    kw["graph"] = dataclasses.replace(kw["graph"], skip_edge=tuple(kw["graph"].skip_edge))
    return C.DBAFusionConfig(**kw)


def _async_active(system) -> bool:
    ca = system.frontend._casync
    return ca is not None and ca.active


# the start-up events a window can wait for, read off the port's state
EVENTS = {
    "vi_init": lambda s: bool(s.video.imu_enabled),
    "gnss_init": lambda s: s.graph.coupled.gnss_init_t1 > 0,
    # the bias reinitialization 5 s after VI initialization (frontend.py:250)
    # sets vi_init_time far ahead; the coupled solve then consumes the flag
    "bias_reinit": lambda s: s.graph.coupled.vi_init_time >= 1e9 and not s.graph.coupled.reinit,
    "coupled_async_active": _async_active,
}


class Run:
    """The state of one run that the metric readers read."""

    def __init__(self, cell: str, seed: int, seconds: float, root: str = HERE,
                 device: str = "cuda", control: bool = False, overrides: Optional[dict] = None,
                 fault: Optional[str] = None):
        self.root = root
        self.bench = load_json(os.path.dirname(root), "BENCHMARK.json")
        self.spec = cell_spec(self.bench, cell)
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.device, self.control, self.fault = device, control, fault
        self.config = load_json(root, "configs", self.spec["config"] + ".json")
        self.traffic = load_json(root, "traffic", self.spec["traffic"] + ".json")
        for key, value in (overrides or {}).items():  # the CPU tests' small sizes
            top, *path = key.split(".")
            node = getattr(self, top)
            for p in path[:-1]:
                node = node[p]
            node[path[-1]] = value
        self.state: Dict[str, dict] = {}
        self.window: dict = {}
        self.work = dict(frames=0, admitted=0, edge_rounds=0.0)
        self.profile: Optional[dict] = None
        self.profiled_frames = 0
        self.setup_s = None

    # -- set-up ---------------------------------------------------------------
    def build(self):
        import torch

        from dbaf_tpu_torch.models.convert import load_reference_state_dict
        from dbaf_tpu_torch.models.net import DroidNet
        from dbaf_tpu_torch.slam.system import DBAFusion

        from . import capture, faults, scene, weights

        self.undo = faults.plant(self.fault) if self.fault else []
        dev = torch.device(self.device)
        self.cfg = build_config(self.config["dbafusion"])
        if self.control:
            self.cfg.graph.corr_int8 = True  # the program's own lower-precision path
        self.scene = scene.Scene(self.traffic, self.config, self.seed)
        self.sd = weights.reference_state_dict(self.seed, dev)
        net_cfg = self.config["network"]
        model = DroidNet(dtype=getattr(torch, net_cfg["dtype"]), device=dev, agg=False)
        params = load_reference_state_dict(self.sd)
        model.load_state_dict({k: v for k, v in params.items() if not k.startswith("update.agg.")})
        model.eval()
        oracle = scene.make_oracle(self.scene.gt_cw, self.scene.gt_disps, self.scene.intr8, dev)
        cap = self.capture = capture.Capture(self.seed)

        def update_fn(net, inp, corr, motn, ii, jj, aux):
            outs = model.update_fn(net, inp, corr, motn, ii, jj, aux)
            if "id_map" not in aux:  # the motion gate
                cap.gate(corr)
                return outs
            cap.round(net, inp, corr, motn, ii, jj, aux, outs)
            _, d_o, w_o = oracle(net, inp, corr, motn, ii, jj, aux)
            net2, delta, weight = outs
            return net2, d_o + delta.float() * 1e-30, w_o + weight.float() * 1e-30

        self.system = DBAFusion(self.cfg, device=dev, feat_fn=cap.wrap_feat(model.features_only),
                                ctx_fn=cap.wrap_ctx(model.context_only), update_fn=update_fn)
        cap.video = self.system.video
        sens = self.config["sensors_of_deployment"]
        s = self.scene.sensors()
        coupled = self.system.set_multisensor(self.scene.imu, self.scene.Tbc,
                                              all_gnss=s["all_gnss"], all_odo=s["all_odo"],
                                              tbg=s["tbg"], ten0=s["ten0"],
                                              imu_noise=sens["imu_noise"])
        for key in ("init_bias_sigma", "init_pose_sigma"):
            if sens.get(key) is not None:
                setattr(coupled, key, np.asarray(sens[key], float))
        self.undo += capture.watch(cap)
        self.id_map = np.zeros(self.cfg.buffer, np.int64)
        self.k = 0

    def feed(self) -> float:
        """Feed the next frame; returns the seconds its ``track`` call took."""
        import torch

        from dbaf_tpu_torch.utils.device import upload

        sysm, k, fps = self.system, self.k, self.scene.fps
        v, g = sysm.video, sysm.graph
        image = self.scene.frame(k)
        intr = self.scene.intr8 * 8.0
        dev = torch.device(self.device)
        self.id_map[v.counter] = k
        g.aux = {"id_map": upload(self.id_map, dev)}
        t0 = time.perf_counter()
        sysm.track(k / fps, image, intrinsics=intr)
        dt = time.perf_counter() - t0
        n = v.counter
        self.id_map[:n] = np.round(v.tstamp[:n] * fps).astype(np.int64)
        g.aux = {"id_map": upload(self.id_map, dev)}
        self.k += 1
        return dt

    def ready(self) -> bool:
        """Whether every event the configuration's window waits for has come."""
        return all(EVENTS[e](self.system) for e in self.config["window"]["opens_after"])

    def set_up(self, t_start: float):
        """Everything before the window; ``setup_split`` keeps the seconds
        from ``t_start`` at which each part of it ended."""
        import torch

        split = self.setup_split = {"imports": time.perf_counter() - t_start}
        self.build()
        split["system_built"] = time.perf_counter() - t_start
        w = self.config["window"]
        limit = int(w["setup_frame_limit"])
        while not self.ready():
            if self.k >= limit:
                raise RuntimeError(f"the window's events {w['opens_after']} did not come in "
                                   f"{limit} frames")
            self.feed()
            for e in w["opens_after"]:
                if e not in split and EVENTS[e](self.system):
                    split[e] = time.perf_counter() - t_start
                    split[e + "_frame"] = self.k - 1
        for _ in range(int(w["warm_frames"])):
            self.feed()
        if self.device != "cpu":
            torch.cuda.synchronize()
        self.setup_s = time.perf_counter() - t_start

    # -- the window -----------------------------------------------------------
    def _counts(self):
        fe, g = self.system.frontend, self.system.graph
        return fe.update_rounds, fe.keyframe_steps, len(g.ii)

    def _path(self) -> str:
        """How the last frame ran, for the diagnostics line: ``a`` the
        asynchronous coupled step, ``s`` the synchronous flow; upper case
        where the frontend's cull count moved."""
        culls = self.system.frontend.culls
        tag = "a" if _async_active(self.system) else "s"
        tag = tag if culls == self._culls else tag.upper()
        self._culls = culls
        return tag

    def measure(self, readers):
        import torch

        sync = torch.cuda.synchronize if self.device != "cpu" else (lambda: None)
        times, path = [], []
        self.first_frame = self.k
        for mod in readers:
            if hasattr(mod, "at_open"):
                mod.at_open(self)
        rounds0, steps0, _ = self._counts()
        self._culls = self.system.frontend.culls
        gc.collect()  # set-up's garbage, not the window's
        self.capture.on = True
        sync()
        t_open = time.perf_counter()
        while True:
            times.append(self.feed())
            path.append(self._path())
            rounds, steps, edges = self._counts()
            self.work["frames"] += 1
            self.work["edge_rounds"] += (rounds - rounds0) * edges
            rounds0 = rounds
            for mod in readers:
                if hasattr(mod, "after_frame"):
                    mod.after_frame(self)
            if time.perf_counter() - t_open >= self.seconds:
                break
        sync()
        window_s = time.perf_counter() - t_open
        self.capture.on = False
        self.work["admitted"] = self._counts()[1] - steps0
        for mod in readers:
            if hasattr(mod, "at_close"):
                mod.at_close(self)
        self.window = dict(frames=len(times), seconds=window_s, frame_s=times,
                           path="".join(path))

    def profile_frames(self, n: int):
        from .trace import Profile

        prof = Profile()
        for _ in range(n):
            self.feed()
        self.profile = prof.stop()
        self.profiled_frames = n

    def finish(self) -> dict:
        """Peak memory, the trajectory, the system freed; the readings."""
        import torch

        from . import check

        peak = torch.cuda.max_memory_allocated() if self.device != "cpu" else 0
        rows = self.system.terminate()
        ecef_of_row = self.system.trajectory_ecef
        # the window's first ``compared_frames`` frames: the same scene span
        # in every run, whatever the rate
        frames = np.round(rows[:, 0] * self.scene.fps).astype(np.int64)
        last = self.first_frame + int(self.config["window"]["compared_frames"])
        keep = np.nonzero((frames >= self.first_frame) & (frames < last))[0]
        gt_R, gt_p, gt_ecef = self.scene.truth(frames[keep])
        ecef = None
        if gt_ecef is not None and all(int(k) in ecef_of_row for k in keep):
            ecef = np.stack([ecef_of_row[int(k)] for k in keep])
        for undo in reversed(self.undo):
            undo()
        samples = {k: r.kept for k, r in self.capture.samples.items()}
        self.system = None
        self.capture.video = None
        gc.collect()
        if self.device != "cpu":
            torch.cuda.empty_cache()
        values = check.readings(samples, self.sd)
        values.update(check.trajectory(rows[keep, 1:], gt_R, gt_p, ecef, gt_ecef))
        controls = check.readings(samples, self.sd, control=True) if self.control else None
        return dict(peak=peak, traj_rows=len(keep), values=values, controls=controls)


def run_cell(cell: str, seed: int, seconds: float, trace: bool, t_start: float,
             root: str = HERE, device: str = "cuda", control: bool = False,
             overrides: Optional[dict] = None, chips: int = 1,
             fault: Optional[str] = None) -> dict:
    """One run; returns the result line's object (and, in ``"_controls"``,
    the control's readings where asked)."""
    import torch

    run = Run(cell, seed, seconds, root, device, control, overrides, fault)
    e2e, layer = cell_metrics(run.bench, cell)
    wanted = layer if trace else e2e
    readers = [load_reader(m["name"], root) for m in wanted]
    run.set_up(t_start)
    run.measure(readers)
    if trace:
        run.profile_frames(int(run.config["window"]["profiled_frames"]))
    out = run.finish()
    metrics = {}
    for m, mod in zip(wanted, readers):
        value = mod.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    from . import check

    limits = load_json(root, "limits", cell + ".json") if os.path.exists(
        os.path.join(root, "limits", cell + ".json")) else {}
    ok, rows = check.verdict(out["values"], limits)
    kind = torch.cuda.get_device_name(0) if device != "cpu" else "cpu"
    device_info = {"platform": "gpu" if device != "cpu" else "cpu", "kind": kind,
                   "count": chips, "memory_peak_bytes": int(out["peak"])}
    result = {"correct": bool(ok), "attempted": run.window["frames"],
              "failed": 0 if out["values"]["traj_m"] is not None else run.window["frames"],
              "metrics": metrics, "device": device_info}
    if trace and run.profile is not None:
        device_info.update(busy_s=run.profile["busy_s"], window_s=run.profile["wall_s"])
        result["breakdown"] = {"device_ops": [[n, s] for n, s in run.profile["device_ops"]],
                               "idle_gaps": run.profile["idle_gaps"]}
    result["compared"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    result["_readings"] = out["values"]
    result["_window"] = dict(frames=run.window["frames"], seconds=run.window["seconds"],
                             work=run.work, first_frame=run.first_frame,
                             traj_rows=out["traj_rows"],
                             frame_ms=[round(s * 1e3, 1) for s in run.window["frame_s"]],
                             path=run.window["path"], setup_split=run.setup_split)
    if out["controls"] is not None:
        result["_controls"] = out["controls"]
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="also compute the controls' readings: the program with its int8 "
                         "correlation, the reference one precision lower (not for the check)")
    ap.add_argument("--fault", default="",
                    help="plant one of perfbench/faults.py's faults in the program (not for "
                         "the check: it shows which number fails)")
    args = ap.parse_args(argv)
    bench = load_json(ROOT, "BENCHMARK.json")
    chips = int(cell_spec(bench, args.workload)["chips"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: this cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    pin_host_threads()
    torch.set_num_threads(HOST_THREADS)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start,
                      control=bool(args.control), chips=chips, fault=args.fault or None)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {bad}: the benchmark measures the port alone",
              file=sys.stderr)
        return 3
    controls = result.pop("_controls", None)
    readings = result.pop("_readings")
    print(f"perfbench: {card_line()}", file=sys.stderr)
    print("perfbench: readings " + json.dumps(readings), file=sys.stderr)
    if controls is not None:
        print("perfbench: controls " + json.dumps(controls), file=sys.stderr)
    print("perfbench: window " + json.dumps(result.pop("_window")), file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
