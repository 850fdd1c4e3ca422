"""Whole runs of each cell at a small size on the CPU (the kernels' plain
versions): the result line, the timed path broken underneath and
``correct`` coming out false, and a cell, a traffic mix and a metric added
as new files alone.

At the small size the CPU's correlation reads ``k1_round`` near 0.008-0.01,
above the card's limit (the card reads 0.0026-0.0029 at the cells' size;
PERF.md): the unbroken runs hold every other number to its limit."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench import harness
from perfbench.tests import tiny

KEYS = {"correct", "attempted", "failed", "metrics", "device", "compared"}


def _limits(cell):
    return harness.load_json(harness.HERE, "limits", cell + ".json")


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_small_run_prints_the_result_line(cell):
    # ten seconds: the trajectory numbers need three window frames or more
    out = subprocess.run([sys.executable, "-m", "perfbench.tests.tiny", "--workload", cell,
                          "--seconds", "10"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(line) == KEYS and list(line)[-1] == "compared"
    e2e, _ = harness.cell_metrics(harness.load_json(harness.ROOT, "BENCHMARK.json"), cell)
    assert set(line["metrics"]) == {m["name"] for m in e2e}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert line["attempted"] > 0 and line["failed"] == 0
    lim = _limits(cell)
    for name, c in line["compared"].items():
        if name != "k1_round":
            assert c["value"] <= c["limit"], (name, c)
    assert set(lim) <= set(line["compared"])


# each planted fault (perfbench/faults.py), a cell and a number it has to
# fail there at this size.  tumvi-vio.handheld does not compare ``solve``
# (PERF.md), and in a window of a few frames at this size the IMU carries
# its unchanged state within ``traj_m``'s limit: that fault is held on the
# card, at the cell's own size (below).
BROKEN = [("whu-ms.drive", "state_unchanged", "solve")] + [
    (cell, fault, number) for cell in tiny.CELLS
    for fault, number in (("half_batch", "update"), ("answer_altered", "fnet"),
                          ("wrong_edges", "edges"))]


@pytest.mark.parametrize("cell,fault,number", BROKEN)
def test_broken_path_is_not_correct(cell, fault, number):
    res = tiny.run_small(cell, fault=fault)
    assert res["correct"] is False
    c = res["compared"][number]
    assert c["value"] > c["limit"], (number, c)


def test_new_cell_traffic_and_metric_are_new_files_only(tmp_path):
    """A configuration, a traffic mix, a metric and a cell's limits added as
    files of their own, and entries in BENCHMARK.json: no file the harness
    has is edited, and the new cell runs with the new metric."""
    src = os.path.join(harness.ROOT, "perfbench")
    dst = tmp_path / "perfbench"
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: (dst / p).read_bytes() for p in _files(dst)}
    cfg = json.loads((dst / "configs" / "tumvi-vio.json").read_text())
    cfg["name"] = "tumvi-vio-x"
    (dst / "configs" / "tumvi-vio-x.json").write_text(json.dumps(cfg))
    traffic = json.loads((dst / "traffic" / "handheld.json").read_text())
    traffic["name"] = "hover"
    traffic["motion"]["pos_amp"] = [0.05, 0.05, 0.5]
    (dst / "traffic" / "hover.json").write_text(json.dumps(traffic))
    (dst / "metrics" / "frames_seen.py").write_text(
        '"""frames_seen: frames in the window."""\n\n\ndef read(run):\n'
        '    return float(run.window["frames"])\n')
    (dst / "limits" / "tumvi-vio-x.hover.json").write_text(
        (dst / "limits" / "tumvi-vio.handheld.json").read_text())
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    bench["configs"].append(dict(bench["configs"][0], name="tumvi-vio-x",
                                 file="perfbench/configs/tumvi-vio-x.json"))
    bench["workloads"].append(dict(name="tumvi-vio-x.hover", config="tumvi-vio-x",
                                   traffic="hover", chips=1, why="a throwaway cell"))
    bench["end_to_end"].append(dict(name="frames_seen", unit="frames", better="higher",
                                    bound=0.25, source="host_clock",
                                    workloads=["tumvi-vio-x.hover"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    assert all((dst / p).read_bytes() == b for p, b in before.items())
    cell = "tumvi-vio-x.hover"
    tiny.SMALL[cell] = tiny.SMALL["tumvi-vio.handheld"]
    try:
        res = tiny.run_small(cell, seconds=2.0, root=str(dst))
    finally:
        del tiny.SMALL[cell]
    assert res["metrics"]["frames_seen"]["value"] == res["attempted"] > 0
    assert {"frames_per_s", "setup_s"} <= set(res["metrics"])


def _files(root):
    for d, _, files in os.walk(root):
        for f in files:
            yield os.path.relpath(os.path.join(d, f), root)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", tiny.CELLS)
def test_controls_fail_on_the_card(cell, card):
    """The controls at the cell's own size and load, a short window: the
    program with its int8 correlation (``k1_round``), the reference one
    precision lower in the program's place (the network's numbers)."""
    import time

    res = harness.run_cell(cell, tiny.SEED + 31, 8.0, False, time.perf_counter(), control=True)
    lim = _limits(cell)
    controls = dict(res["_controls"], k1_round=res["_readings"]["k1_round"])
    for name in ("fnet", "cnet", "k2_gate", "k1_round", "update"):
        assert controls[name] > lim[name], (name, controls[name], lim[name])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", tiny.CELLS)
def test_unchanged_state_fails_on_the_card(cell, card):
    """The coupled round returning its state unchanged, at the cell's own
    size, a 25 s window: ``traj_m`` (and ``solve`` where compared) fail."""
    import time

    res = harness.run_cell(cell, tiny.SEED + 37, 25.0, False, time.perf_counter(),
                           fault="state_unchanged")
    assert res["correct"] is False
    c = res["compared"]["traj_m"]
    assert c["value"] > c["limit"], c
