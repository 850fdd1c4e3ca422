"""BENCHMARK.json against the benchmark's contract, and every file a cell
names present under ``perfbench/``."""

import json
import math
import os
import re

import pytest

from perfbench import harness

ROOT = harness.ROOT
SPEC = os.path.join(ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    assert os.path.getsize(SPEC) <= 64 * 1024
    with open(SPEC) as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16 and all(PATH.match(p) for p in bench["paths"])
    assert all(not p.startswith("/") and ".." not in p.split("/") for p in bench["paths"])
    assert 1 <= len(bench["command"]) <= 32 and all(_line(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51


def test_check_fits_with_24_cells(bench):
    # 2 + 14 x cells runs of run_seconds + 60 s, 2 x 90 s a cell to compile, 1200 s spare
    cells = 24
    total = (2 + 14 * cells) * (bench["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_names_and_units(bench):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in bench[k]]
        assert len(got) == len(set(got)), k
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["name"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_configs(bench):
    assert 1 <= len(bench["configs"]) <= 24
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert _line(c["why"]) and _line(c["source"])
        assert c["file"].startswith("perfbench/") and os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        for k in c["reduced"]:  # no width
            assert not re.search(r"(_dim|_rank|hidden|intermediate|latent|width|size|head)",
                                 k), k
        with open(os.path.join(ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["name"] == c["name"] and set(body["reduced"]) == set(c["reduced"])


def test_workloads(bench):
    cells = bench["workloads"]
    assert 1 <= len(cells) <= 24
    pairs = {(w["config"], w["traffic"]) for w in cells}
    assert len(pairs) == len(cells)
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"]) and NAME.match(w["traffic"])
        assert os.path.isfile(os.path.join(ROOT, "perfbench", "traffic", w["traffic"] + ".json"))
        assert os.path.isfile(os.path.join(ROOT, "perfbench", "limits", w["name"] + ".json"))


def test_end_to_end(bench):
    e2e = bench["end_to_end"]
    assert 1 <= len(e2e) <= 16
    assert "setup_s" in {m["name"] for m in e2e}
    for m in e2e:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}


def test_per_layer(bench):
    layer = bench["per_layer"]
    assert 1 <= len(layer) <= 128
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in layer:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert _line(m["layer"]) and m["moves"] in e2e
        assert os.path.isfile(os.path.join(ROOT, "perfbench", "metrics", m["name"] + ".py"))


def test_every_cell_reports_what_it_must(bench):
    for w in bench["workloads"]:
        e2e, layer = harness.cell_metrics(bench, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert layer
        # a per-layer metric moves an end-to-end metric this cell reports
        assert all(m["moves"] in names for m in layer)


def test_roofline_and_mfu_names(bench):
    for m in bench["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert any("mfu" in m["name"] for m in bench["per_layer"])


def test_limits_files(bench):
    from perfbench import check

    for w in bench["workloads"]:
        with open(os.path.join(ROOT, "perfbench", "limits", w["name"] + ".json")) as f:
            lim = json.load(f)
        assert set(check.REQUIRED) <= set(lim) <= set(check.NUMBERS)
        assert lim["edges"] == 0  # an exact comparison
        assert all(isinstance(v, (int, float)) and v >= 0 and math.isfinite(v)
                   for v in lim.values())

