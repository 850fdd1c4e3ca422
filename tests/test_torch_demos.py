"""The port's dataset demos (``apps/demo_{tumvi,kitti360,whu,subt}.py``)
against the JAX package's on the same on-disk sensor files, and the batch
apps' commands.

Each case writes ``chip_smoke.py`` phase 11's sensor files (``DemoScene``
and ``write_demo_files``: the dataset's layout and units) with a few PNG
frames into ``tmp_path``, then runs the JAX ``main`` and the port's ``main``
on the same argv with both packages' ``DBAFusion`` and ``runner.run``
replaced by recording stubs (both demos import them inside ``main``).
Held equal: the configuration as a dict, every argument of
``set_multisensor`` (arrays exactly, WHU's GNSS rows and seeded noisy
odometry among them), ``init_pose_sigma`` and ``init_bias_sigma``, the
runner's paths, and the stream's first ``(t, image, intrinsics)`` bit for
bit.  The port's demo builds its system on the card unless the caller asks
for the CPU: the stub sees ``device=None`` from ``main(argv)``.
"""

import dataclasses
import importlib
import os
import sys
import types

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CASES = {
    "tumvi": ("tumvi", []),
    "tumvi_h5_visual_only": ("tumvi", ["--enable_h5", "--visual_only", "--max_frames", "5"]),
    "kitti360": ("kitti360", []),
    "whu": ("whu", []),
    "whu_no_gnss": ("whu", "drop:--use_gnss"),
    "subt": ("subt", []),
    "subt_no_tbc": ("subt", "drop:--Tbc"),
}


def _imread_size(kind):
    return {"tumvi": (512, 512), "kitti360": (376, 1408), "whu": (480, 752),
            "subt": (540, 720)}[kind]


def write_case(tmp_path, kind, extra):
    """Phase 11's sensor files for a 6-frame scene, a few PNG frames where
    the demo's stream reads them, and the argv."""
    import chip_smoke as cs
    from dbaf_tpu_torch.utils import config

    scene = cs.DemoScene(kind, 6, getattr(config, f"{kind}_config")().image_size)
    root = str(tmp_path / kind)
    argv = cs.write_demo_files(kind, scene, root, str(tmp_path / "droid.pth"),
                               str(tmp_path / "result.txt"), str(tmp_path / "recon.pkl"))
    if isinstance(extra, str):  # drop a flag (and its value, for --Tbc)
        flag = extra.split(":")[1]
        i = argv.index(flag)
        argv = argv[:i] + argv[i + (2 if flag == "--Tbc" else 1):]
        extra = []
    h, w = _imread_size(kind)
    rng = np.random.default_rng(0)
    base = cv2.GaussianBlur(rng.integers(0, 255, (h + 16, w + 16, 3)).astype(np.uint8),
                            (5, 5), 1.0)
    arg = dict(zip(argv[::1], argv[1::1]))
    if kind == "tumvi":
        imdir = os.path.join(arg["--datadir"], "mav0", "cam0", "data")
        names = [line.split(",")[1].strip() for line in
                 open(os.path.join(arg["--datadir"], "mav0", "cam0", "data.csv"))
                 if not line.startswith("#")][:9]
    elif kind == "whu":
        imdir = arg["--imagedir"]
        names = [line.split(",")[1].strip() for line in open(arg["--imagestamp"])][:5]
    elif kind == "kitti360":
        imdir, names = arg["--imagedir"], [f"{k:010d}.png" for k in range(5)]
    else:
        imdir, names = arg["--imagedir"], [f"{int(k * 1e8)}.png" for k in range(9)]
    for k, name in enumerate(names):
        cv2.imwrite(os.path.join(imdir, name), base[k:k + h, k:k + w])
    if "--enable_h5" in extra:
        from dbaf_tpu_torch.data.hdf5 import convert_stream

        h5 = str(tmp_path / "frames.h5")
        convert_stream([(0.5, base[:40, :48].astype(np.float32),
                         np.asarray([10.0, 10.0, 24.0, 20.0], np.float32))], h5)
        extra = extra + ["--h5path", h5]
    return argv + extra


class _Stub:
    """DBAFusion's recording stand-in."""

    def __init__(self, cfg, *args, **kw):
        self.cfg, self.kw, self.ms = cfg, kw, None
        self.graph = types.SimpleNamespace(coupled=types.SimpleNamespace())
        type(self).made.append(self)

    def set_multisensor(self, *args, **kw):
        self.ms = (args, kw)


def _jax_setup_off(monkeypatch):
    """dbaf_tpu.apps.runner without its import-time persistent-cache setup."""
    import dbaf_tpu.utils.jax_setup as js

    monkeypatch.setattr(js, "setup", lambda *a, **k: None)
    import dbaf_tpu.apps.runner as jr

    importlib.reload(jr)


def run_main(pkg, kind, argv, monkeypatch):
    """``pkg.apps.demo_<kind>.main(argv)`` with stubs; returns (stub, run args, first item)."""
    if pkg == "dbaf_tpu":
        _jax_setup_off(monkeypatch)
    system_mod = importlib.import_module(f"{pkg}.slam.system")
    runner = importlib.import_module(f"{pkg}.apps.runner")
    stub = type("Stub", (_Stub,), {"made": []})
    monkeypatch.setattr(system_mod, "DBAFusion", stub)
    rec = {}

    def run(system, stream, *args):
        rec["args"] = args
        rec["first"] = next(iter(stream))
        rec["system"] = system

    monkeypatch.setattr(runner, "run", run)
    importlib.import_module(f"{pkg}.apps.demo_{kind}").main(argv)
    assert len(stub.made) == 1 and rec["system"] is stub.made[0]
    return stub.made[0], rec


def assert_same(a, b, path="value"):
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for k, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{k}]")
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (path, a.keys(), b.keys())
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


@pytest.mark.parametrize("case", list(CASES))
def test_demo_setup_matches_jax(tmp_path, monkeypatch, case):
    kind, extra = CASES[case]
    argv = write_case(tmp_path, kind, extra)
    j, jr = run_main("dbaf_tpu", kind, argv, monkeypatch)
    p, pr = run_main("dbaf_tpu_torch", kind, argv, monkeypatch)

    assert_same(dataclasses.asdict(p.cfg), dataclasses.asdict(j.cfg), "cfg")
    assert p.cfg.image_size == getattr(importlib.import_module("dbaf_tpu_torch.utils.config"),
                                       f"{kind}_config")().image_size
    assert p.kw == {"device": None}  # the card, unless the caller asks for the CPU
    assert_same(p.ms, j.ms, "set_multisensor")
    for name in ("init_pose_sigma", "init_bias_sigma"):
        assert_same(getattr(p.graph.coupled, name, None), getattr(j.graph.coupled, name, None),
                    name)
    assert_same(pr["args"], jr["args"], "runner.run")
    assert_same(list(pr["first"]), list(jr["first"]), "the stream's first item")
    if kind == "whu" and extra == []:
        gnss, odo = p.ms[1]["all_gnss"], p.ms[1]["all_odo"]
        assert gnss.shape[1] >= 17 and odo.shape[0] >= 1
        np.testing.assert_array_equal(p.ms[1]["ten0"], gnss[0, 1:4])
        assert np.all(np.abs(odo[:, 0] - np.round(odo[:, 0])) < 1e-3)  # whole seconds


@pytest.mark.parametrize("kind", ["tumvi", "kitti360", "whu", "subt"])
def test_selftest_flag(tmp_path, monkeypatch, kind, capsys):
    """--selftest runs the weights self-test on the port's runner and builds
    no system, as the JAX demo does."""
    from dbaf_tpu_torch.apps import runner
    from dbaf_tpu_torch.slam import system as psys

    argv = write_case(tmp_path, kind, []) + ["--selftest"]
    seen = []
    monkeypatch.setattr(runner, "weights_selftest", lambda w: seen.append(w))
    monkeypatch.setattr(psys, "DBAFusion", lambda *a, **k: pytest.fail("built a system"))
    importlib.import_module(f"dbaf_tpu_torch.apps.demo_{kind}").main(argv)
    assert seen == [str(tmp_path / "droid.pth")]


def test_selftest_on_a_reference_checkpoint(tmp_path, capsys):
    import json

    import chip_smoke as cs
    from dbaf_tpu_torch.apps import demo_subt

    weights = cs.write_demo_weights(str(tmp_path / "w" / "droid.pth"))
    demo_subt.main(["--imagedir", ".", "--calib", "c.txt", "--imupath", "i.csv",
                    "--weights", weights, "--selftest"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out == {"selftest": "ok", "weights": weights, "fmap_shape": [1, 8, 10, 128],
                   "delta_ch": 2}


BATCH_ARGV = {
    "tumvi": ["--dataroot", "D", "--weights", "w.pth", "--calib", "c.txt", "--seqs", "room1",
              "room2"],
    "kitti360": ["--dataroot", "D", "--weights", "w.pth", "--calib", "c.txt", "--drives",
                 "0000", "0002", "--save_pkl"],
    "whu": ["--imagedir", "I", "--imagestamp", "S", "--calib", "c.txt", "--weights", "w.pth",
            "--imupath", "imu.csv", "--odopath", "odo.txt"],
    "whu_gnss": ["--imagedir", "I", "--imagestamp", "S", "--calib", "c.txt", "--weights",
                 "w.pth", "--imupath", "imu.csv", "--gnsspath", "g.txt", "--odopath", "odo.txt"],
    "subt": ["--dataroot", "D", "--weights", "w.pth", "--calib", "c.txt", "--save_pkl"],
}


@pytest.mark.parametrize("case", list(BATCH_ARGV))
def test_batch_commands_match_jax(tmp_path, monkeypatch, case, capsys):
    """The batch apps spawn the same demo commands in both packages, bar
    the package name, with the same modes and skip rules."""
    kind = case.split("_")[0]
    argv = BATCH_ARGV[case] + ["--outdir", str(tmp_path / "out")]
    cmds = {}
    for pkg in ("dbaf_tpu", "dbaf_tpu_torch"):
        mod = importlib.import_module(f"{pkg}.apps.batch_{kind}")
        seen = []
        monkeypatch.setattr(mod.subprocess, "run", lambda cmd, check=False: seen.append(cmd))
        mod.main(argv)
        cmds[pkg] = seen
    assert len(cmds["dbaf_tpu"]) > 0
    ported = [[a.replace("dbaf_tpu_torch.apps.", "dbaf_tpu.apps.") for a in c]
              for c in cmds["dbaf_tpu_torch"]]
    assert ported == cmds["dbaf_tpu"]
    assert all(c[2].startswith("dbaf_tpu_torch.apps.demo_") for c in cmds["dbaf_tpu_torch"])
    if kind == "whu":  # no GNSS file: that mode is skipped
        assert len(cmds["dbaf_tpu"]) == (3 if case == "whu_gnss" else 2)
