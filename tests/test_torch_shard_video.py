"""Keyframe-sharded feature buffers (``cfg.shard_video``) on two gloo ranks
against the port's single-process run (``tests/test_shard_video.py:66-100``).

The visual scenario of the JAX test: the frontend with per-frame
pseudorandom features and a correlation-sensitive oracle (14 keyframes;
the coupled one is in ``test_torch_shard_video_coupled.py``).  Two ranks
spawned on the CPU run it with ``shard_video``, each holding 8 of the 16
slots of ``fmaps``/``nets``/``inps``, and every read of those rows goes
through the gather: held bit for bit (poses, disparities, every slot's
features) to one process without the flag, on one torch thread in both.
The single-process run is held to the JAX package by the ``test_torch_*``
files of this path.  A buffer of 15 slots does not divide two ranks: the
reference's ``ValueError``.  The scenario neither culls nor rolls up, so
every row move of the video (``rm_keyframe``, ``rollup``, the asynchronous
steps' ``move_rows_device`` and ``rollup_device``, and the conditional
write of the visual pipeline's admission) is also run on filled buffers
with stereo on, each held bit for bit to one process.  While the sharded
video lives, each rank's counted host reads give rank 0's values.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests import torch_ranks as ranks
from tests.test_slam_e2e import H8, W8, make_cfg, make_scene
from tests.test_torch_stereo import port_cfg

INTR = np.asarray([16.0, 16.0, W8 / 2, H8 / 2], np.float32)
N_VISUAL = 14


def _visual_args(shard):
    gt_poses, gt_disps = make_scene(N_VISUAL, INTR)
    cfg = port_cfg(make_cfg())
    cfg.shard_video = shard
    feats = np.random.default_rng(7).standard_normal((40, H8, W8, 128)).astype(np.float32)
    return (cfg, np.asarray(gt_poses), np.asarray(gt_disps), INTR, feats, N_VISUAL)


def _moves_args(shard):
    cfg = port_cfg(make_cfg())
    cfg.shard_video, cfg.stereo = shard, True
    cfg.frontend.rollup_start, cfg.frontend.rollup_shift = 10, 4
    feats = np.random.default_rng(3).standard_normal((cfg.buffer, H8, W8, 128))
    return (cfg, feats.astype(np.float32))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from dbaf_tpu_torch.parallel import launch

    visual = _visual_args(True)
    odd = dataclasses.replace(visual[0], buffer=15)
    sharded = launch.run(ranks.visual_scenarios, 2, (visual, odd, _moves_args(True)),
                         workdir=str(tmp_path_factory.mktemp("shard_video")), timeout=300)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = dict(visual=ranks.visual_scenario(*_visual_args(False)),
                      moves=ranks.row_moves(*_moves_args(False)))
    finally:
        torch.set_num_threads(n)
    return single, sharded


def test_shard_video_visual_equivalence(runs):
    single, sharded = runs
    s = single["visual"]
    assert s["t1"] >= 8 and s["rounds"] > 0
    for r in sharded:
        v = r["visual"]
        assert v["t1"] == s["t1"] and v["rounds"] == s["rounds"]
        np.testing.assert_array_equal(v["poses"], s["poses"])
        np.testing.assert_array_equal(v["disps"], s["disps"])
        np.testing.assert_array_equal(v["fmaps"], s["fmaps"])
        assert 2 * v["feature_bytes"] == s["feature_bytes"]


def test_shard_video_buffer_must_divide_the_ranks(runs):
    _, sharded = runs
    for r in sharded:
        assert r["odd"] is not None and "divisible" in r["odd"], r["odd"]


def test_shard_video_row_moves(runs):
    single, sharded = runs
    for r in sharded:
        assert len(r["moves"]) == len(single["moves"])
        for got, want in zip(r["moves"], single["moves"]):
            for name in want:
                np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_shard_video_ranks_read_the_first_ranks_values(runs):
    """While a sharded video lives, a counted host read returns rank 0's
    value on every rank (the ranks' host decisions are rank 0's), and a
    video without the flag ends that."""
    _, sharded = runs
    for rank, r in enumerate(sharded):
        got = r["reads"]
        assert got["sharded"]
        np.testing.assert_array_equal(got["array"], [0.0, 10.0])
        assert got["flag"] is True
        np.testing.assert_array_equal(got["pending"], [0, 0])
        np.testing.assert_array_equal(got["own"], [rank, 10.0 + rank])
