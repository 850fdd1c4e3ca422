"""The port's process layer (``dbaf_tpu_torch/parallel/dist.py``) and its
worker CLI, after ``tests/test_multihost.py``.

* ``initialize()`` without torchrun's environment is a no-op returning 1
  that creates no process group (``:92``); a mesh in one process is a
  group of one rank.
* Mesh shapes and axis names in a 4-rank gloo job on the CPU (``:104``;
  a torch mesh spans ranks, so the JAX test's (2 hosts x 4 devices) is
  (2 x 2) here), and each rank's ``process_edge_slice``.
* ``sharded_feature_step`` on two ranks, each extracting two of four
  frames (the f32 network, 48 x 64): bit-equal to one process extracting
  the same two-frame batches (the ``fmaps`` of the JAX package's multichip
  dry run).
* ``python -m dbaf_tpu_torch.parallel.dist_worker`` in two processes
  (gloo, a ``file://`` rendezvous under ``tmp_path``) against the port's
  single-process ``ba`` run iteration by iteration on the same seeded
  window, at the JAX test's rtol 1e-5 / atol 1e-6 (``:58-61``), with the
  timing mode's ms an iteration (``:84``).  The JAX test holds two
  processes against one process of the same sharded program; here the
  other side is another summation order, and this window's GN step
  amplifies f32 rounding (the port's own f32 ``ba`` lies 6.1e-4 from its
  f64 result after one iteration and 5.3e-2 after two), so the worker
  runs in f64 (``--dtype float64``), where that order costs ~1e-11.
"""

import os
import subprocess
import sys

import numpy as np
import torch

from tests import torch_ranks as ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")


def test_single_process_initialize_noop():
    import torch.distributed as tdist

    from dbaf_tpu_torch.parallel import dist, make_mesh

    for var in TORCHRUN_ENV:
        assert var not in os.environ, f"leaked {var}"
    assert dist.initialize() == 1
    assert not tdist.is_initialized()
    assert dist.world_size() == 1 and dist.process_edge_slice(8) == slice(0, 8)
    try:
        mesh = make_mesh(device="cpu")
        assert tuple(mesh.shape) == (1,) and mesh.mesh_dim_names == ("edge",)
        assert dist.initialize() == 1  # idempotent once a group exists
    finally:
        tdist.destroy_process_group()
    for var in TORCHRUN_ENV:
        assert var not in os.environ, f"leaked {var}"


def test_mesh_shapes_and_edge_slices(tmp_path):
    from dbaf_tpu_torch.parallel import launch

    out = launch.run(ranks.mesh_layout, 4, (8,), workdir=str(tmp_path), timeout=300)
    for r, lay in enumerate(out):
        assert lay["hybrid"] == ((2, 2), ("host", "edge"))
        assert lay["mesh2d"] == ((2, 2), ("dp", "edge"), (r // 2, r % 2))
        assert lay["flat"] == ((4,), ("edge",))
        assert lay["slice"] == (2 * r, 2 * r + 2)
        assert "must divide" in lay["odd"]


def test_sharded_feature_step(tmp_path):
    from dbaf_tpu_torch.models.net import DroidNet
    from dbaf_tpu_torch.parallel import launch

    model = DroidNet(dtype=torch.float32, device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    state = model.state_dict()
    images = np.random.default_rng(0).integers(0, 255, size=(4, 48, 64, 3)).astype(np.float32)
    out = launch.run(ranks.sharded_features, 2, (state, images), workdir=str(tmp_path),
                     timeout=300)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.no_grad():
            parts = [model.extract_features(torch.as_tensor(images[k:k + 2])) for k in (0, 2)]
    finally:
        torch.set_num_threads(n)
    for r in out:
        for got, a, b in zip(r, *parts):
            assert got.shape == (4,) + tuple(a.shape[1:])
            np.testing.assert_array_equal(got, torch.cat([a, b]).numpy())


def _worker(cmd_args, out, env):
    return subprocess.Popen(
        [sys.executable, "-m", "dbaf_tpu_torch.parallel.dist_worker", "--device", "cpu",
         "--dtype", "float64", "--out", out, *cmd_args],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def test_two_process_worker_matches_single_ba(tmp_path):
    from dbaf_tpu_torch.ops import dba
    from dbaf_tpu_torch.parallel.dist_worker import seeded_window

    env = dict(os.environ, OMP_NUM_THREADS="1")
    store = f"file://{tmp_path}/store"
    procs = [_worker(("--process-id", str(r), "--num-processes", "2", "--coordinator", store,
                      "--time", "1"), str(tmp_path / f"p{r}.npz"), env) for r in range(2)]
    try:
        rc = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, code in zip(procs, rc):
        assert code == 0, p.stderr.read().decode()[-3000:]
    two = np.load(tmp_path / "p0.npz")
    assert not (tmp_path / "p1.npz").exists()  # process 0 writes
    assert float(two["iter_ms"]) > 0.0

    # the single-process solve: dba.ba one iteration at a time, each
    # clamped as the sharded iteration clamps
    w = {k: torch.as_tensor(v.astype(np.float64) if v.dtype == np.float32 else v)
         for k, v in seeded_window(16, 128).items()}
    p, d = w["poses"], w["disps"]
    for _ in range(2):
        p, d = dba.ba(p, d, w["intr"], w["targets"], w["weights"], w["eta"], w["ii"], w["jj"],
                      w["mask"], 1, 16, iterations=1)
    np.testing.assert_allclose(two["poses"], p.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(two["disps"], d.numpy(), rtol=1e-5, atol=1e-6)
