"""The port's edge-sharded BA on two gloo ranks against the JAX package
(``tests/test_parallel.py:24-115``): the same numpy windows through the
port's ``make_sharded_ba_iteration`` and ``sharded_ba_step`` (each rank
holding half of the edges) and through JAX's ``make_sharded_ba_iteration``
on conftest's 8-device CPU mesh and JAX's ``dba.ba``.

* ``make_problem``'s window (P = 6, 8 x 16 depth grid, |i-j| in 1..2)
  perturbed by 0.02, its edges padded with masked ones to a multiple of 8:
  one iteration held at the JAX test's atol 2e-5 (poses) / 2e-4
  (disparities), ``sharded_ba_step`` (two iterations) against JAX's
  ``dba.ba`` with two at the same bounds.
* The scaled case (``:62``): window 24, the 132 edges |i-j| in 1..3
  padded to 136, two iterations against JAX's two sharded iterations and
  JAX's ``dba.ba`` at that test's 5e-5 / 5e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dbaf_tpu.ops import dba as jdba, lie as jlie, projective as jpj
from dbaf_tpu.parallel import make_mesh as jmake_mesh
from dbaf_tpu.parallel.shard_ba import make_sharded_ba_iteration as jmake_iteration
from tests import torch_ranks as ranks
from tests.test_dba import make_problem


def _pad(x, n, fill=0):
    x = np.asarray(x)
    pad = np.full((n - x.shape[0],) + x.shape[1:], fill, x.dtype)
    return np.concatenate([x, pad])


def _window(rng, P, dense):
    poses_gt, disps_gt, intr, ii, jj, targets, weights = make_problem(rng, P=P, ht=8, wd=16)
    if dense:
        ai, aj = np.meshgrid(np.arange(P), np.arange(P), indexing="ij")
        keep = (np.abs(ai - aj) >= 1) & (np.abs(ai - aj) <= 3)
        ii, jj = jnp.asarray(ai[keep]), jnp.asarray(aj[keep])
        targets, _ = jpj.projective_transform(poses_gt, disps_gt, intr, ii, jj)
        weights = jnp.ones(targets.shape, jnp.float32)
    xi = jnp.asarray(rng.normal(size=(P, 6)) * 0.02, jnp.float32)
    E = ii.shape[0]
    E_pad = (E + 7) // 8 * 8
    ht, wd = disps_gt.shape[-2:]
    return dict(poses=np.asarray(jlie.se3_retr(poses_gt, xi)), disps=np.asarray(disps_gt),
                intr=np.asarray(intr), eta=np.full((P, ht * wd), 1e-4, np.float32),
                targets=_pad(targets, E_pad), weights=_pad(weights, E_pad),
                ii=_pad(ii, E_pad).astype(np.int64), jj=_pad(jj, E_pad).astype(np.int64),
                mask=_pad(np.ones(E, bool), E_pad, False))


def _jax_runs(w, iters):
    P = w["poses"].shape[0]
    j = {k: jnp.asarray(v) for k, v in w.items()}
    args = (j["intr"], j["targets"], j["weights"], j["eta"], j["ii"].astype(jnp.int32),
            j["jj"].astype(jnp.int32), j["mask"], jnp.asarray(1), jnp.asarray(P))
    step = jmake_iteration(jmake_mesh(8), P)
    p, d = j["poses"], j["disps"]
    for _ in range(iters):
        p, d = step(p, d, *args)
    ref = jdba.ba(j["poses"], j["disps"], *args, iterations=iters)
    ref2 = jdba.ba(j["poses"], j["disps"], *args, iterations=2)
    return dict(poses=np.asarray(p), disps=np.asarray(d), ba_poses=np.asarray(ref.poses),
                ba_disps=np.asarray(ref.disps), ba2_poses=np.asarray(ref2.poses),
                ba2_disps=np.asarray(ref2.disps))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from dbaf_tpu_torch.parallel import launch

    assert jax.device_count() >= 8, jax.devices()
    rng = np.random.default_rng(0)
    cases = [(_window(rng, 6, dense=False), 1), (_window(rng, 24, dense=True), 2)]
    assert cases[1][0]["ii"].shape[0] == 136
    started = launch.start(ranks.sharded_ba_cases, 2, (cases,),
                           workdir=str(tmp_path_factory.mktemp("shard_ba")), timeout=300)
    try:
        jax_out = [_jax_runs(w, iters) for w, iters in cases]
    finally:
        port = started.wait()
    return port, jax_out


@pytest.mark.parametrize("case, atol_p, atol_d", [(0, 2e-5, 2e-4), (1, 5e-5, 5e-4)],
                         ids=["window6", "scaled"])
def test_sharded_ba_matches_jax(runs, case, atol_p, atol_d):
    port, jax_out = runs
    j = jax_out[case]
    for rank_out in port:
        r = rank_out[case]
        for key in ("poses", "ba_poses"):
            np.testing.assert_allclose(r["poses"], j[key], atol=atol_p, err_msg=key)
        for key in ("disps", "ba_disps"):
            np.testing.assert_allclose(r["disps"], j[key], atol=atol_d, err_msg=key)
        np.testing.assert_allclose(r["step_poses"], j["ba2_poses"], atol=atol_p)
        np.testing.assert_allclose(r["step_disps"], j["ba2_disps"], atol=atol_d)
    np.testing.assert_array_equal(port[0][case]["poses"], port[1][case]["poses"])
    np.testing.assert_array_equal(port[0][case]["disps"], port[1][case]["disps"])
