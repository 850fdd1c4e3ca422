"""The port's mesh-sharded training step on four gloo ranks, a (dp 2,
edge 2) mesh, against the JAX package's ``make_train_step`` on a (dp 2,
edge 4) mesh of conftest's 8 CPU devices (``tests/test_train.py:105-165``).

The problem is that test's: B = 2 tuples of ``_tiny_problem`` (4 frames,
6 x 8 features) with 8 edges each (its +-1 edges and, as JAX's clamped
gather ``ii[arange(8)]`` gives them, the last edge twice more), num_steps
1, lr 1e-4 over a 100-step schedule.  The weights are the JAX package's
f32 initialization carried over with ``from_jax_params``, the delta head
scaled by 0.01 and the sample drawn with seed 1, as in
``test_torch_train_step.py`` (``test_torch_train_unroll.py`` says why).
Each rank holds one tuple and 4 of its 8 edges; GraphAgg's per-frame
mean, the BA layer and the losses' means reduce over the edge pair, the
gradients over all four ranks.

Held at that test's bounds: the loss (rtol 1e-4) and every updated
parameter (1e-4), on every rank; the parameters moved.  The ranks also
agree with each other bit for bit.  AdamW's first step moves a parameter
by about lr whatever its gradient, so the summed gradient is also held to
the port's single-process B = 2 step, at ``test_torch_train_unroll.py``'s
bound: each leaf within 1e-3 of its largest entry plus 1e-6 of the largest
entry of all leaves.
"""

import jax
import jax.numpy as jnp
import numpy as np

from tests import torch_ranks as ranks
from tests.test_torch_train_unroll import jax_params, port_model, tiny_sample

LR, TOTAL = 1e-4, 100


def _batch():
    rng = np.random.default_rng(1)
    samples = []
    for _ in range(2):
        s = tiny_sample(rng)
        keep = np.arange(8)  # 8 edges, divisible by the edge axis
        s["ii"] = np.take(s["ii"], keep, mode="clip")
        s["jj"] = np.take(s["jj"], keep, mode="clip")
        samples.append(s)
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def _single_step_grads(params, batch):
    import torch

    from dbaf_tpu_torch.train.trainer import make_optimizer, make_train_step

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tm = port_model(params)
        opt = make_optimizer(tm.parameters(), lr=LR, total_steps=TOTAL)
        make_train_step(tm, opt, num_steps=1)({k: torch.as_tensor(v) for k, v in batch.items()})
    finally:
        torch.set_num_threads(n)
    return {k: p.grad.numpy() for k, p in tm.named_parameters() if p.grad is not None}


def test_train_step_sharded_matches_jax_mesh_step(tmp_path):
    from dbaf_tpu.parallel import make_mesh_2d as jmake_mesh_2d
    from dbaf_tpu.train.trainer import make_optimizer as j_make_optimizer
    from dbaf_tpu.train.trainer import make_train_step as j_make_train_step
    from dbaf_tpu.train.trainer import shard_batch as j_shard_batch
    from dbaf_tpu_torch.models.convert import from_jax_params
    from dbaf_tpu_torch.parallel import launch

    assert jax.device_count() >= 8, jax.devices()
    batch = _batch()
    jm, params = jax_params(delta_scale=0.01)
    state = port_model(params).state_dict()
    started = launch.start(ranks.sharded_train_step, 4, (state, batch, 2, 2, 1, LR, TOTAL),
                           workdir=str(tmp_path), timeout=600)
    try:
        tx = j_make_optimizer(lr=LR, total_steps=TOTAL)
        mesh = jmake_mesh_2d(2, 4)
        jstep = j_make_train_step(jm, tx, num_steps=1, mesh=mesh)
        jb = j_shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
        jp, _, jmet = jstep(params, tx.init(params), jb)
        jp = from_jax_params(jax.tree.map(np.asarray, jp))
        jloss = float(jmet["loss"])
        single = _single_step_grads(params, batch)
    finally:
        out = started.wait()

    assert np.isfinite(jloss)
    before = {k: v.numpy() for k, v in state.items()}
    for r in out:
        np.testing.assert_allclose(r["metrics"]["loss"], jloss, rtol=1e-4)
        worst = max(float(np.max(np.abs(p - jp[k].numpy()))) for k, p in r["params"].items())
        assert worst < 1e-4, worst
        moved = max(float(np.max(np.abs(p - before[k]))) for k, p in r["params"].items())
        assert moved > 0.0
        assert r["grads"].keys() == single.keys()
        gmax = max(float(np.max(np.abs(g))) for g in single.values())
        for k, g in single.items():
            err = float(np.max(np.abs(r["grads"][k] - g)))
            assert err <= 1e-3 * float(np.max(np.abs(g))) + 1e-6 * gmax, (k, err)
    for r in out[1:]:
        assert r["metrics"] == out[0]["metrics"]
        for k, p in r["params"].items():
            np.testing.assert_array_equal(p, out[0]["params"][k], err_msg=k)
