"""One training step of the port (``train/trainer.make_train_step``: the
unrolled forward over a batch of B = 2 tuples, the losses, one backward
pass, the global-norm clip and one AdamW step) against the JAX package's
unsharded step (``tests/test_train.py:104-169`` without the mesh), and the
objective-decrease scenario of ``tests/test_train.py:172-217`` on the port
alone.

The weights are the JAX package's f32 initialization with the delta head
scaled by 0.01 (``test_torch_train_unroll.py`` says why), the samples
``tests/test_train.py``'s tiny problem, ``num_steps`` 1, lr 1e-4 over a
100-step schedule.  Held: the loss (rtol 1e-5) and every updated
parameter within 1e-5.  AdamW's first step moves each parameter by lr
times the sign of its gradient (the moments are that one gradient), so an
entry whose gradient lies within the two packages' f32 difference of zero
can move either way: such entries (a sign that differs) are held to
2 lr + 1e-5 and to under 0.5% of all entries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_train_unroll import jax_params, port_model, tiny_sample, to_torch

LR, TOTAL = 1e-4, 100


def _batch(rng, B):
    samples = [tiny_sample(rng) for _ in range(B)]
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def test_train_step_matches_jax_unsharded_step():
    from dbaf_tpu.train.trainer import make_optimizer as j_make_optimizer
    from dbaf_tpu.train.trainer import make_train_step as j_make_train_step
    from dbaf_tpu_torch.models.convert import from_jax_params
    from dbaf_tpu_torch.train.trainer import make_optimizer, make_train_step

    rng = np.random.default_rng(1)
    batch = _batch(rng, 2)
    jm, params = jax_params(delta_scale=0.01)

    tx = j_make_optimizer(lr=LR, total_steps=TOTAL)
    jstep = j_make_train_step(jm, tx, num_steps=1)
    jp, _, jmet = jstep(params, tx.init(params), {k: jnp.asarray(v) for k, v in batch.items()})
    jp = from_jax_params(jax.tree.map(np.asarray, jp))

    tm = port_model(params)
    before = {k: p.detach().clone() for k, p in tm.named_parameters()}
    opt = make_optimizer(tm.parameters(), lr=LR, total_steps=TOTAL)
    tmet = make_train_step(tm, opt, num_steps=1)(to_torch(batch))

    assert np.isfinite(float(jmet["loss"]))
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5)
    for k in ("geodesic", "residual", "flow"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-4, err_msg=k)

    flipped = total = moved = 0
    for k, p in tm.named_parameters():
        t, j, b = p.detach().numpy(), jp[k].numpy(), before[k].numpy()
        err = np.abs(t - j)
        sign_differs = np.sign(t - b) != np.sign(j - b)
        assert np.all(err[~sign_differs] <= 1e-5), (k, float(err[~sign_differs].max()))
        assert np.all(err[sign_differs] <= 2 * LR + 1e-5), k
        flipped += int(sign_differs.sum())
        total += t.size
        moved += int((t != b).sum())
    assert flipped < 0.005 * total, (flipped, total)
    assert moved > total // 2, (moved, total)


def test_training_objective_decreases():
    """tests/test_train.py:172-217 on the port: 8 AdamW steps (lr 2e-3 over
    a 400-step schedule) on one fixed tuple cut the loss by more than 15%."""
    from dbaf_tpu_torch.train.trainer import make_optimizer, make_train_step

    rng = np.random.default_rng(0)
    batch = {k: v[None] for k, v in to_torch(tiny_sample(rng)).items()}
    _, params = jax_params()
    tm = port_model(params)
    step = make_train_step(tm, make_optimizer(tm.parameters(), lr=2e-3, total_steps=400),
                           num_steps=1)
    hist = [float(step(batch)["loss"]) for _ in range(8)]
    assert all(np.isfinite(hist)), hist
    assert min(hist[4:]) < 0.85 * hist[0], hist
