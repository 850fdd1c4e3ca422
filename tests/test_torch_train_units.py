"""Units of the port's training path against the JAX package on the same
numpy inputs: the losses, both BA steps and their gradients, the learning
rate schedule and one AdamW + clip update against optax, the data helpers
with equal numpy generators, the TartanAir reader on a two-scene layout,
and ``tests/test_train.py:94`` (the loss is zero at the truth).

Tolerances: f32 on both sides.  Losses and metrics rtol 1e-5; BA outputs
atol 1e-5 and their gradients within 1e-4 of each gradient's largest entry
(two Cholesky solves in f32, summed in another order); the schedule rtol
1e-6 (optax evaluates it in f32); the optimizer's parameters rtol 1e-6
(the same f32 formulas, one or two ulps apart); the data helpers exact, the frame distances rtol
1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dbaf_tpu.train import ba_layer as jba
from dbaf_tpu.train import data as jdata
from dbaf_tpu.train import losses as jlosses
from dbaf_tpu.train import trainer as jtrainer
from dbaf_tpu_torch.ops import lie
from dbaf_tpu_torch.train import ba_layer, data, losses, trainer
from tests.test_torch_coupled import one_torch_thread  # noqa: F401  (autouse)
from tests.test_train import _tiny_problem

T = torch.as_tensor


def _np(x):
    return np.asarray(x)


def _problem(seed=0, n=4, h8=6, w8=8):
    rng = np.random.default_rng(seed)
    poses, disps, intr, ii, jj = (_np(a) for a in _tiny_problem(rng, n, h8, w8))
    return rng, poses, disps, intr, ii, jj


def _estimates(rng, poses, disps, k=3):
    """Perturbed pose and disparity iterates around the truth."""
    out_p, out_d = [], []
    for _ in range(k):
        xi = (0.02 * rng.normal(size=(len(poses), 6))).astype(np.float32)
        out_p.append(lie.se3_retr(T(poses), T(xi)).numpy())
        out_d.append((disps * (1 + 0.05 * rng.normal(size=disps.shape))).astype(np.float32))
    return out_p, out_d


def test_losses_match_jax():
    rng, poses, disps, intr, ii, jj = _problem()
    Gs, Ds = _estimates(rng, poses, disps)
    res = [rng.normal(size=(len(ii), 6, 8, 2)).astype(np.float32) for _ in range(3)]

    np.testing.assert_allclose(float(losses.fit_scale(T(poses), T(Gs[0]))),
                               float(jlosses.fit_scale(jnp.asarray(poses), jnp.asarray(Gs[0]))),
                               rtol=1e-5)
    for do_scale in (True, False):
        t, tm = losses.geodesic_loss(T(poses), [T(g) for g in Gs], T(ii), T(jj),
                                     do_scale=do_scale)
        j, jm = jlosses.geodesic_loss(jnp.asarray(poses), [jnp.asarray(g) for g in Gs],
                                      jnp.asarray(ii), jnp.asarray(jj), do_scale=do_scale)
        np.testing.assert_allclose(float(t), float(j), rtol=1e-5)
        assert set(tm) == set(jm)
        for k in tm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    t, _ = losses.residual_loss([T(r) for r in res])
    j, _ = jlosses.residual_loss([jnp.asarray(r) for r in res])
    np.testing.assert_allclose(float(t), float(j), rtol=1e-5)
    t, tm = losses.flow_loss(T(poses), T(disps), [T(g) for g in Gs], [T(d) for d in Ds],
                             T(intr))
    j, jm = jlosses.flow_loss(jnp.asarray(poses), jnp.asarray(disps),
                              [jnp.asarray(g) for g in Gs], [jnp.asarray(d) for d in Ds],
                              jnp.asarray(intr))
    np.testing.assert_allclose(float(t), float(j), rtol=1e-5)
    for k in ("f_error", "1px"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)


def test_loss_zero_at_truth():
    """tests/test_train.py:94 on the port."""
    _, poses, disps, intr, ii, jj = _problem()
    lg, _ = losses.geodesic_loss(T(poses), [T(poses)], T(ii), T(jj))
    assert float(lg) < 1e-4
    lf, _ = losses.flow_loss(T(poses), T(disps), [T(poses)], [T(disps)], T(intr))
    assert float(lf) < 1e-3


def _ba_inputs(seed=0):
    """A tiny BA problem: targets are the true reprojections plus noise,
    the state starts near the truth."""
    from dbaf_tpu_torch.ops import projective as pj

    rng, poses, disps, intr, ii, jj = _problem(seed)
    target, _ = pj.projective_transform(T(poses), T(disps), T(intr), T(ii), T(jj))
    target = (target.numpy() + 0.05 * rng.normal(size=target.shape)).astype(np.float32)
    weight = rng.uniform(0.5, 1.0, size=target.shape).astype(np.float32)
    eta = rng.uniform(0.01, 0.1, size=(len(poses), 48)).astype(np.float32)
    Gs, Ds = _estimates(rng, poses, disps, 1)
    r_p = rng.normal(size=poses.shape).astype(np.float32)
    r_d = rng.normal(size=disps.shape).astype(np.float32)
    return dict(target=target, weight=weight, eta=eta, poses=Gs[0], disps=Ds[0],
                intrinsics=intr, ii=ii, jj=jj), r_p, r_d


ARGS = ("target", "weight", "eta", "poses", "disps", "intrinsics", "ii", "jj")
WRT = ("target", "weight", "eta", "poses", "disps")


@pytest.mark.parametrize("motion_only", [False, True])
def test_ba_steps_and_their_gradients_match_jax(motion_only):
    inp, r_p, r_d = _ba_inputs()

    def j_obj(*wrt):
        kw = {k: jnp.asarray(v) for k, v in inp.items()}
        kw.update(zip(WRT, wrt))
        args = [kw[k] for k in ARGS]
        if motion_only:
            p = jba.motion_only_ba_step(*args, fixedp=1)
            return jnp.sum(p * r_p), (p, None)
        p, d = jba.ba_step(*args, fixedp=2)
        return jnp.sum(p * r_p) + jnp.sum(d * r_d), (p, d)

    (_, (jp, jd)), jg = jax.jit(jax.value_and_grad(
        j_obj, argnums=tuple(range(len(WRT))), has_aux=True))(*(jnp.asarray(inp[k]) for k in WRT))

    kw = {k: T(v) for k, v in inp.items()}
    for k in WRT:
        kw[k] = kw[k].clone().requires_grad_(True)
    args = [kw[k] for k in ARGS]
    if motion_only:
        p, d = ba_layer.motion_only_ba_step(*args, fixedp=1), None
        obj = torch.sum(p * T(r_p))
    else:
        p, d = ba_layer.ba_step(*args, fixedp=2)
        obj = torch.sum(p * T(r_p)) + torch.sum(d * T(r_d))
    obj.backward()

    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), atol=1e-5)
    if d is not None:
        np.testing.assert_allclose(d.detach().numpy(), np.asarray(jd), atol=1e-5)
        assert float(d.min()) >= 0.0
    for name, g in zip(WRT, jg):
        g = np.asarray(g)
        t = kw[name].grad
        t = np.zeros_like(g) if t is None else t.numpy()
        assert np.all(np.isfinite(t)), name
        np.testing.assert_allclose(t, g, atol=1e-4 * float(np.abs(g).max()) + 1e-9,
                                   err_msg=name)
        assert motion_only and name in ("eta", "disps") or np.abs(g).max() > 0, name


@pytest.mark.parametrize("total", [1, 2, 3, 4, 10, 100, 400, 250_000])
def test_schedule_matches_optax(total):
    """The learning rate of each step against the JAX package's schedule
    (optax.linear_onecycle_schedule, constant below 3 steps)."""
    lr = 2.5e-4
    if total < 3:
        ref = lambda k: lr  # noqa: E731
    else:
        ps = max(0.01, 1.0 / total)
        pf = min(max(0.7, ps + 1.0 / total), 1.0 - 1.0 / total)
        ref = optax.linear_onecycle_schedule(transition_steps=total, peak_value=lr,
                                             pct_start=ps, pct_final=pf,
                                             div_factor=25.0, final_div_factor=1e4)
    steps = sorted({0, 1, 2, 3, total // 3, total // 2, int(0.7 * total), total - 1, total,
                    total + 5})
    for k in steps:
        want = float(ref(jnp.asarray(k, jnp.int32)))
        np.testing.assert_allclose(trainer.onecycle_lr(k, lr, total), want, rtol=1e-6,
                                   atol=1e-12, err_msg=str(k))
    # the LambdaLR walks the same values, one per optimizer step
    opt = trainer.make_optimizer([torch.zeros(1, requires_grad=True)], lr=lr, total_steps=total)
    for k in range(min(total + 2, 6)):
        np.testing.assert_allclose(opt.adamw.param_groups[0]["lr"],
                                   trainer.onecycle_lr(k, lr, total), rtol=1e-12)
        opt.adamw.step()  # no gradients: only the schedule moves
        opt.schedule.step()


@pytest.mark.parametrize("clip", [2.5, 1e3])
def test_adamw_and_clip_match_optax(clip):
    """Three updates of the port's optimizer against optax's chain on the
    same gradients (clipped, and under the threshold)."""
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 2).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    tx = jtrainer.make_optimizer(lr=1e-2, total_steps=10, clip=clip)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = trainer.make_optimizer(list(tp.values()), lr=1e-2, total_steps=10, clip=clip)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.tensor(g[k])
        norm = opt.step()
        np.testing.assert_allclose(float(norm), float(optax.global_norm(
            {k: jnp.asarray(v) for k, v in g.items()})), rtol=1e-6)
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=k)


def _scene(seed=0, n=12, h=48, w=64):
    """A camera moving along a line over a fronto-parallel wall."""
    rng = np.random.default_rng(seed)
    poses = np.zeros((n, 7), np.float32)
    poses[:, 6] = 1.0
    poses[:, 0] = -0.15 * np.arange(n)
    poses[:, 1] = 0.02 * rng.normal(size=n)
    disps = (0.5 + 0.05 * rng.random((n, h, w))).astype(np.float32)
    intr = np.asarray([40.0, 40.0, w / 2, h / 2], np.float32)
    return poses, disps, intr


def test_frame_graph_and_tuple_sampling_match_jax():
    poses, disps, intr = _scene()
    tg = data.build_frame_graph(poses, disps, intr, device="cpu")
    jg = jdata.build_frame_graph(poses, disps, intr)
    assert set(tg) == set(jg)
    for i in tg:
        assert [j for j, _ in tg[i]] == [j for j, _ in jg[i]], i
        np.testing.assert_allclose([d for _, d in tg[i]], [d for _, d in jg[i]], rtol=1e-5)
    assert sum(len(v) for v in tg.values()) > 0
    for seed in range(5):
        a = data.sample_covisible_tuple(jg, 4, np.random.default_rng(seed), fmin=1.0, fmax=40.0)
        b = jdata.sample_covisible_tuple(jg, 4, np.random.default_rng(seed), fmin=1.0,
                                         fmax=40.0)
        assert a == b
    assert data.sample_covisible_tuple({0: [], 1: []}, 3, np.random.default_rng(0)) is None


def test_augment_image_matches_jax():
    img = np.random.default_rng(1).integers(0, 255, size=(48, 64, 3)).astype(np.uint8)
    for seed in range(6):
        a = data.augment_image(img, np.random.default_rng(seed))
        b = jdata.augment_image(img, np.random.default_rng(seed))
        np.testing.assert_array_equal(a, b)


def _write_tartan(root, n_scenes=2, n=10, h=48, w=64):
    import cv2

    for s in range(n_scenes):
        scene = root / f"env{s}" / "Easy" / "P000"
        (scene / "image_left").mkdir(parents=True)
        (scene / "depth_left").mkdir()
        rng = np.random.default_rng(s)
        rows = []
        for k in range(n):
            img = rng.integers(0, 255, size=(h, w, 3)).astype(np.uint8)
            cv2.imwrite(str(scene / "image_left" / f"{k:06d}_left.png"), img)
            np.save(scene / "depth_left" / f"{k:06d}_left_depth.npy",
                    (2.0 + 0.1 * rng.random((h, w))).astype(np.float32))
            # NED position and an xyzw quaternion (a small yaw)
            a = 0.01 * k
            rows.append([0.1 * k, 0.01 * k, 0.0, 0.0, 0.0, np.sin(a / 2), np.cos(a / 2)])
        np.savetxt(scene / "pose_left.txt", np.asarray(rows))


def test_tartanair_dataset_matches_jax(tmp_path, monkeypatch):
    _write_tartan(tmp_path)
    # a small camera for the 48 x 64 test images (the class keeps TartanAir's)
    intr = np.asarray([32.0, 32.0, 32.0, 24.0], np.float32)
    monkeypatch.setattr(data.TartanAirDataset, "INTRINSICS", intr)
    monkeypatch.setattr(jdata.TartanAirDataset, "INTRINSICS", intr)
    td = data.TartanAirDataset(str(tmp_path), n_frames=3, seed=0, device="cpu")
    jd = jdata.TartanAirDataset(str(tmp_path), n_frames=3, seed=0)
    assert td.scenes == jd.scenes and len(td.scenes) == 2
    got = 0
    for _ in range(4):
        a, b = td.sample(), jd.sample()
        assert (a is None) == (b is None)
        if a is None:
            continue
        got += 1
        np.testing.assert_array_equal(a["images"], b["images"])
        np.testing.assert_array_equal(a["disps"], b["disps"])
        np.testing.assert_allclose(a["poses"], b["poses"], atol=1e-6)
        np.testing.assert_array_equal(a["intrinsics"], b["intrinsics"])
    assert got > 0
    np.testing.assert_allclose(
        data.TartanAirDataset.load_pose_file(td.scenes[0] + "/pose_left.txt"),
        jdata.TartanAirDataset.load_pose_file(td.scenes[0] + "/pose_left.txt"), atol=1e-6)
