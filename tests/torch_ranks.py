"""The port's scenarios that the multi-process tests run on each rank.

A spawned rank imports the module of the function it runs, so these live
here, apart from the test files, and import neither JAX nor the JAX
package.  Each function builds its inputs from the numpy arrays it is
given and returns numpy arrays.
"""

import numpy as np
import torch


def corr_sensitive(base_fn):
    """tests/test_shard_video.py's wrapper: the update depends on the
    correlation values, so the feature gathers steer the trajectory."""

    def fn(net, inp, corr, motn, ii, jj, aux):
        net2, delta, weight = base_fn(net, inp, corr, motn, ii, jj, aux)
        bump = 0.05 * torch.tanh(torch.mean(corr.float(), dim=-1, keepdim=True))
        return net2, delta + bump, weight

    return fn


def _feature_bytes(video) -> int:
    return sum(getattr(video, n).numel() * getattr(video, n).element_size()
               for n in ("fmaps", "nets", "inps"))


def visual_scenario(cfg, gt_poses, gt_disps, intr, feats, n):
    """tests/test_shard_video.py::_run_visual on the port: keyframes with
    per-frame pseudorandom features fed straight into the video, the
    corr-sensitive oracle in the rounds.  Returns the poses and disparities
    of the keyframes, the feature buffers' bytes on this rank, and every
    slot's features."""
    from dbaf_tpu_torch.eval.synthetic import make_oracle
    from dbaf_tpu_torch.slam.frontend import Frontend
    from dbaf_tpu_torch.slam.graph import CovisibleGraph
    from dbaf_tpu_torch.slam.video import DepthVideo

    video = DepthVideo(cfg, torch.device("cpu"))
    id_map = np.zeros(cfg.buffer, dtype=np.int64)
    graph = CovisibleGraph(video, corr_sensitive(make_oracle(gt_poses, gt_disps, intr)), cfg)
    frontend = Frontend(video, graph, cfg)
    intr8 = torch.as_tensor(intr)
    feats = torch.as_tensor(feats).to(torch.bfloat16)
    for k in range(n):
        idx = video.counter
        f = feats[k % feats.shape[0]]
        video.append(float(k), None, None, None, intr8, f, f, f)
        id_map[idx] = k
        graph.aux = {"id_map": torch.as_tensor(id_map)}
        frontend()
        id_map[:video.counter] = np.round(video.tstamp[:video.counter]).astype(np.int64)
        graph.aux = {"id_map": torch.as_tensor(id_map)}
    t1 = frontend.t1
    return dict(poses=video.poses[:t1].numpy().copy(), disps=video.disps[:t1].numpy().copy(),
                feature_bytes=_feature_bytes(video), t1=t1, rounds=frontend.update_rounds,
                fmaps=video.full_buffer("fmaps").float().numpy())


def coupled_scenario(cfg, gt_cw, gt_disps, intr, imu_rows, fps, n):
    """tests/test_shard_video.py's coupled scenario on the port (the device
    solver and the fused coupled step; tests/test_torch_coupled.py's
    harness).  Returns the body positions and disparities of the keyframes
    and the fused-step count."""
    from dbaf_tpu_torch.eval.synthetic import make_oracle
    from dbaf_tpu_torch.fusion.se3np import Pose
    from dbaf_tpu_torch.slam.coupled import MultiSensorBA
    from dbaf_tpu_torch.slam.frontend import Frontend
    from dbaf_tpu_torch.slam.graph import CovisibleGraph
    from dbaf_tpu_torch.slam.video import DepthVideo

    video = DepthVideo(cfg, torch.device("cpu"))
    id_map = np.zeros(cfg.buffer, dtype=np.int64)
    graph = CovisibleGraph(video, make_oracle(gt_cw, gt_disps, intr), cfg)
    coupled = MultiSensorBA(video, cfg)
    coupled.Tbc = Pose()
    coupled.state.set_imu_params([0.05, 0.005, 1e-4, 1e-6])
    graph.coupled = coupled
    frontend = Frontend(video, graph, cfg)
    frontend.set_multisensor(imu_rows, visual_only=False)
    intr8 = torch.as_tensor(intr)
    zeros = torch.zeros((video.h8, video.w8, 128), dtype=torch.bfloat16)
    for k in range(n):
        idx = video.counter
        video.append(k / fps, None, None, None, intr8, zeros, zeros, zeros)
        id_map[idx] = k
        graph.aux = {"id_map": torch.as_tensor(id_map)}
        frontend()
        id_map[:video.counter] = np.round(video.tstamp[:video.counter] * fps).astype(np.int64)
    t1 = frontend.t1
    return dict(pos=np.asarray([graph.coupled.state.wTbs[k].t for k in range(t1)]),
                disps=video.disps[:t1].numpy().copy(), imu=video.imu_enabled,
                megas=graph.mega_count, feature_bytes=_feature_bytes(video))


def indivisible_buffer(cfg):
    """The ValueError of a buffer that does not divide the rank count."""
    from dbaf_tpu_torch.slam.video import DepthVideo

    try:
        DepthVideo(cfg, torch.device("cpu"))
    except ValueError as e:
        return str(e)
    return None


def row_moves(cfg, feats):
    """Every row move of the video on the feature buffers, from slots
    filled with ``feats``: a cull (``rm_keyframe``), a rollup, the
    asynchronous steps' device moves (a cull's two rows, where on and where
    off) and their rollup by a device shift.  Returns every slot of each
    feature buffer after each move."""
    from dbaf_tpu_torch.slam.video import DepthVideo

    video = DepthVideo(cfg, torch.device("cpu"))
    feats = torch.as_tensor(feats).to(torch.bfloat16)
    B = cfg.buffer
    for k in range(B):
        video.write_feature("fmaps", k, feats[k % feats.shape[0]])
        video.write_feature("nets", k, feats[(k + 1) % feats.shape[0]])
        video.write_feature("inps", k, feats[(k + 2) % feats.shape[0]])
        if video.fmaps_right is not None:
            video.write_feature("fmaps_right", k, feats[(k + 3) % feats.shape[0]])
    video.counter = B
    names = [n for n in ("fmaps", "nets", "inps", "fmaps_right") if getattr(video, n) is not None]
    out = []

    def snap():
        out.append({n: video.full_buffer(n).float().numpy() for n in names})

    video.rm_keyframe(B // 2 - 1)  # a row that crosses from rank 1 to rank 0
    snap()
    video.rollup(3)
    snap()
    ar = torch.arange(2)
    for on in (True, False):
        video.move_rows_device(torch.tensor(B // 2 - 2) + ar, torch.tensor(B // 2 - 1) + ar,
                               torch.tensor(on))
        snap()
    video.rollup_device(torch.tensor(5))
    snap()
    slot = torch.tensor(B - 1)
    video.write_feature("nets", slot, feats[0], on=torch.tensor(True))
    video.write_feature("inps", slot, feats[0], on=torch.tensor(False))
    snap()
    return out


def first_rank_reads(cfg):
    """Host reads while a sharded video lives, of tensors that differ by
    rank: ``to_host`` (an array and a 0-d flag) and a ``PendingRead`` give
    rank 0's values on every rank; once a video without the flag is made,
    each rank reads its own again."""
    import dataclasses

    import torch.distributed as dist

    from dbaf_tpu_torch.slam.video import DepthVideo
    from dbaf_tpu_torch.utils.device import PendingRead, to_host

    r = dist.get_rank()
    x = torch.tensor([r, 10 + r], dtype=torch.float32)
    sharded = DepthVideo(cfg, torch.device("cpu"))
    out = dict(sharded=sharded.kf_group is not None, array=to_host(x),
               flag=to_host(torch.tensor(r == 0)),
               pending=PendingRead(torch.tensor([r, -r])).read())
    DepthVideo(dataclasses.replace(cfg, shard_video=False), torch.device("cpu"))
    out["own"] = to_host(x)
    return out


def visual_scenarios(visual_args, odd_cfg, moves_args):
    """The visual scenario, the indivisible buffer, the row moves and the
    host reads in turn on one rank."""
    return dict(visual=visual_scenario(*visual_args), odd=indivisible_buffer(odd_cfg),
                moves=row_moves(*moves_args), reads=first_rank_reads(visual_args[0]))


def sharded_ba(window, iters):
    """This rank's edges of ``window`` (numpy arrays, the edge count
    divisible by the ranks) through ``iters`` sharded iterations
    (``make_sharded_ba_iteration``) and through ``sharded_ba_step``."""
    from dbaf_tpu_torch.parallel import dist, make_mesh, make_sharded_ba_iteration
    from dbaf_tpu_torch.parallel import sharded_ba_step

    mesh = make_mesh()
    sl = dist.process_edge_slice(window["ii"].shape[0])
    tg, wg, iig, jjg, mg = dist.global_edge_arrays(
        mesh, "edge", *(window[k][sl] for k in ("targets", "weights", "ii", "jj", "mask")),
        device="cpu")
    pg, dg, ig, eg = dist.replicated(
        mesh, *(window[k] for k in ("poses", "disps", "intr", "eta")), device="cpu")
    P = pg.shape[0]
    step = make_sharded_ba_iteration(mesh, P)
    p, d = pg, dg
    for _ in range(iters):
        p, d = step(p, d, ig, tg, wg, eg, iig, jjg, mg, 1, P)
    st = sharded_ba_step(mesh)(pg, dg, ig, tg, wg, eg, iig, jjg, mg, 1, P)
    return dict(poses=p.numpy(), disps=d.numpy(), step_poses=st.poses.numpy(),
                step_disps=st.disps.numpy())


def sharded_ba_cases(cases):
    """:func:`sharded_ba` on each (window, iters) in turn."""
    return [sharded_ba(w, iters) for w, iters in cases]


def sharded_train_step(state, batch, dp, edge, num_steps, lr, total):
    """One make_train_step on a (dp, edge) mesh of the f32 network with
    ``state``'s weights, over this rank's share of ``batch`` (shard_batch).
    Returns the metrics, the updated parameters and their gradients."""
    from dbaf_tpu_torch.models.net import DroidNet
    from dbaf_tpu_torch.parallel import make_mesh_2d
    from dbaf_tpu_torch.train.trainer import make_optimizer, make_train_step, shard_batch

    model = DroidNet(dtype=torch.float32, device="cpu")
    model.load_state_dict(state)
    mesh = make_mesh_2d(dp, edge)
    opt = make_optimizer(model.parameters(), lr=lr, total_steps=total)
    metrics = make_train_step(model, opt, num_steps=num_steps, mesh=mesh)(
        shard_batch(batch, mesh, device="cpu"))
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                params={k: p.detach().numpy().copy() for k, p in model.named_parameters()},
                grads={k: p.grad.numpy().copy() for k, p in model.named_parameters()
                       if p.grad is not None})


def mesh_layout(E):
    """The meshes of this rank's job: shapes, axis names, this rank's
    coordinates, and its edge slice of a length-E axis."""
    from dbaf_tpu_torch.parallel import dist, make_mesh_2d

    hyb = dist.hybrid_mesh(ici_shape=(1, 2), dcn_shape=(2, 1), axis_names=("host", "edge"))
    m2 = make_mesh_2d(2, 2)
    flat = dist.global_edge_mesh()
    sl = dist.process_edge_slice(E)
    try:
        dist.process_edge_slice(E + 2)
        odd = None
    except ValueError as e:
        odd = str(e)
    return dict(hybrid=(tuple(hyb.shape), tuple(hyb.mesh_dim_names)),
                mesh2d=(tuple(m2.shape), tuple(m2.mesh_dim_names),
                        (m2.get_local_rank("dp"), m2.get_local_rank("edge"))),
                flat=(tuple(flat.shape), tuple(flat.mesh_dim_names)),
                slice=(sl.start, sl.stop), odd=odd)


def sharded_features(state, images):
    """``sharded_feature_step`` of the f32 network with ``state``'s weights:
    this rank extracts its share of ``images`` (N / ranks frames, in rank
    order); returns every frame's (fmaps, net, inp)."""
    from dbaf_tpu_torch.models.net import DroidNet
    from dbaf_tpu_torch.parallel import dist, make_mesh, sharded_feature_step

    model = DroidNet(dtype=torch.float32, device="cpu")
    model.load_state_dict(state)
    mesh = make_mesh()
    sl = dist.process_edge_slice(images.shape[0])
    out = sharded_feature_step(mesh, model)(torch.as_tensor(images[sl]))
    return [x.numpy() for x in out]
