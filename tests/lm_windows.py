"""Factor-graph windows for the device LM (``fusion/device_graph.py``), built
from either package's host classes: an IMU chain, pose and bias priors,
wheel odometry on every other frame, a genuine marginal and a body-frame
visual hessian, and, on request, GNSS fixes.  JAX-free where the port's
classes are used, so the card tests (which run without JAX) share the
CPU tests' window."""

import importlib
import types

import numpy as np
import torch

NW = 8


class FakeMsba:
    """Duck-typed stand-in for MultiSensorBA carrying just the fields
    pack_graph/pack_state read (``tests/test_device_graph.py``'s)."""

    def __init__(self):
        self.ignore_imu = False
        self.prior_factor_map = {}
        self.marg_factor = None
        self.gnss_init_t1 = -1
        self.ten0 = None
        self.tbg = np.zeros(3)
        self.state = types.SimpleNamespace(preintegrations={}, wTbs={}, vs={}, bs={},
                                           gnss_valid={}, gnss_position={}, odo_valid={},
                                           odo_vel={})


def _pkg(name: str) -> types.SimpleNamespace:
    ns = types.SimpleNamespace()
    for sub in ("fusion.se3np", "fusion.preintegration", "fusion.factors", "fusion.graph",
                "fusion.coupling", "slam.coupled"):
        mod = importlib.import_module(f"{name}.{sub}")
        vars(ns).update({k: v for k, v in vars(mod).items() if not k.startswith("__")})
    return ns


PORT = _pkg("dbaf_tpu_torch")


def build_window(p, seed, n=5, with_marg=True):
    """tests/test_device_graph.py::build_window with package ``p``'s
    classes (the packers check the factor classes of their own package)."""
    rng = np.random.default_rng(seed)
    msba = FakeMsba()
    params = p.ImuParams(accel_noise=0.1, gyro_noise=0.01)
    g = params.g_vec
    st = msba.state
    for i in range(n):
        t = i * 0.1
        st.wTbs[i] = p.Pose(p.so3_exp(np.array([0.05 * t, -0.03 * t, 0.1 * t])),
                            np.array([0.5 * t, 0.2 * np.sin(t), 0.1 * t]))
        st.vs[i] = np.array([0.5, 0.2 * np.cos(t), 0.1])
        st.bs[i] = np.array([0.01, -0.02, 0.015, 0.001, -0.002, 0.0005])
        st.gnss_valid[i] = False
        st.odo_valid[i] = i % 2 == 0
        st.odo_vel[i] = st.wTbs[i].R.T @ st.vs[i] + 0.01 * rng.standard_normal(3)
    for i in range(n - 1):
        pim = p.PreintegratedImu(params, bias=st.bs[i])
        for _ in range(20):
            pim.integrate(st.wTbs[i].R.T @ (-g) + 0.05 * rng.standard_normal(3),
                          np.array([0.05, -0.03, 0.1]) + 0.01 * rng.standard_normal(3), 0.005)
        st.preintegrations[i] = pim
    msba.prior_factor_map[0] = [
        p.PriorPose(p.X(0), st.wTbs[0], p.Noise.sigmas([0.1, 0.1, 1e-3, 1e-3, 1e-3, 1e-3])),
        p.PriorVec(p.B(0), st.bs[0], p.Noise.sigmas([1, 1, 1, .1, .1, .1])),
    ]
    if with_marg:
        gm, vm = p.FactorGraph(), p.Values()
        vm["x99"] = st.wTbs[0].retract(0.01 * rng.standard_normal(6))
        vm[p.X(0)], vm[p.V(0)], vm[p.B(0)] = st.wTbs[0], st.vs[0], st.bs[0]
        gm.add(p.PriorPose("x99", vm["x99"], p.Noise.sigmas([0.1] * 6)))
        pim0 = p.PreintegratedImu(params, bias=st.bs[0])
        for _ in range(10):
            pim0.integrate(-g + 0.05 * rng.standard_normal(3), 0.01 * rng.standard_normal(3),
                           0.005)
        gm.add(p.CombinedImuFactor("x99", p.V(0), p.X(0), p.V(0), p.B(0), p.B(0), pim0))
        gm.add(p.PriorVec(p.V(0), st.vs[0], p.Noise.sigmas([1.0] * 3)))
        msba.marg_factor = p.marginalize_out(gm, vm, ["x99"])
    return msba, rng


def host_values(p, msba, n):
    v = p.Values()
    for i in range(n):
        v[p.X(i)], v[p.V(i)], v[p.B(i)] = msba.state.wTbs[i], msba.state.vs[i], msba.state.bs[i]
    return v


def make_vis(p, rng, msba, n, nw=NW):
    """A body-frame visual hessian over the window, padded to ``nw`` frames."""
    m = n * 6
    A = rng.standard_normal((m, m * 2)) * 0.3
    Hb, vb = p.convert_hessian(A @ A.T, rng.standard_normal(m) * 0.1, p.Pose())
    lcf = p.hessian_factor(list(range(n)), host_values(p, msba, n), Hb, vb)
    Hp = np.zeros((nw * 6, nw * 6), np.float32)
    vp = np.zeros(nw * 6, np.float32)
    Hp[:m, :m], vp[:m] = Hb, vb
    linR = np.tile(np.eye(3, dtype=np.float32), (nw, 1, 1))
    lint = np.zeros((nw, 3), np.float32)
    for i in range(n):
        linR[i], lint[i] = msba.state.wTbs[i].R, msba.state.wTbs[i].t
    return lcf, (Hp, vp, linR, lint)


def _perturb(p, msba, rng, n, first=0):
    for i in range(first, n):
        msba.state.wTbs[i] = msba.state.wTbs[i].retract(0.03 * rng.standard_normal(6))
        msba.state.vs[i] = msba.state.vs[i] + 0.05 * rng.standard_normal(3)
        msba.state.bs[i] = msba.state.bs[i] + 0.002 * rng.standard_normal(6)


def add_gnss(msba, rng, n, tail=(3, 9)):
    """Georeference the window (``test_torch_device_graph_gnss.py``'s ten0
    and lever arm): a fix on every frame but each third, 1-2 cm off the
    lever-armed position, and about a metre off on the ``tail`` frames (the
    Cauchy kernel's tail)."""
    from dbaf_tpu_torch.utils import geodesy

    ten0 = np.array([-2694045.0, -4293642.0, 3857878.0])
    msba.gnss_init_t1, msba.ten0, msba.tbg = 1, ten0, np.array([0.12, -0.05, 0.3])
    Cen = geodesy.Cen(ten0)
    st = msba.state
    for i in range(n):
        st.gnss_valid[i] = i % 3 != 2
        off = rng.standard_normal(3) * (1.0 if i in tail else 0.015)
        w = st.wTbs[i].t + st.wTbs[i].R @ msba.tbg + off
        st.gnss_position[i] = ten0 + Cen @ w


def lm_inputs(nw, n, seed, gnss=False, device="cpu"):
    """The port's ``lm_optimize`` inputs for an ``n``-frame window padded to
    ``nw`` frames (perturbed from the second frame on, so the LM has work),
    on ``device``: (state, graph, vis_H, vis_v, vis_linR, vis_lint,
    sel_pose, marginal)."""
    from dbaf_tpu_torch.fusion import device_graph as tdg

    msba, rng = build_window(PORT, seed, n)
    if gnss:
        add_gnss(msba, rng, n)
    _, vis = make_vis(PORT, rng, msba, n, nw)
    _perturb(PORT, msba, rng, n, first=1)
    mgd = tdg.marg_to_device(tdg.marg_dense_np(msba.marg_factor, 0, n, nw), device)
    return (tdg.pack_state(msba, 0, n, nw, device=device),
            tdg.pack_graph(msba, 0, n, nw, device=device),
            *(torch.as_tensor(a, device=device) for a in vis),
            tdg.make_sel_pose(nw, device), mgd)
