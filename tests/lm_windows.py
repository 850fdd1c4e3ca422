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


def build_window(p, seed, n=5, with_marg=True, origin=None):
    """tests/test_device_graph.py::build_window with package ``p``'s
    classes (the packers check the factor classes of their own package);
    ``origin`` shifts every position by that vector."""
    rng = np.random.default_rng(seed)
    msba = FakeMsba()
    params = p.ImuParams(accel_noise=0.1, gyro_noise=0.01)
    g = params.g_vec
    st = msba.state
    for i in range(n):
        t = i * 0.1
        st.wTbs[i] = p.Pose(p.so3_exp(np.array([0.05 * t, -0.03 * t, 0.1 * t])),
                            np.array([0.5 * t, 0.2 * np.sin(t), 0.1 * t]))
        if origin is not None:
            st.wTbs[i] = p.Pose(st.wTbs[i].R, st.wTbs[i].t + np.asarray(origin))
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


def lm_inputs(nw, n, seed, gnss=False, device="cpu", origin=None):
    """The port's ``lm_optimize`` inputs for an ``n``-frame window padded to
    ``nw`` frames (perturbed from the second frame on, so the LM has work),
    on ``device``: (state, graph, vis_H, vis_v, vis_linR, vis_lint,
    marginal)."""
    from dbaf_tpu_torch.fusion import device_graph as tdg

    msba, rng = build_window(PORT, seed, n, origin=origin)
    if gnss:
        add_gnss(msba, rng, n)
    _, vis = make_vis(PORT, rng, msba, n, nw)
    _perturb(PORT, msba, rng, n, first=1)
    mgd = tdg.marg_to_device(tdg.marg_dense_np(msba.marg_factor, 0, n, nw), device)
    return (tdg.pack_state(msba, 0, n, nw, device=device),
            tdg.pack_graph(msba, 0, n, nw, device=device),
            *(torch.as_tensor(a, device=device) for a in vis), mgd)


CELL_ORIGIN = (25.0, -12.0, 3.0)  # metres: the cells' windows lie tens of metres out
EPS32 = 2.0 ** -24
ROUNDINGS = 8  # f32 roundings along the longest chain behind a term of b or err


def settled_inputs(nw, n, seed, gnss=False, device="cpu"):
    """:func:`lm_inputs`' window in the regime of the cells' later LM
    iterations: positions tens of metres from the origin, and the state
    moved to the window's optimum by an f64 LM pass on the CPU, while the
    marginal and the visual system stay linearized where they were.  So
    each term's gradient is large and they cancel to a small b, a
    marginal's v against its H @ dvec as much as the IMU chain against the
    rest, with IMU information up to about 1e11."""
    from dbaf_tpu_torch.fusion import device_graph as tdg
    from dbaf_tpu_torch.utils.device import FlagPoll

    args = lm_inputs(nw, n, seed, gnss, origin=CELL_ORIGIN)
    st, (_, its) = tdg.lm_optimize(*_f64(args), poll=FlagPoll(blocking=True))
    st = tdg.FgState(*(x.float() for x in st[:4]), st.valid)
    return tuple(x.to(device) if isinstance(x, torch.Tensor) else
                 None if x is None else type(x)(*(y.to(device) for y in x))
                 for x in (st, *args[1:]))


def cut_masks(pg, m):
    """``marginalize_window_body``'s masks: the factors on frames < m."""
    arW = torch.arange(pg.imu_mask.shape[0] + 1, device=pg.imu_mask.device)
    return pg._replace(imu_mask=pg.imu_mask & (arW[:-1] < m),
                       pp_mask=pg.pp_mask & (pg.pp_frame < m),
                       pb_mask=pg.pb_mask & (pg.pb_frame < m),
                       gnss_mask=pg.gnss_mask & (arW < m), odo_mask=pg.odo_mask & (arW < m))


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.double() if x.is_floating_point() else x
    if x is None:
        return None
    ys = [_f64(y) for y in x]
    return type(x)(*ys) if hasattr(x, "_fields") else type(x)(ys)


def rounding_scale(state, pg, vis_H, vis_v, vis_linR, vis_lint, mgd=None):
    """For ``linearize``'s arguments, the size of the terms behind each
    entry of its b and behind its err, in f64: (m_b (N,), m_err).  An f32
    evaluation of the same formulas rounds each entry of b by a small
    multiple of eps32 m_b[i], and err by one of eps32 m_err.

    A factor's rhs -J^T L r is rounded in its product and in its residual
r.  A difference of two inputs rounds once, relative to itself, but r
also subtracts computed quantities: an IMU factor's position residual
is R_i^T dp_w - dp, each a rounded product of about a metre that cancel
to millimetres, and L reaches 1e10.  So r carries an f32 error of about
eps32 s, with s the magnitude of the computed operands it subtracts,
and the row's term is |J|^T |L| (|r| + s).  The marginal's and the
visual system's rows take |v| + |H| (|dvec| + s) likewise, dvec being
a local displacement from the linearization points.  err takes
|L r| (|r| + s) of each factor and the two signed sums of each
quadratic prior.  A rotation's residual is a logarithm of rounded
rotation products, off by about eps32 in radians: its s is 1."""
    from dbaf_tpu_torch.fusion import device_graph as tdg

    st, pg, vis_H, vis_v, vis_linR, vis_lint, mgd = _f64(
        (state, pg, vis_H, vis_v, vis_linR, vis_lint, mgd))
    NW = st.R.shape[0]
    N = 15 * NW
    dev = st.t.device
    ar = lambda n: torch.arange(n, device=dev)  # noqa: E731
    A = torch.abs
    mv = lambda M, v: (M @ v[..., None])[..., 0]  # noqa: E731
    mb = torch.zeros(N, dtype=torch.float64, device=dev)
    me = torch.zeros((), dtype=torch.float64, device=dev)

    def add(rows, J, L, r, s, m):
        """rows of b and err for factors (J: (K, d, n), L: (K, d, d)); m masks."""
        m = m.double()
        mb.index_put_((rows,), m[:, None] * mv(A(J).transpose(-1, -2) @ A(L), A(r) + s),
                      accumulate=True)
        return torch.sum(m * torch.sum(mv(A(L), A(r)) * (A(r) + s), -1))

    def pose_scale(Ra, ta, tb):
        """s of Log(Ta^-1 Tb): 1 for the rotation, |Ra^T| |tb - ta| for the translation."""
        return torch.cat([torch.ones_like(ta), mv(A(Ra).transpose(-1, -2), A(tb - ta))], -1)

    # IMU chain
    r, J = tdg._imu_residual_jac(st, pg)
    Ri, ti, vi, bi = st.R[:-1], st.t[:-1], st.vel[:-1], st.bias[:-1]
    tj, vj, bj = st.t[1:], st.vel[1:], st.bias[1:]
    dt = pg.imu_dt[:, None]
    db = A(bi - pg.imu_bias0)
    g = A(pg.g_vec)
    RiT = A(Ri).transpose(-1, -2)
    s_v = mv(RiT, A(vj - vi) + g * dt) + A(pg.imu_dv) + mv(A(pg.imu_dva), db[:, :3]) \
        + mv(A(pg.imu_dvg), db[:, 3:])
    s_p = mv(RiT, A(tj - ti) + A(vi) * dt + 0.5 * g * dt * dt) + A(pg.imu_dp) \
        + mv(A(pg.imu_dpa), db[:, :3]) + mv(A(pg.imu_dpg), db[:, 3:])
    s = torch.cat([torch.ones_like(s_v), s_v, s_p, torch.zeros_like(bi)], -1)
    me = me + add((15 * ar(NW - 1))[:, None] + ar(30), J, pg.imu_info, r, s, pg.imu_mask)

    # pose priors
    f = pg.pp_frame
    r = tdg._se3_local(pg.pp_R, pg.pp_t, st.R[f], st.t[f])
    me = me + add((15 * f)[:, None] + ar(6), tdg._prior_pose_jac(r), pg.pp_info, r,
                  pose_scale(pg.pp_R, pg.pp_t, st.t[f]), pg.pp_mask)

    # bias priors (J = I; r is a difference of inputs)
    f = pg.pb_frame
    eye6 = torch.eye(6, dtype=torch.float64, device=dev).expand(f.shape[0], 6, 6)
    me = me + add((15 * f + 9)[:, None] + ar(6), eye6, pg.pb_info, st.bias[f] - pg.pb_prior,
                  0.0, pg.pb_mask)

    # GNSS (J = R over the position rows, the Cauchy weight only shrinks L; r is a
    # difference of inputs)
    me = me + add((15 * ar(NW) + 3)[:, None] + ar(3), st.R, pg.gnss_info.expand(NW, 3, 3),
                  st.t - pg.gnss_pos, 0.0, pg.gnss_mask)

    # odometry: r = R^T vel - odo_vel, J = [hat(vb) | R^T]
    RT = st.R.transpose(-1, -2)
    vb = mv(RT, st.vel)
    Jo = torch.cat([tdg._hat(vb), RT], -1)
    o_rows = torch.cat([(15 * ar(NW))[:, None] + ar(3), (15 * ar(NW) + 6)[:, None] + ar(3)], 1)
    me = me + add(o_rows, Jo, pg.odo_info.expand(NW, 3, 3), vb - pg.odo_vel,
                  mv(A(RT), A(st.vel)) + A(pg.odo_vel), pg.odo_mask)

    def quadratic(H, v, d, s):
        """0.5 d.H d - v.d: b's rows |v| + |H| (|d| + s); err's |d| (|H||d| + |v|) + |Hd - v| s."""
        Hd = mv(H, d)
        return (A(v) + mv(A(H), A(d) + s),
                A(d) @ (mv(A(H), A(d)) + A(v)) + A(Hd - v) @ s)

    if mgd is not None:
        lin = mgd.lin
        linR, lint = lin[:, :9].reshape(NW, 3, 3), lin[:, 9:12]
        dvec = torch.cat([tdg._se3_local(linR, lint, st.R, st.t), st.vel - lin[:, 12:15],
                          st.bias - lin[:, 15:21]], -1)
        s = torch.cat([pose_scale(linR, lint, st.t), torch.zeros_like(lin[:, 12:21])], -1)
        m = mgd.mask[:, None].double()
        rows_b, e = quadratic(mgd.H, mgd.v, (dvec * m).reshape(N), (s * m).reshape(N))
        mb, me = mb + rows_b, me + e

    m = st.valid[:, None].double()
    dp6 = (tdg._se3_local(vis_linR, vis_lint, st.R, st.t) * m).reshape(6 * NW)
    s = (pose_scale(vis_linR, vis_lint, st.t) * m).reshape(6 * NW)
    rows_b, e = quadratic(vis_H, vis_v, dp6, s)
    pose_rows = ((15 * ar(NW))[:, None] + ar(6)).reshape(-1)
    mb = mb.index_add(0, pose_rows, rows_b)
    return mb, me + e


def tolerance_ratios(kernel, plain, args) -> dict:
    """``linearize``'s kernel output against the plain version's on
    ``args``: max |k - p| / tolerance for H, b and err, with the tolerances
    of ``tests/test_torch_linearize_cuda.py`` (its docstring says why):
    1e-5 |p| + 1e-6 sqrt(|p_ii p_jj|) for H, 1e-5 |p| + 8 eps32 m for b and
    err.  0 where both agree exactly, inf where only the bound is 0, nan
    where the kernel's entry is not finite."""
    (Hk, bk, ek), (Hp, bp, ep) = kernel, plain
    d = torch.diagonal(Hp).abs().double()
    mb, me = rounding_scale(*args)
    out = {}
    for name, k, p, floor in (("H", Hk, Hp, 1e-6 * torch.sqrt(d[:, None] * d[None, :])),
                              ("b", bk, bp, ROUNDINGS * EPS32 * mb),
                              ("err", ek, ep, ROUNDINGS * EPS32 * me)):
        diff = (k.double() - p.double()).abs()
        r = diff / (1e-5 * p.double().abs() + floor)
        out[name] = float(torch.where(diff == 0, torch.zeros_like(r), r).max())
    return out
