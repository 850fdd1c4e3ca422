"""Chip smoke test of the PyTorch/CUDA port (dbaf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--root DIR] [--kernels-only]

``--root`` names the directory that holds the ``dbaf_tpu_torch`` package to
drive (default: this checkout); ``--kernels-only`` stops after phase 2.  With
both, an older commit's package unpacked under a gitignored directory has
its kernels timed on the same inputs by the same code, so two versions are
compared in one call by running the script in turns (old, new, new, old).

Phases, each fatal on failure:
  1. build   print the card's name and power limit, build the CUDA kernels
             (one nvcc per source, started together) and print the seconds;
  2. kernels K1 corr_fused_xy at (E=48, 48x64, C=128), at a ragged shape,
             with every coordinate off the image (output exactly 0; at the
             main shape, so its time is K1 with no lookup work) and with
             a NaN coordinate row (0 there), K2 corr_lookup at (E=1, 48x64)
             in bf16 and f32, each against its plain PyTorch version on the
             card: max abs error against the stated bound, kernel ms (CUDA
             graph replay; the eager launch loop's ms beside it), plain ms,
             the computed bound ms, and the achieved TFLOP/s, TB/s and share
             of the bound (bound ms / kernel ms);
  3. main    the port's DBAFusion at tumvi_config() (384x512 frames, 48x64
             features, full-width DROID net with seeded random weights in the
             reference checkpoint format) on procedural frames with
             filter_thresh=-1, so initialization and ~20 fused keyframe steps
             run; the launch counters must show K2 on every gated frame and
             K1 in every update round; prints steady-state keyframes/s,
             and the device's idle share over the last 3 frames, run under
             torch.profiler (its table goes to chiprun_out/profile_main.txt);
  4. check   the 16-frame golden-trace config of tests/test_golden_trace.py
             on the card, held against tests/data/golden_trace.npz.
Then one JSON line listing both kernels, and last the ok line.

Exits non-zero without a CUDA device, and without the port's package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
MANIFEST = os.path.join(ROOT, "tests", "data", "droid_sd_manifest.json")
GOLDEN = os.path.join(ROOT, "tests", "data", "golden_trace.npz")

# published H100 SXM peaks (dense): bf16 tensor cores, f32 CUDA cores, HBM3
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

# K2 against its plain version, either volume dtype: both round at the same
# points and differ only in the order of f32 sums (bf16 products are exact in
# f32), so a skipped bf16 rounding (~2^-9 relative) would show far above it
K2_TOL = 1e-5

N_FRAMES = 30  # main path: initialization at 8, then ~20 fused keyframe steps


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call of ``fn`` launched from Python, CUDA events around
    ``iters`` calls after warm-up (includes the host's launch cost where it
    exceeds the device time)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int, replays: int = 5) -> float:
    """Mean device ms per call of ``fn``: ``iters`` calls captured in one
    CUDA graph, replayed ``replays`` times between CUDA events, so the
    host's launch cost drops out."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


# ---------------------------------------------------------------------------
# operation counts of this run's data (tent supports clipped at the borders)
# ---------------------------------------------------------------------------

def _support_sizes(c: torch.Tensor, size: int, level: int) -> torch.Tensor:
    """Taps with a nonzero weight per offset a in -3..3: (..., 7); none for
    a non-finite coordinate."""
    s = 2 ** level
    off = torch.arange(-3, 4, device=c.device, dtype=torch.float32)
    k0 = torch.floor(c / s)[..., None] + off
    lo = torch.clamp(k0 * s, 0, size)
    hi = torch.clamp((k0 + 2) * s, 0, size)
    return torch.nan_to_num((hi - lo).clamp(min=0), nan=0.0)


def _union_rows(c: torch.Tensor, size: int, level: int) -> torch.Tensor:
    s = 2 ** level
    k0 = torch.floor(c / s)
    lo = torch.clamp((k0 - 3) * s, 0, size)
    hi = torch.clamp((k0 + 5) * s, 0, size)
    return torch.nan_to_num((hi - lo).clamp(min=0), nan=0.0)


def lookup_flops(coords: torch.Tensor, H2: int, W2: int, x_first: bool) -> float:
    """Multiply-adds x2 of the separable tent contraction at every level:
    first stage over the union of the other axis's supports, then 49
    second-stage sums over each tap's support."""
    x, y = coords[..., 0].reshape(-1), coords[..., 1].reshape(-1)
    total = 0.0
    for lvl in range(4):
        nx, ny = _support_sizes(x, W2, lvl), _support_sizes(y, H2, lvl)
        if x_first:
            first = nx.sum(-1) * _union_rows(y, H2, lvl)
            second = 7 * ny.sum(-1)
        else:
            first = ny.sum(-1) * _union_rows(x, W2, lvl)
            second = 7 * nx.sum(-1)
        total += float((first + second).sum())
    return 2.0 * total


def bound(bytes_moved: float, op_seconds: float):
    t_bytes = bytes_moved / PEAK_BYTES
    if op_seconds > t_bytes:
        return op_seconds * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


# ---------------------------------------------------------------------------

def phase_kernels(dev) -> dict:
    """Each kernel against its plain version on the card; one JSON line per
    case with the error, its bound and the times."""
    from dbaf_tpu_torch.ops import corr as corr_ops
    from dbaf_tpu_torch.ops import corr_cuda as cc

    g = torch.Generator(device="cpu").manual_seed(0)

    def inputs(E, H, W, C):
        f1 = torch.randn(E, H, W, C, generator=g).to(dev)
        f2 = torch.randn(E, H, W, C, generator=g).to(dev)
        grid = torch.stack(torch.meshgrid(torch.arange(W), torch.arange(H), indexing="xy"), -1)
        noise = (torch.rand(E, H, W, 2, generator=g) - 0.5) * 16.0
        return f1, f2, (grid[None].float() + noise).to(dev).contiguous()

    def case(name, kernel, plain, tol, iters, plain_iters, nbytes, ops, peak, compare=None):
        out = kernel()
        torch.cuda.synchronize()
        ref = plain()
        if compare is None:
            err = (out.float() - ref.float()).abs().max().item()
        else:
            err = compare(out, ref)
        if not err <= tol:
            raise SystemExit(f"{name} disagrees with its plain version: {err} > {tol}")
        ms = graph_ms(kernel, iters)
        eager_ms = cuda_ms(kernel, iters)
        plain_ms = cuda_ms(plain, plain_iters, warmup=1)
        bms, by = bound(nbytes, ops / peak)
        row = dict(case=name, max_abs_err=err, tol=tol, ms=ms, eager_ms=eager_ms,
                   plain_ms=plain_ms, bound_ms=bms, bound_by=by)
        log("[kernels] " + json.dumps(row))
        log(f"[rate] {name}: {ops / (ms * 1e-3) / 1e12:.3f} TFLOP/s, "
            f"{nbytes / (ms * 1e-3) / 1e12:.4f} TB/s, share of bound {bms / ms:.4f} "
            f"(bound by {by})")
        return row

    def k1_case(name, E, H, W, C, kind="noise", iters=50):
        f1, f2, coords = inputs(E, H, W, C)
        compare = None
        if kind == "off_image":  # every support misses the image: exactly 0
            coords = coords + torch.tensor([2.0 * W + 40.0, -2.0 * H - 40.0], device=dev)

            def compare(out, ref):
                if torch.count_nonzero(out) or torch.count_nonzero(ref):
                    raise SystemExit(f"{name}: off-image coordinates gave a nonzero output")
                return 0.0
        if kind == "nan_row":  # an empty support: 0 there, the plain values elsewhere
            coords[:, H // 2] = float("nan")
            keep = torch.arange(H, device=dev) != H // 2

            def compare(out, ref):
                if torch.count_nonzero(out[:, H // 2]) or not torch.isfinite(out).all():
                    raise SystemExit(f"{name}: the NaN row is not 0, or an output is not finite")
                return (out[:, keep].float() - ref[:, keep].float()).abs().max().item()
        f1p, f2p = cc.prepare_corr_fmaps(f1, f2)
        P = H * W
        return case(
            name, lambda: cc.corr_fused_xy(f1p, f2p, coords, H, W),
            lambda: cc.corr_fused_xy_plain(f1p, f2p, coords, H, W),
            2e-2,  # test_corr.py's bf16 bound; K1 sums in another order
            iters, 2,
            E * P * C * 2 * 2 + E * P * 2 * 4 + E * P * 196 * 2,
            # the build and both tent contractions take bf16 operands
            2.0 * E * P * P * C + lookup_flops(coords, H, W, True), PEAK_BF16, compare)

    def k2_case(name, dtype):
        E, H, W = 1, 48, 64
        f1, f2, coords = inputs(E, H, W, 128)
        vol = corr_ops.build_volume_nhwc(f1.to(dtype), f2.to(dtype))
        P = H * W
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
        return case(
            name, lambda: cc.corr_lookup(vol, coords), lambda: cc.corr_lookup_plain(vol, coords),
            K2_TOL, 500, 5, vol.numel() * vol.element_size() + P * 2 * 4 + P * 196 * 4,
            lookup_flops(coords, H, W, False), peak)

    return {
        "corr_fused_xy": k1_case("K1 E=48 48x64 C=128", 48, 48, 64, 128),
        "corr_fused_xy_ragged": k1_case("K1 ragged E=8 37x45 C=128", 8, 37, 45, 128, iters=20),
        "corr_fused_xy_off_image": k1_case("K1 off-image E=48 48x64 C=128", 48, 48, 64, 128,
                                           "off_image"),
        "corr_fused_xy_nan_row": k1_case("K1 NaN row E=8 37x45 C=128", 8, 37, 45, 128,
                                         "nan_row", iters=20),
        "corr_lookup": k2_case("K2 E=1 48x64 bf16", torch.bfloat16),
        "corr_lookup_f32": k2_case("K2 E=1 48x64 f32", torch.float32),
    }


def seeded_params(seed: int):
    from dbaf_tpu_torch.models.convert import load_reference_state_dict, synth_reference_state_dict

    with open(MANIFEST) as f:
        manifest = json.load(f)
    return load_reference_state_dict(synth_reference_state_dict(manifest, seed), manifest)


def phase_main(dev, n_frames: int) -> dict:
    from dbaf_tpu_torch.ops import corr_cuda as cc
    from dbaf_tpu_torch.slam.system import DBAFusion
    from dbaf_tpu_torch.utils.config import tumvi_config

    cfg = tumvi_config()
    cfg.frontend.filter_thresh = -1.0  # admit every frame
    HT, WD = cfg.image_size
    system = DBAFusion(cfg, params=seeded_params(20260820), device=dev)
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, size=(HT + 64, WD + 64, 3)).astype(np.uint8)
    intr = np.asarray([460.0, 460.0, WD / 2, HT / 2], np.float32)

    def frame(k):
        ox, oy = (3 * k) % 64, (2 * k) % 64
        return base[oy:oy + HT, ox:ox + WD]

    cc.reset_launch_counts()
    fe = system.frontend
    n_prof = 3  # the last frames run under torch.profiler, outside the steady clock
    t_steady = wall = None
    prof = None
    for k in range(n_frames):
        if fe.is_initialized and t_steady is None:
            torch.cuda.synchronize()
            t_steady, steps0 = time.perf_counter(), fe.keyframe_steps
        if k == n_frames - n_prof:
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_steady
            steps_steady = fe.keyframe_steps - steps0
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                      torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
            t_prof = time.perf_counter()
        system.track(float(k), frame(k), intrinsics=intr)
    torch.cuda.synchronize()
    prof_wall = time.perf_counter() - t_prof
    prof.__exit__(None, None, None)
    events = prof.key_averages()
    # kernel rows only (CPU-op rows repeat their kernels' time)
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation) / 1e3
    log(f"[profile] last {n_prof} frames: device busy {busy:.3f} ms of {prof_wall * 1e3:.3f} ms "
        f"wall, idle share {1.0 - busy / (prof_wall * 1e3):.3f} (profiler on)")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "profile_main.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=60))
    launches = dict(cc.LAUNCHES)
    traj = system.terminate()
    log(f"[main] frames {n_frames}, keyframes {system.video.counter}, keyframe steps "
        f"{fe.keyframe_steps}, culls {fe.culls}, update rounds {fe.update_rounds}, "
        f"launches {launches}")
    if launches["corr_lookup"] < n_frames - 1:
        raise SystemExit(f"K2 launched {launches['corr_lookup']} times for {n_frames - 1} gated frames")
    if launches["corr_fused_xy"] < fe.update_rounds or fe.update_rounds == 0:
        raise SystemExit(f"K1 launched {launches['corr_fused_xy']} times for {fe.update_rounds} rounds")
    if traj.shape != (fe.keyframe_steps, 8) or not np.all(np.isfinite(traj)):
        raise SystemExit(f"trajectory {traj.shape} is not finite / not one row per step")
    if fe.keyframe_steps < 10:
        raise SystemExit(f"only {fe.keyframe_steps} keyframe steps ran")
    kfs = steps_steady / wall
    log(f"[main] steady state: {steps_steady} keyframe steps in {wall:.3f} s = "
        f"{kfs:.3f} kf/s (frame = gate + admission + fused step)")
    return dict(launches=launches, kf_per_s=kfs)


GOLDEN_H, GOLDEN_W, GOLDEN_SEED = 64, 96, 20260820


def golden_frame(k: int) -> np.ndarray:
    """The procedural frame the golden trace was recorded on
    (tests/test_golden_trace.py::frame)."""
    y, x = np.mgrid[0:GOLDEN_H, 0:GOLDEN_W].astype(np.float64)
    img = np.zeros((GOLDEN_H, GOLDEN_W, 3))
    for c, (fx, fy, ph) in enumerate(((0.31, 0.17, 0.0), (0.12, 0.41, 1.3), (0.23, 0.29, 2.1))):
        img[..., c] = np.sin(fx * (x + 3.0 * k) + fy * (y + 1.5 * k) + ph)
    img += (0.4 * np.sin(0.05 * (x + 5.0 * k)) * np.cos(0.07 * y))[..., None]
    return np.clip(127.5 + 90.0 * img, 0, 255).astype(np.uint8)


def phase_check(dev) -> None:
    """The golden-trace config (weights, frames and config of
    tests/test_golden_trace.py) on the card against the recorded trace.
    Bounds: tests/test_torch_system.py's bf16 bounds (the card's cuDNN and
    K1 round at other points than XLA on the CPU)."""
    from dbaf_tpu_torch.slam.system import DBAFusion
    from dbaf_tpu_torch.utils import config

    H, W = GOLDEN_H, GOLDEN_W
    cfg = config.DBAFusionConfig(
        image_size=(H, W), buffer=24,
        graph=config.GraphConfig(max_factors=32, edge_capacity=48, inactive_capacity=48,
                                 frontend_thresh=20.0, far_threshold=-1.0, mask_threshold=-1.0),
        frontend=config.FrontendConfig(warmup=8, keyframe_thresh=-1.0, filter_thresh=0.0,
                                       iters1=2, iters2=1, init_iters=4, rollup_start=1000,
                                       rollup_shift=8),
        ba=config.BAConfig(window=20, iters=2))
    system = DBAFusion(cfg, params=seeded_params(GOLDEN_SEED), device=dev)
    intr = np.asarray([70.0, 70.0, W / 2, H / 2], np.float32)
    for k in range(16):
        system.track(float(k), golden_frame(k), intrinsics=intr)
    traj = system.terminate().astype(np.float32)
    t1 = system.frontend.t1
    disps = system.video.disps[:t1].cpu().numpy()
    ref = np.load(GOLDEN)
    dev_traj = np.abs(traj - ref["traj"]).max() if traj.shape == ref["traj"].shape else np.inf
    dmean = np.abs(disps.mean(axis=(1, 2)) - ref["disp_mean"]).max()
    dstd = np.abs(disps.std(axis=(1, 2)) - ref["disp_std"]).max()
    log(f"[check] golden trace on the card: traj {dev_traj:.3e} (bound 2e-2), "
        f"disp_mean {dmean:.3e} (bound 0.6), disp_std {dstd:.3e} (bound 0.6)")
    if not (np.all(np.isfinite(traj)) and dev_traj <= 2e-2 and dmean <= 0.6 and dstd <= 0.6):
        raise SystemExit("golden trace on the card is outside its bounds")


def main() -> int:
    ap = argparse.ArgumentParser(description="Chip smoke test of the PyTorch/CUDA port.")
    ap.add_argument("--root", default=ROOT,
                    help="directory holding the dbaf_tpu_torch package (default: this checkout)")
    ap.add_argument("--kernels-only", action="store_true", help="stop after phase 2")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    import dbaf_tpu_torch
    from dbaf_tpu_torch.utils import cuda_build
    from dbaf_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    card = card_line()
    log(f"[build] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"package {os.path.dirname(dbaf_tpu_torch.__file__)}")
    t = time.perf_counter()
    cuda_build.build_kernels(verbose=True)
    log(f"[build] kernels built in {time.perf_counter() - t:.1f} s")

    rows = phase_kernels(dev)
    if args.kernels_only:
        return 0
    main_res = phase_main(dev, N_FRAMES)
    phase_check(dev)

    src = "dbaf_tpu_torch/csrc/"
    kernels = [
        dict(name="corr_fused_xy", route="cuda", source=src + "corr_fused_xy.cu",
             replaces="dbaf_tpu/ops/corr_pallas.py:206", row=rows["corr_fused_xy"]),
        dict(name="corr_lookup", route="cuda", source=src + "corr_lookup.cu",
             replaces="dbaf_tpu/ops/corr_pallas.py:58", row=rows["corr_lookup"]),
    ]
    out = []
    for k in kernels:
        r = k.pop("row")
        out.append(dict(k, launches=main_res["launches"][k["name"]], max_abs_err=r["max_abs_err"],
                        ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                        bound_by=r["bound_by"], library_ms=None))
    log(f"[main] {main_res['kf_per_s']:.3f} kf/s on {card}")
    print(card, flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
