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
             on the card, held against tests/data/golden_trace.npz;
  5. coupled the tightly-coupled IMU solve through DBAFusion.set_multisensor
             and track at tumvi_config() full width (bench.py's coupled
             configuration: 48-slot buffer, window 44, rollup 36/15, VI
             warmup 12, 48 edges, the device factor graph and the fused
             coupled step, filter_thresh=-1), 100 procedural frames with a
             simulated 200 Hz IMU; the full network runs every round and the
             synthetic-scene oracle replaces its outputs (bench.py:261-268),
             so the trajectory is metric.  Fatal unless VI init triggers,
             >= 10 fused coupled steps and a rollup run, K1 launches in every update round
             and K2 on every gated frame, the trajectory is finite, the
             SE3-aligned ATE of the body positions is under 0.08 x span and
             every |bias| is under 0.2.  Prints coupled kf/s after VI init,
             LM iterations per pass, host reads per keyframe, K1 ms per
             round, and the idle share over the last 3 frames under
             torch.profiler (its table goes to chiprun_out/profile_coupled.txt).
  6. coupled_async  phase 5's frames with cfg.sensors.coupled_async on (the
             zero-pull pipeline, as bench.py runs the coupled mode).  Every
             steady-state frame runs under torch.cuda.set_sync_debug_mode
             ("error"), the oracle's frame map uploaded from pinned memory.
             Fatal unless >= 60 async steps, a cull and a rollup inside the
             pipeline, K1 in every update round and K2 on every gated frame,
             a finite trajectory, ATE under 0.08 x span, every |bias| under
             0.2, phase 5's keyframe stamps, solved positions and trajectory
             rows within 2e-2 m of phase 5's (the bias reinitialization's
             drain included), and <= 3 blocking host reads per async step.
             Prints coupled kf/s over the async steps, reads per step, LM
             iterations and masked ones per pass, K1 ms per round, the idle
             share (its table goes to profile_coupled_async.txt beside phase
             5's) and the launches of one device edge selection.
  7. visual_async  bench.py's visual modes (bench.py:68-123: tumvi_config()
             with rollup 40/15, BA window 48, async_pipeline on; phase 3's
             network and frames, the synthetic-scene oracle's targets in the
             update rounds) through the asynchronous visual pipeline:
             "visual" (every frame admitted; warmed until a rollup has run
             inside the pipeline), "cull" (every keyframe culled) and
             "gateonly" (the gate rejects every frame after activation).
             Each settles 2 x drain_batch frames and times 30, every one
             under torch.cuda.set_sync_debug_mode("error").  Fatal unless
             the pipeline stays active, K2 runs on every frame and K1 in
             every admitted round, the trajectory is finite, at most one
             blocking read per drain, a rollup (visual) and a cull on every
             step (cull) ran inside the pipeline, t1 froze (gateonly), and
             "visual" gives the synchronous flow's keyframe stamps, edge
             lists and poses (within 1e-4: with the oracle's targets the two
             flows ran bit-equal on the card).  Prints kf/s per mode beside the synchronous
             flow's at the same frames and phase 3's, gateonly frames/s,
             reads per frame, masked rounds, K1 ms per round and the idle
             share of 3 more "visual" frames under torch.profiler (table in
             chiprun_out/profile_visual_async.txt);
  7b. int8   phase 3's main path for 12 keyframe steps with
             cfg.graph.corr_int8: fatal unless K1-int8 and its max pass run
             in every round and the trajectory is finite; prints the largest
             position difference from phase 3's bf16 rows at the same stamps.
  8. export  save_pkl through apps/runner.run at full width, the trajectories
             written to chiprun_out/export_*.txt and the asynchronous runs'
             reconstructions to export_*.pkl and export_*_raw.pkl: (a) phase
             7's "visual" configuration, 99 frames, on the visual pipeline's
             host-rollup route against the synchronous flow (fatal unless >= 2
             host rollups ran and the step never rolled, the archived and live
             stamps are equal, each exported once and in order, poses within
             1e-4 and disparities within 1e-4 or ten times the synchronous
             flow's own spread under a 1e-6 perturbation of the scene's
             disparities, whichever is larger); prints kf/s of both, blocking
             reads a frame, host rollups and archived keyframes; (b) phase 6's
             configuration (roll-out archival) against phase 5's, 100 frames
             (fatal unless the same stamps, positions within 5e-2 m,
             disparities within 2e-2, a rollup inside the pipeline, no drain
             but the bias reinitialization's, no archive left pending); (c)
             both async runs' filtered and raw .pkl read back with one finite
             point block per exported keyframe, and the ms of the export's
             device step (_points_and_counts) at (a)'s keyframe count.
Phase 2 also holds K1-int8 (max pass included) at (E=48, 48x64, C=128, tile
256), at a tile-128 shape, off the image and with a NaN row, and the max
pass alone, against their plain versions; and K1-raw (raw=True, the whole
32x32 block per pixel) at (E=48, 48x64, C=128), off the image and with a
NaN row: within one bf16 ulp of its largest output, rows and columns
28-31 exactly 0, its diagonal blocks against K1 on the same inputs, and
its output through the full network's update operator against the
196-channel route (delta and weight within 4 bf16 ulps of their largest
value).
Then one JSON line listing the kernels (launches summed over the main,
coupled, coupled_async, visual_async, int8 and export paths, each counted
from 0 just before its run; "launches_by_path" splits them), and last the
ok line.

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
N_COUPLED = 100  # coupled path: VI init after the 12-keyframe warmup, then a rollup
COUPLED_FPS = 10.0


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


def raw_lookup_flops(coords: torch.Tensor, H2: int, W2: int) -> float:
    """K1-raw's tent contraction: the x stage of all 28 columns over the
    rows that any level's y taps reach, then 28 y sums over each y tap's
    support."""
    x, y = coords[..., 0].reshape(-1), coords[..., 1].reshape(-1)
    nx = sum(_support_sizes(x, W2, lvl).sum(-1) for lvl in range(4))
    ny = sum(_support_sizes(y, H2, lvl).sum(-1) for lvl in range(4))
    rows = torch.stack([_union_rows(y, H2, lvl) for lvl in range(4)]).amax(0)
    return 2.0 * float((nx * rows + 28 * ny).sum())


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
        if isinstance(err, tuple):  # a per-element bound: (max error, max bound)
            err, tol = err
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

    def int8_case(name, E, H, W, C, tile, kind="noise", iters=50):
        """K1-int8 (its max pass included) against its plain version, by
        corr_cuda.int8_agreement: at most INT8_OFF_SHARE of the outputs
        more than one bf16 ulp apart (an f32 sum in another order flips the
        rounding of a quantized entry only near a half step), each within
        one int8 quantum of its tile's scale per tap, vmax * 1.07 / 127,
        plus one bf16 ulp of P2 (2^-7 vmax) and of the output (2^-7 |out|).
        The control: K1 (bf16, no quantization) on the same inputs must
        fail the check, unless every output is 0 (off the image)."""
        f1, f2, coords = inputs(E, H, W, C)
        if kind == "off_image":
            coords = coords + torch.tensor([2.0 * W + 40.0, -2.0 * H - 40.0], device=dev)
        if kind == "nan_row":
            coords[:, H // 2] = float("nan")
        f1p, f2p = cc.prepare_corr_fmaps(f1, f2)
        vmax = cc.corr_int8_vmax_plain(f1p, f2p, tile)
        keep = torch.arange(H, device=dev) != (H // 2 if kind == "nan_row" else -1)

        def compare(out, ref):
            if kind == "off_image" and (torch.count_nonzero(out) or torch.count_nonzero(ref)):
                raise SystemExit(f"{name}: off-image coordinates gave a nonzero output")
            if kind == "nan_row" and (torch.count_nonzero(out[:, H // 2])
                                      or not torch.isfinite(out).all()):
                raise SystemExit(f"{name}: the NaN row is not 0, or an output is not finite")
            agree = cc.int8_agreement(out, ref, vmax, tile, keep)
            log(f"[kernels] {name}: {agree}")
            if not agree.ok:
                raise SystemExit(f"{name}: disagrees with its plain version (at most "
                                 f"{cc.INT8_OFF_SHARE} of the outputs may be over one ulp)")
            if kind != "off_image":
                control = cc.int8_agreement(cc.corr_fused_xy(f1p, f2p, coords, H, W), ref, vmax,
                                            tile, keep)
                log(f"[kernels] {name} control, K1 (bf16): {control}")
                if control.ok:
                    raise SystemExit(f"{name}: K1 (bf16) passes the int8 check")
            return agree.max_abs_err, agree.max_bound
        P = H * W
        return case(
            name, lambda: cc.corr_fused_xy_int8(f1p, f2p, coords, H, W, tile),
            lambda: cc.corr_fused_xy_int8_plain(f1p, f2p, coords, H, W, tile),
            None, iters, 2,
            E * P * C * 2 * 2 + E * P * 2 * 4 + E * P * 196 * 2,
            # the build's flops once, as for K1: a two-pass design reads 2x
            2.0 * E * P * P * C + lookup_flops(coords, H, W, True), PEAK_BF16, compare)

    def raw_case(name, E, H, W, C, kind="noise", iters=20):
        """K1-raw against its plain version, within one bf16 ulp of the
        largest output (2^-7 max|out|: the same rounding points, f32 sums
        in another order), rows and columns 28-31 exactly 0; off the image
        exactly 0, a NaN row 0 there.  Its diagonal blocks, gathered by
        raw_corr_index, against K1 on the same inputs at the same bound."""
        f1, f2, coords = inputs(E, H, W, C)
        if kind == "off_image":
            coords = coords + torch.tensor([2.0 * W + 40.0, -2.0 * H - 40.0], device=dev)
        if kind == "nan_row":
            coords[:, H // 2] = float("nan")
        keep = torch.arange(H, device=dev) != (H // 2 if kind == "nan_row" else -1)
        f1p, f2p = cc.prepare_corr_fmaps(f1, f2)
        idx = torch.as_tensor(cc.raw_corr_index(), device=dev).long()
        live = torch.nonzero(idx >= 0)[:, 0]
        pos = torch.empty(196, dtype=torch.long, device=dev)
        pos[idx[live]] = live

        def compare(out, ref):
            block = out.reshape(E, H, W, 32, 32)
            if torch.count_nonzero(block[..., 28:, :]) or torch.count_nonzero(block[..., :, 28:]):
                raise SystemExit(f"{name}: a row or column 28-31 is not 0")
            if kind == "off_image" and (torch.count_nonzero(out) or torch.count_nonzero(ref)):
                raise SystemExit(f"{name}: off-image coordinates gave a nonzero output")
            if kind == "nan_row" and (torch.count_nonzero(out[:, H // 2])
                                      or not torch.isfinite(out).all()):
                raise SystemExit(f"{name}: the NaN row is not 0, or an output is not finite")
            out, ref = out[:, keep].float(), ref[:, keep].float()
            tol = 2.0 ** -7 * float(ref.abs().max())
            err = float((out - ref).abs().max())
            k1 = cc.corr_fused_xy(f1p, f2p, coords, H, W)[:, keep].float()
            gather = out[..., pos]
            g_err = float((gather - k1).abs().max())
            log(f"[kernels] {name}: gather by raw_corr_index against K1: max abs err {g_err}, "
                f"{int((gather != k1).sum())} of {k1.numel()} outputs differ (bound {tol})")
            if not g_err <= tol:
                raise SystemExit(f"{name}: its diagonal blocks disagree with K1: {g_err} > {tol}")
            if kind == "noise":
                update_check(name, out, k1)
            return err, tol
        P = H * W
        return case(
            name, lambda: cc.corr_fused_xy(f1p, f2p, coords, H, W, raw=True),
            lambda: cc.corr_fused_xy_raw_plain(f1p, f2p, coords, H, W), None, iters, 1,
            E * P * C * 2 * 2 + E * P * 2 * 4 + E * P * 1024 * 2,
            # the build once, as for K1 (this design builds it once per y level)
            2.0 * E * P * P * C + raw_lookup_flops(coords, H, W), PEAK_BF16, compare)

    def update_check(name, raw, k1):
        """The raw layout through DroidNet's update operator at full width
        (the seeded network in bf16) against the 196-channel route on K1's
        output: delta and weight within four bf16 ulps of their largest
        value (2^-5 max|ref|).  The first corr-encoder conv sums 1024 terms
        (zeros off the diagonal blocks) where the 196-channel one sums 196,
        so its f32 sums run in another order and a rare output rounds one
        bf16 ulp apart; seven more bf16 convolutions carry that on."""
        from dbaf_tpu_torch.models.net import DroidNet

        model = DroidNet(device=dev)
        model.load_state_dict(seeded_params(20260820))
        model.eval()
        E, H, W = raw.shape[:3]
        gen = torch.Generator(device="cpu").manual_seed(1)
        net = torch.tanh(torch.randn(E, H, W, 128, generator=gen)).to(dev)
        inp = torch.relu(torch.randn(E, H, W, 128, generator=gen)).to(dev)
        flow = torch.randn(E, H, W, 4, generator=gen).to(dev)
        o_raw = model.update_step(net, inp, raw, flow)
        o_196 = model.update_step(net, inp, k1, flow)
        for label, a, b in (("delta", o_raw[1], o_196[1]), ("weight", o_raw[2], o_196[2])):
            tol = 2.0 ** -5 * float(b.abs().max())
            err = float((a - b).abs().max())
            log(f"[kernels] {name} through the update operator: {label} max abs err {err} "
                f"(bound {tol}), {int((a != b).sum())} of {b.numel()} differ")
            if not (err <= tol and torch.isfinite(a).all()):
                raise SystemExit(f"{name}: the update operator's {label} on the raw layout "
                                 f"disagrees with the 196-channel route: {err} > {tol}")

    def vmax_case(name, E, H, W, C, tile):
        """The max pass alone against its plain version: f32 sums of bf16
        products in another order, rtol 1e-4."""
        f1, f2, _ = inputs(E, H, W, C)
        f1p, f2p = cc.prepare_corr_fmaps(f1, f2)
        P = H * W

        def compare(out, ref):
            err, bnd = (out - ref).abs(), 1e-4 * ref
            if not bool((err <= bnd).all()):
                raise SystemExit(f"{name}: a tile's scale is off by {float((err / ref).max())}")
            return float(err.max()), float(bnd.max())
        return case(
            name, lambda: cc.corr_int8_vmax(f1p, f2p, H, W, tile),
            lambda: cc.corr_int8_vmax_plain(f1p, f2p, tile), None, 50, 2,
            E * P * C * 2 * 2 + E * (P // tile) * 4, 2.0 * E * P * P * C, PEAK_BF16, compare)

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
        "corr_int8_vmax": vmax_case("K1-int8 max pass E=48 48x64 C=128 tile 256", 48, 48, 64,
                                    128, 256),
        "corr_fused_xy_int8": int8_case("K1-int8 E=48 48x64 C=128 tile 256", 48, 48, 64, 128,
                                        256),
        "corr_fused_xy_int8_tile128": int8_case("K1-int8 E=8 32x60 C=128 tile 128", 8, 32, 60,
                                                128, 128, iters=20),
        "corr_fused_xy_int8_off_image": int8_case("K1-int8 off-image E=48 48x64 C=128", 48, 48,
                                                  64, 128, 256, "off_image"),
        "corr_fused_xy_int8_nan_row": int8_case("K1-int8 NaN row E=8 32x60 C=128", 8, 32, 60,
                                                128, 128, "nan_row", iters=20),
        "corr_fused_xy_raw": raw_case("K1-raw E=48 48x64 C=128", 48, 48, 64, 128),
        "corr_fused_xy_raw_off_image": raw_case("K1-raw off-image E=48 48x64 C=128", 48, 48, 64,
                                                128, "off_image"),
        "corr_fused_xy_raw_nan_row": raw_case("K1-raw NaN row E=8 37x45 C=128", 8, 37, 45, 128,
                                              "nan_row"),
        "corr_lookup": k2_case("K2 E=1 48x64 bf16", torch.bfloat16),
        "corr_lookup_f32": k2_case("K2 E=1 48x64 f32", torch.float32),
    }


N_PROFILED = 3  # the last frames of a path run under torch.profiler, off its steady clock


class Profile:
    """torch.profiler over a path's last frames: device busy time (kernel
    rows only; CPU-op rows repeat their kernels' time), idle share, the
    table under chiprun_out/, and the device time of each kernel by name."""

    def __init__(self):
        torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                       torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self, tag: str, table_name: str) -> dict:
        torch.cuda.synchronize()
        wall = (time.perf_counter() - self.t0) * 1e3
        self.prof.__exit__(None, None, None)
        events = self.prof.key_averages()
        kernels = {e.key: e.self_device_time_total / 1e3 for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation}
        busy = sum(kernels.values())
        idle = 1.0 - busy / wall
        log(f"[{tag}] profile of the last {N_PROFILED} frames: device busy {busy:.3f} ms of "
            f"{wall:.3f} ms wall, idle share {idle:.3f} (profiler on)")
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
        for name, ms in top:
            log(f"[{tag}]   {ms:10.3f} ms  {name[:100]}")
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", table_name), "w") as f:
            f.write(events.table(sort_by="self_device_time_total", row_limit=60))
        return dict(busy_ms=busy, wall_ms=wall, idle_share=idle, kernels=kernels)


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
    t_steady = wall = None
    prof = None
    for k in range(n_frames):
        if fe.is_initialized and t_steady is None:
            torch.cuda.synchronize()
            t_steady, steps0 = time.perf_counter(), fe.keyframe_steps
        if k == n_frames - N_PROFILED:
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_steady
            steps_steady = fe.keyframe_steps - steps0
            prof = Profile()
        system.track(float(k), frame(k), intrinsics=intr)
    prof.stop("main", "profile_main.txt")
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
    return dict(launches=launches, kf_per_s=kfs, traj=traj)


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


def coupled_config(coupled_async: bool = False):
    """bench.py:240-255's coupled configuration; bench.py runs it with the
    asynchronous pipeline on (phase 6), phase 5 with it off."""
    from dbaf_tpu_torch.utils.config import tumvi_config

    cfg = tumvi_config()
    cfg.buffer = 48
    cfg.ba.window = 44
    cfg.frontend.rollup_start = 36
    cfg.frontend.rollup_shift = 15
    cfg.frontend.vi_warmup = 12
    cfg.frontend.filter_thresh = -1.0  # admit every frame
    cfg.graph.edge_capacity = 48
    cfg.sensors.device_solver = True
    cfg.sensors.coupled_mega = True
    cfg.sensors.coupled_async = coupled_async
    return cfg


class CoupledRun:
    """The coupled path's system on the card: the full network in every
    round with the synthetic-scene oracle replacing its outputs on the
    update rounds (the motion gate keeps the network's own), a simulated
    200 Hz IMU, procedural frames."""

    def __init__(self, dev, cfg, n_frames: int):
        from dbaf_tpu_torch.eval.synthetic import (make_oracle, scene_from_poses,
                                                   simulate_imu_and_poses)
        from dbaf_tpu_torch.models.net import DroidNet
        from dbaf_tpu_torch.slam.system import DBAFusion

        self.dev, self.cfg, self.fps = dev, cfg, COUPLED_FPS
        HT, WD = self.image_size = cfg.image_size
        H8, W8 = cfg.feat_size
        self.intr8 = np.asarray([2.0 * W8, 2.0 * W8, W8 / 2, H8 / 2], np.float32)
        imu_rows, self.poses_at = simulate_imu_and_poses(n_frames / self.fps + 0.5, fps=self.fps)
        gt_cw, gt_disps = scene_from_poses(self.poses_at, n_frames, self.intr8, H8, W8)
        model = DroidNet(device=dev)
        model.load_state_dict(seeded_params(20260820))
        model.eval()
        oracle = make_oracle(gt_cw, gt_disps, self.intr8, device=dev)

        def update_fn(net, inp, corr, motn, ii, jj, aux):
            net2, delta, weight = model.update_fn(net, inp, corr, motn, ii, jj, aux)
            if "id_map" not in aux:  # the motion gate
                return net2, delta, weight
            # the network's outputs folded in at 1e-30, as bench.py does
            _, d_o, w_o = oracle(net, inp, corr, motn, ii, jj, aux)
            return net2, d_o + delta.float() * 1e-30, w_o + weight.float() * 1e-30

        self.system = DBAFusion(cfg, device=dev, feat_fn=model.features_only,
                                ctx_fn=model.context_only, update_fn=update_fn)
        self.system.set_multisensor(imu_rows, np.eye(4), imu_noise=[0.05, 0.005, 1e-4, 1e-6])
        rng = np.random.default_rng(1)
        self.base = rng.integers(0, 255, size=(HT + 64, WD + 64, 3)).astype(np.uint8)
        self.id_map = np.zeros(cfg.buffer, np.int64)

    def track(self, k: int, upload) -> None:
        """Feed frame k (:meth:`stream`'s frame, tracked directly)."""
        for t, image, intr in self.stream([k], upload):
            self.system.track(t, image, intrinsics=intr)

    def stream(self, frames, upload):
        """(t, image, intrinsics) of each frame in ``frames``, for
        ``DBAFusion.track`` or ``runner.run``.  The oracle's map (video slot
        -> frame id: the frame takes slot `counter`; culls and rollups move
        slots, so it is rebuilt after the frame is tracked) goes up through
        ``upload(array, device)`` around each yield."""
        v, g = self.system.video, self.system.graph
        HT, WD = self.image_size
        for k in frames:
            self.id_map[v.counter] = k
            g.aux = {"id_map": upload(self.id_map, self.dev)}
            ox, oy = (3 * k) % 64, (2 * k) % 64
            yield k / self.fps, self.base[oy:oy + HT, ox:ox + WD], self.intr8 * 8.0
            n = v.counter
            self.id_map[:n] = np.round(v.tstamp[:n] * self.fps).astype(np.int64)
            g.aux = {"id_map": upload(self.id_map, self.dev)}

    def positions(self) -> np.ndarray:
        """The solved body positions of every keyframe, after terminate."""
        st = self.system.graph.coupled.state
        return np.asarray([st.wTbs[k].t for k in range(self.system.frontend.t1)])

    def accuracy(self):
        """(ATE of the body positions, trajectory span, max |bias|)."""
        from dbaf_tpu_torch.eval.ate import ate_rmse

        v, st, fps = self.system.video, self.system.graph.coupled.state, self.fps
        t1 = self.system.frontend.t1
        est = self.positions()
        ref = np.stack([self.poses_at[i][1] for i in np.round(v.tstamp[:t1] * fps).astype(int)])
        return (ate_rmse(est, ref, align="se3"), float(np.linalg.norm(ref.max(0) - ref.min(0))),
                float(np.abs(np.asarray([st.bs[k] for k in range(t1)])).max()))


def phase_coupled(dev, n_frames: int) -> dict:
    """The tightly-coupled path through DBAFusion's entry points, on the
    synchronous flow."""
    from dbaf_tpu_torch.ops import corr_cuda as cc
    from dbaf_tpu_torch.utils import device as devmod

    run = CoupledRun(dev, coupled_config(), n_frames)
    system = run.system
    fe, g, v = system.frontend, system.graph, system.video
    upload = lambda a, d: torch.as_tensor(a, device=d)  # noqa: E731

    def track(k):
        run.track(k, upload)

    cc.reset_launch_counts()
    vi_key = t_steady = prof = None
    lm_iters = lm_passes = 0
    for k in range(n_frames):
        if k == n_frames - N_PROFILED:
            if t_steady is None:
                raise SystemExit(f"coupled: VI initialization did not trigger in {k} frames")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_steady
            steps_steady = fe.keyframe_steps - steps0
            reads_steady = devmod.HOST_READS["count"] - reads0
            rounds_prof0 = fe.update_rounds
            prof = Profile()
        megas0 = g.mega_count
        track(k)
        if g.mega_count > megas0:  # realized LM iterations of the executed passes
            lm = g.lm_stats.cpu()
            lm_iters += int(lm.sum())
            lm_passes += int(torch.count_nonzero(lm))
        if vi_key is None and v.imu_enabled:
            vi_key = k
            torch.cuda.synchronize()
            t_steady, steps0 = time.perf_counter(), fe.keyframe_steps
            reads0 = devmod.HOST_READS["count"]
    rounds_prof = fe.update_rounds - rounds_prof0
    pr = prof.stop("coupled", "profile_coupled.txt")
    launches = dict(cc.LAUNCHES)
    traj = system.terminate()
    ecef = system.trajectory_ecef
    k1_ms = sum(ms for name, ms in pr["kernels"].items() if "corr_fused_xy_kernel" in name)
    ate, span, bias = run.accuracy()
    res = dict(frames=n_frames, vi_key=vi_key, keyframe_steps=fe.keyframe_steps,
               mega_steps=g.mega_count, culls=fe.culls, rollups=fe.rollup_count,
               update_rounds=fe.update_rounds, launches=launches,
               kf_per_s=steps_steady / wall, steady_steps=steps_steady,
               host_reads_per_kf=reads_steady / steps_steady,
               lm_iters_per_pass=lm_iters / max(lm_passes, 1), lm_passes=lm_passes,
               k1_ms_per_round=k1_ms / max(rounds_prof, 1), idle_share=pr["idle_share"],
               ate=ate, span=span, ate_share=ate / span, max_abs_bias=bias,
               ecef_rows=len(ecef))
    log("[coupled] " + json.dumps(res))
    if launches["corr_lookup"] < n_frames - 1:
        raise SystemExit(f"coupled: K2 launched {launches['corr_lookup']} times for "
                         f"{n_frames - 1} gated frames")
    if launches["corr_fused_xy"] < fe.update_rounds or fe.update_rounds == 0:
        raise SystemExit(f"coupled: K1 launched {launches['corr_fused_xy']} times for "
                         f"{fe.update_rounds} update rounds")
    if g.mega_count < 10:
        raise SystemExit(f"coupled: only {g.mega_count} fused coupled steps ran")
    if fe.rollup_count < 1:
        raise SystemExit("coupled: no rollup ran")
    if traj.shape[0] == 0 or not np.all(np.isfinite(traj)):
        raise SystemExit(f"coupled: trajectory {traj.shape} is empty or not finite")
    if not ate < 0.08 * span:
        raise SystemExit(f"coupled: ATE {ate} m is not under 0.08 x span ({span} m)")
    if not bias < 0.2:
        raise SystemExit(f"coupled: a bias reached {bias} (bound 0.2)")
    log(f"[coupled] {res['kf_per_s']:.3f} kf/s after VI init ({steps_steady} steps), "
        f"{res['lm_iters_per_pass']:.3f} LM iterations per pass, "
        f"{res['host_reads_per_kf']:.3f} host reads per keyframe, K1 "
        f"{res['k1_ms_per_round']:.4f} ms per round, ATE {ate:.4f} m of span {span:.3f} m")
    res["traj"], res["pos"] = traj, run.positions()  # for phase 6's comparison, not printed
    return res


def phase_coupled_async(dev, n_frames: int, sync_res: dict) -> dict:
    """Phase 6: phase 5's run with the asynchronous coupled pipeline on
    (bench.py's coupled mode).  Every steady-state frame -- the pipeline
    active before and after it, outside the last 3 frames under the profiler
    and the frames that drain the pipeline -- runs under
    torch.cuda.set_sync_debug_mode("error"), and its host time, async steps
    and blocking host reads are summed; the oracle's frame map is uploaded
    through pinned memory, so the harness makes no sync."""
    from dbaf_tpu_torch.ops import corr_cuda as cc
    from dbaf_tpu_torch.utils import device as devmod

    run = CoupledRun(dev, coupled_config(coupled_async=True), n_frames)
    system = run.system
    fe, g = system.frontend, system.graph
    cc.reset_launch_counts()
    prof = None
    guarded = steps_timed = reads_timed = 0
    wall = 0.0
    for k in range(n_frames):
        ca = fe._casync
        active = ca is not None and ca.active
        # the bias reinitialization 5 s after VI init drains the pipeline
        reinit = g.coupled is not None and k / run.fps - g.coupled.vi_init_time > 5.0
        if k == n_frames - N_PROFILED:
            k1_prof0 = cc.LAUNCHES["corr_fused_xy"]
            prof = Profile()
        guard = active and not reinit and prof is None
        steps0 = ca.total_steps if active else 0
        reads0 = devmod.HOST_READS["count"]
        if guard:
            torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            run.track(k, devmod.upload)
        finally:
            if guard:
                torch.cuda.set_sync_debug_mode(0)
        if guard and ca.active:
            wall += time.perf_counter() - t0
            guarded += 1
            steps_timed += ca.total_steps - steps0
            reads_timed += devmod.HOST_READS["count"] - reads0
    ca = fe._casync
    if prof is None or steps_timed == 0:
        raise SystemExit("coupled_async: no steady-state async step before the profiled frames")
    k1_prof = cc.LAUNCHES["corr_fused_xy"] - k1_prof0
    pr = prof.stop("coupled_async", "profile_coupled_async.txt")
    launches = dict(cc.LAUNCHES)
    stats = ca.stats()
    traj = system.terminate()
    ate, span, bias = run.accuracy()
    k1_ms = sum(ms for name, ms in pr["kernels"].items() if "corr_fused_xy_kernel" in name)
    # the keyframes' solved positions and the trajectory rows (decision-time
    # poses after rounds_a, the reinit drain's keyframe included) against
    # phase 5's, at the bound of test_coupled_async.py
    ref, pos = sync_res["traj"], run.positions()
    same_stamps = traj.shape == ref.shape and np.array_equal(traj[:, 0], ref[:, 0])
    pos_diff = (float(np.abs(pos - sync_res["pos"]).max()) if pos.shape == sync_res["pos"].shape
                else float("inf"))
    row_diff = (np.abs(traj[:, 1:4] - ref[:, 1:4]).max(axis=1) if same_stamps
                else np.full(1, np.inf))
    res = dict(frames=n_frames, async_steps=ca.total_steps, activations_steps=ca.steps,
               culls=ca.culls, rollups=ca.rollups, keyframe_steps=fe.keyframe_steps,
               update_rounds=fe.update_rounds, launches=launches, guarded_steps=guarded,
               kf_per_s=steps_timed / wall, timed_steps=steps_timed,
               host_reads_per_step=reads_timed / steps_timed,
               lm_iters_per_pass=stats["lm_iters"] / max(stats["lm_passes"], 1),
               wasted_lm_iters_per_pass=(stats["lm_launched"] - stats["lm_iters"])
               / max(stats["lm_passes"], 1),
               masked_rounds=stats["masked_rounds"], wasted_rounds=stats["wasted_rounds"],
               k1_ms_per_round=k1_ms / max(k1_prof, 1), idle_share=pr["idle_share"],
               ate=ate, span=span, ate_share=ate / span, max_abs_bias=bias,
               same_stamps_as_sync=bool(same_stamps), max_pos_diff_to_sync=pos_diff,
               traj_row_diff_to_sync_max=float(row_diff.max()),
               traj_row_diff_to_sync_mean=float(row_diff.mean()),
               traj_row_diff_to_sync_argmax=int(row_diff.argmax()))
    log("[coupled_async] " + json.dumps(res))
    checks = [
        (ca.total_steps >= 60, f"only {ca.total_steps} async steps ran"),
        (ca.culls >= 1, "no cull inside the pipeline"),
        (ca.rollups >= 1, "no rollup inside the pipeline"),
        (guarded >= 5, f"only {guarded} steady-state steps ran under sync debug 'error'"),
        (launches["corr_fused_xy"] >= fe.update_rounds > 0,
         f"K1 launched {launches['corr_fused_xy']} times for {fe.update_rounds} update rounds"),
        (launches["corr_lookup"] >= n_frames - 1,
         f"K2 launched {launches['corr_lookup']} times for {n_frames - 1} gated frames"),
        (traj.shape[0] > 0 and np.all(np.isfinite(traj)), f"trajectory {traj.shape} not finite"),
        (ate < 0.08 * span, f"ATE {ate} m is not under 0.08 x span ({span} m)"),
        (bias < 0.2, f"a bias reached {bias} (bound 0.2)"),
        (same_stamps, "keyframe stamps differ from phase 5's"),
        (pos_diff <= 2e-2, f"solved positions {pos_diff} m from phase 5's (bound 2e-2)"),
        (row_diff.max() <= 2e-2,
         f"trajectory row {int(row_diff.argmax())} {float(row_diff.max())} m from phase 5's "
         "(bound 2e-2)"),
        (res["host_reads_per_step"] <= 3,
         f"{res['host_reads_per_step']} blocking host reads per async step (bound 3)"),
    ]
    for ok, msg in checks:
        if not ok:
            raise SystemExit("coupled_async: " + msg)
    log(f"[coupled_async] {res['kf_per_s']:.3f} kf/s over {steps_timed} async steps, "
        f"{res['host_reads_per_step']:.3f} host reads per async step, "
        f"{res['lm_iters_per_pass']:.3f} LM iterations and "
        f"{res['wasted_lm_iters_per_pass']:.3f} masked ones per pass, "
        f"{stats['wasted_rounds']} of {stats['masked_rounds']} masked rounds undone, K1 "
        f"{res['k1_ms_per_round']:.4f} ms per round (one launch a round), "
        f"idle share {pr['idle_share']:.3f}")
    greedy_launches(dev)
    return res


def greedy_launches(dev) -> int:
    """Kernel launches of one device edge selection (slam/edge_select.py)
    at the TUM-VI preset's shapes, counted by torch.profiler."""
    from dbaf_tpu_torch.slam.edge_select import select_proximity_edges
    from dbaf_tpu_torch.utils.config import tumvi_config

    gc = tumvi_config().graph
    src = wf = gc.frontend_window
    n_skip = len(gc.skip_edge)
    t = 30
    rng = np.random.default_rng(0)
    ii = np.concatenate([np.repeat(np.arange(t - src, t), wf), np.full(n_skip, t - 1)])
    jj = np.concatenate([np.tile(np.arange(t - wf, t), src), t - src + np.asarray(gc.skip_edge)])
    args = [torch.as_tensor(a, device=dev) for a in (
        rng.uniform(0, 30, len(ii)).astype(np.float32), ii, jj,
        rng.integers(0, t, 200), rng.integers(0, t, 200), rng.random(200) < 0.5,
        t - src, t - wf, t)]

    def call():
        return select_proximity_edges(*args, gc.frontend_thresh, src=src, win=wf, n_skip=n_skip,
                                      rad=gc.frontend_radius, nms=gc.frontend_nms,
                                      max_factors=gc.max_factors,
                                      max_out=4 * (gc.max_factors + 60))

    call()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as p:
        call()
        torch.cuda.synchronize()
    n = sum(e.count for e in p.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    log(f"[coupled_async] device edge selection: {n} kernel launches per keyframe "
        f"({src * wf + n_skip} greedy trips)")
    return n


N_MEASURED = 30  # phase 7: measured frames per mode


def visual_config(mode: str, async_on: bool = True):
    """bench.py:80-88's visual configuration: tumvi_config() with rollup
    40/15, BA window 48 and the pipeline on; every frame admitted, and in
    "cull" mode every keyframe culled (keyframe_thresh 1e9)."""
    from dbaf_tpu_torch.utils.config import tumvi_config

    cfg = tumvi_config()
    cfg.frontend.rollup_start = 40
    cfg.frontend.rollup_shift = 15
    cfg.frontend.async_pipeline = async_on
    cfg.ba.window = 48
    cfg.frontend.filter_thresh = -1.0
    cfg.frontend.keyframe_thresh = 1e9 if mode == "cull" else -1.0
    return cfg


class VisualRun:
    """bench.py's visual mode on the card: the full network with phase 3's
    seeded weights in every round and gate, procedural frames.  The update
    rounds take the synthetic-scene oracle's targets and weights (the
    network's outputs folded in at 1e-30, as phase 5 does); the oracle's
    slot -> frame map is a slot-keyed aux leaf, rolled with the video at a
    rollup by both flows, so without culls it is the true map."""

    def __init__(self, dev, cfg, model, oracle, n_scene: int):
        from dbaf_tpu_torch.slam.system import DBAFusion

        def update_fn(net, inp, corr, motn, ii, jj, aux):
            net2, delta, weight = model.update_fn(net, inp, corr, motn, ii, jj, aux)
            if "id_map" not in aux:  # the motion gate
                return net2, delta, weight
            _, d_o, w_o = oracle(net, inp, corr, motn, ii, jj, aux)
            return net2, d_o + delta.float() * 1e-30, w_o + weight.float() * 1e-30

        self.cfg = cfg
        self.system = DBAFusion(cfg, device=dev, feat_fn=model.features_only,
                                ctx_fn=model.context_only, update_fn=update_fn)
        self.system.graph.aux = {"id_map": torch.clamp(torch.arange(cfg.buffer, device=dev),
                                                       max=n_scene - 1)}
        HT, WD = cfg.image_size
        rng = np.random.default_rng(0)
        self.base = rng.integers(0, 255, size=(HT + 64, WD + 64, 3)).astype(np.uint8)
        self.intr = np.asarray([460.0, 460.0, WD / 2, HT / 2], np.float32)

    def frame(self, k: int):
        """(t, image, intrinsics) of frame k."""
        HT, WD = self.cfg.image_size
        ox, oy = (3 * k) % 64, (2 * k) % 64
        return float(k), self.base[oy:oy + HT, ox:ox + WD], self.intr

    def track(self, k: int) -> None:
        t, image, intr = self.frame(k)
        self.system.track(t, image, intrinsics=intr)


VISUAL_SCENE = 128  # frames of the visual phases' synthetic scene


def visual_oracle(dev, perturb: float = 0.0):
    """The synthetic-scene oracle of the visual phases at tumvi_config()'s
    feature grid; ``perturb`` moves the scene's disparities by that much
    (relative, seeded noise)."""
    from dbaf_tpu_torch.eval.synthetic import make_oracle, scene_from_poses, simulate_imu_and_poses

    H8, W8 = visual_config("visual").feat_size
    _, poses_at = simulate_imu_and_poses(VISUAL_SCENE / 10.0 + 0.5, fps=10.0)
    intr8 = np.asarray([2.0 * W8, 2.0 * W8, W8 / 2, H8 / 2], np.float32)
    gt_cw, gt_disps = scene_from_poses(poses_at, VISUAL_SCENE, intr8, H8, W8)
    if perturb:
        noise = np.random.default_rng(0).normal(size=gt_disps.shape)
        gt_disps = (gt_disps * (1.0 + perturb * noise)).astype(gt_disps.dtype)
    return make_oracle(gt_cw, gt_disps, intr8, device=dev)


def buffer_move_ms(dev) -> dict:
    """Device ms a frame of the steps' rollup moves at phase 7's shapes
    (tumvi_config(): a 256-slot buffer of 48x64 rows; rollup 40/15), when
    nothing rolls: the 26 rows that can be live (DepthVideo.rollup_device,
    which both asynchronous steps run) against a whole-buffer identity
    gather (torch.roll(buf, -shift) for a device shift), over the six video
    buffers."""
    from dbaf_tpu_torch.slam.video import roll_rows

    cfg = visual_config("visual")
    B, (H8, W8) = cfg.buffer, cfg.feat_size
    bufs = [torch.zeros(B, 7, device=dev), torch.ones(B, H8, W8, device=dev),
            torch.ones(B, H8, W8, device=dev)] + [
        torch.zeros(B, H8, W8, 128, dtype=torch.bfloat16, device=dev) for _ in range(3)]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    n_live = min(cfg.frontend.rollup_start + 1, B) - cfg.frontend.rollup_shift
    live = graph_ms(lambda: [roll_rows(b, zero, n_live) for b in bufs], 20)
    whole = graph_ms(lambda: [roll_rows(b, zero, B) for b in bufs], 20)
    log(f"[visual_async] rollup moves a frame: {n_live} live rows {live:.4f} ms, whole-buffer "
        f"gather {whole:.4f} ms")
    return dict(live_rows_ms=live, whole_buffer_ms=whole)


def phase_visual_async(dev, main_kfs: float) -> dict:
    """Phase 7: bench.py's visual modes through the asynchronous pipeline.
    Each mode warms until the pipeline is active (and, in "visual" mode,
    one rollup has run inside it), settles 2 x drain_batch frames, then
    times N_MEASURED frames, each under torch.cuda.set_sync_debug_mode
    ("error"); "visual" mode profiles 3 frames more, and its frames run
    once more through the synchronous flow (the async-equals-sync check)."""
    from dbaf_tpu_torch.models.net import DroidNet
    from dbaf_tpu_torch.ops import corr_cuda as cc
    from dbaf_tpu_torch.utils import device as devmod

    n_scene = VISUAL_SCENE
    oracle = visual_oracle(dev)
    model = DroidNet(device=dev)
    model.load_state_dict(seeded_params(20260820))
    model.eval()

    def run_async(mode: str) -> dict:
        run = VisualRun(dev, visual_config(mode), model, oracle, n_scene)
        system = run.system
        a, fe = system._async, system.frontend
        cc.reset_launch_counts()
        k = 0
        t1_flip = None
        # warm: the pipeline active (visual: and one rollup inside it)
        while not (a.active and (mode != "visual" or a.rollups >= 1)):
            if k >= 90:
                raise SystemExit(f"visual_async {mode}: not warm after {k} frames")
            run.track(k)
            k += 1
        if mode == "gateonly":
            run.cfg.frontend.filter_thresh = 1e9  # the step reads it every frame
            t1_flip = k
        for _ in range(2 * a.drain_batch):  # settle
            run.track(k)
            k += 1
        k0 = k
        wall = 0.0
        reads0, drains0, steps0 = devmod.HOST_READS["count"], a.drains, fe.keyframe_steps
        mirror0 = a.t1_mirror
        guarded = 0
        for _ in range(N_MEASURED):
            torch.cuda.set_sync_debug_mode("error")
            t = time.perf_counter()
            try:
                run.track(k)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            wall += time.perf_counter() - t
            guarded += a.active
            k += 1
        res = dict(mode=mode, frames=k, measured=N_MEASURED, guarded=guarded,
                   frames_per_s=N_MEASURED / wall, timed_frames=(k0, k),
                   reads=devmod.HOST_READS["count"] - reads0, drains=a.drains - drains0,
                   mirror_moved=a.t1_mirror != mirror0)
        res["reads_per_frame"] = res["reads"] / N_MEASURED
        if mode == "visual":
            k1_0 = cc.LAUNCHES["corr_fused_xy"]
            prof = Profile()
            for _ in range(N_PROFILED):
                run.track(k)
                k += 1
            pr = prof.stop("visual_async", "profile_visual_async.txt")
            k1_ms = sum(ms for name, ms in pr["kernels"].items()
                        if "corr_fused_xy_kernel" in name)
            res.update(idle_share=pr["idle_share"], frames=k,
                       k1_ms_per_round=k1_ms / max(cc.LAUNCHES["corr_fused_xy"] - k1_0, 1))
        traj = system.terminate()  # drains the pipeline
        st = a.stats()
        res.update(launches=dict(cc.LAUNCHES), stats=st, t1=fe.t1, keyframe_steps=fe.keyframe_steps,
                   update_rounds=fe.update_rounds, rollups=fe.rollup_count, culls=fe.culls,
                   traj=traj, ii=np.asarray(system.graph.ii), jj=np.asarray(system.graph.jj),
                   poses=system.video.poses[:fe.t1].cpu().numpy(), t1_flip=t1_flip)
        return res

    def run_sync(n_frames: int, k0: int) -> dict:
        run = VisualRun(dev, visual_config("visual", async_on=False), model, oracle, n_scene)
        system, fe = run.system, run.system.frontend
        wall = 0.0
        for k in range(n_frames):
            t = time.perf_counter()
            run.track(k)
            if k0 <= k < k0 + N_MEASURED:
                torch.cuda.synchronize()
                wall += time.perf_counter() - t
        traj = system.terminate()
        return dict(traj=traj, ii=np.asarray(system.graph.ii), jj=np.asarray(system.graph.jj),
                    poses=system.video.poses[:fe.t1].cpu().numpy(), t1=fe.t1,
                    kf_per_s=N_MEASURED / wall)

    out = {}
    for mode in ("visual", "cull", "gateonly"):
        t = time.perf_counter()
        r = run_async(mode)
        n_frames = r["frames"]
        L = r["launches"]
        checks = [
            (r["guarded"] == N_MEASURED, "the pipeline drained in the measured frames"),
            (L["corr_lookup"] >= n_frames - 1,
             f"K2 launched {L['corr_lookup']} times for {n_frames - 1} gated frames"),
            (L["corr_fused_xy"] >= r["update_rounds"] > 0,
             f"K1 launched {L['corr_fused_xy']} times for {r['update_rounds']} admitted rounds"),
            (r["traj"].shape[0] > 0 and np.all(np.isfinite(r["traj"])),
             f"trajectory {r['traj'].shape} not finite"),
            (r["reads"] <= r["drains"],
             f"{r['reads']} blocking host reads for {r['drains']} drains"),
        ]
        if mode == "visual":
            checks.append((r["stats"]["rollups"] >= 1, "no rollup inside the pipeline"))
        if mode == "cull":  # every frame is admitted, every keyframe culls
            checks.append((r["stats"]["culls"] == r["stats"]["steps"],
                           f"{r['stats']['culls']} culls in {r['stats']['steps']} async steps"))
        if mode == "gateonly":  # every frame before the flip was admitted, none after
            checks.append((not r["mirror_moved"] and r["t1"] == r["t1_flip"],
                           f"t1 moved: {r['t1']} keyframes for {r['t1_flip']} frames before "
                           "the flip"))
        for ok, msg in checks:
            if not ok:
                raise SystemExit(f"visual_async {mode}: " + msg)
        if mode == "visual":
            # the oracle's targets make the two flows' rounds the same
            # arithmetic: they ran bit-equal on the card, so 1e-4 (the CPU
            # scenarios' bound) is room for nothing but a reordered sum
            s1 = run_sync(n_frames, r["timed_frames"][0])
            same = (r["t1"] == s1["t1"] and np.array_equal(r["traj"][:, 0], s1["traj"][:, 0])
                    and np.array_equal(r["ii"], s1["ii"]) and np.array_equal(r["jj"], s1["jj"]))
            diff = float(np.abs(r["poses"] - s1["poses"]).max()) if same else float("inf")
            log(f"[visual_async] async against sync: same keyframes and edges {same}, poses "
                f"{diff:.3e} apart, bound 1e-4; sync kf/s {s1['kf_per_s']:.3f} at the same "
                "frames")
            if not (same and diff <= 1e-4):
                raise SystemExit("visual_async: the asynchronous run differs from the synchronous")
            r.update(sync_kf_per_s=s1["kf_per_s"], pose_diff_to_sync=diff)
        st = r["stats"]
        log(f"[visual_async] {mode}: {r['frames_per_s']:.3f} frames/s over {N_MEASURED} frames "
            f"({'kf/s' if mode != 'gateonly' else 'all rejected'}), "
            f"{r['reads_per_frame']:.3f} blocking reads a frame ({r['reads']} in {r['drains']} "
            f"drains), {st['steps']} async steps, {st['culls']} culls, {st['rollups']} rollups, "
            f"{st['masked_rounds']} masked rounds, {st['wasted_rounds']} of them on rejected "
            f"frames or culled keyframes; launches {r['launches']}")
        log(f"[time] phase 7 {mode} took {time.perf_counter() - t:.1f} s")
        for key in ("traj", "ii", "jj", "poses"):
            r.pop(key)
        out[mode] = r
    out["buffer_moves"] = buffer_move_ms(dev)
    v = out["visual"]
    log(f"[visual_async] kf/s: visual {v['frames_per_s']:.3f} (sync at the same frames "
        f"{v['sync_kf_per_s']:.3f}; phase 3 {main_kfs:.3f}), cull "
        f"{out['cull']['frames_per_s']:.3f}; gateonly {out['gateonly']['frames_per_s']:.3f} "
        f"frames/s; K1 {v['k1_ms_per_round']:.4f} ms a round; idle share {v['idle_share']:.3f}")
    log("[visual_async] " + json.dumps(out, default=float))
    return out


def phase_int8(dev, main_res: dict, n_frames: int = 20) -> dict:
    """Phase 7b: phase 3's main path with cfg.graph.corr_int8 for about 12
    keyframe steps; K1-int8 (with its max pass) in every update round."""
    from dbaf_tpu_torch.ops import corr_cuda as cc
    from dbaf_tpu_torch.slam.system import DBAFusion
    from dbaf_tpu_torch.utils.config import tumvi_config

    cfg = tumvi_config()
    cfg.frontend.filter_thresh = -1.0
    cfg.graph.corr_int8 = True
    HT, WD = cfg.image_size
    system = DBAFusion(cfg, params=seeded_params(20260820), device=dev)
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, size=(HT + 64, WD + 64, 3)).astype(np.uint8)
    intr = np.asarray([460.0, 460.0, WD / 2, HT / 2], np.float32)
    cc.reset_launch_counts()
    for k in range(n_frames):
        ox, oy = (3 * k) % 64, (2 * k) % 64
        system.track(float(k), base[oy:oy + HT, ox:ox + WD], intrinsics=intr)
    traj = system.terminate()
    fe = system.frontend
    L = dict(cc.LAUNCHES)
    ref = main_res["traj"]
    common = [(i, np.nonzero(ref[:, 0] == t)[0]) for i, t in enumerate(traj[:, 0])]
    diff = max((float(np.abs(traj[i, 1:4] - ref[j[0], 1:4]).max()) for i, j in common if len(j)),
               default=float("nan"))
    log(f"[int8] {fe.keyframe_steps} keyframe steps, {fe.update_rounds} update rounds, launches "
        f"{L}; largest position difference from phase 3's bf16 rows at the same stamps "
        f"{diff:.4e}")
    if not (L["corr_fused_xy_int8"] == L["corr_int8_vmax"] >= fe.update_rounds > 0
            and L["corr_fused_xy"] == 0):
        raise SystemExit(f"int8: K1-int8 launched {L['corr_fused_xy_int8']} times for "
                         f"{fe.update_rounds} update rounds")
    if traj.shape[0] < 10 or not np.all(np.isfinite(traj)):
        raise SystemExit(f"int8: trajectory {traj.shape} too short or not finite")
    return dict(launches=L, pos_diff_to_bf16=diff)


N_EXPORT_VISUAL = 99  # phase 8 (a): phase 7's "visual" run, about four host rollups
EXPORT_SETTLE = 16    # phase 8 (a): frames before its clock starts


def phase_export(dev) -> dict:
    """Phase 8: save_pkl through runner.run at full width, its outputs in
    chiprun_out/.  (a) phase 7's "visual" configuration on the host-rollup
    route against the synchronous flow; (b) phase 6's configuration
    (roll-out archival) against phase 5's; (c) both exports read back, and
    the export's device step timed."""
    from dbaf_tpu_torch.apps import runner
    from dbaf_tpu_torch.eval import export as ex
    from dbaf_tpu_torch.eval.visualize import load_reconstruction
    from dbaf_tpu_torch.models.net import DroidNet
    from dbaf_tpu_torch.ops import corr_cuda as cc
    from dbaf_tpu_torch.utils import device as devmod

    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    launches = {k: 0 for k in cc.LAUNCHES}

    def drive(system, stream, tag, files):
        """runner.run with the kernels' counts of this run added to the
        phase's; ``files``: "pkl" writes the trajectory and both
        reconstructions, "traj" the trajectory only.  Returns runner.run's
        line."""
        cc.reset_launch_counts()
        paths = {}
        if files:
            paths["result_path"] = os.path.join(out_dir, f"export_{tag}.txt")
        if files == "pkl":
            paths["pkl_path"] = os.path.join(out_dir, f"export_{tag}.pkl")
        line = runner.run(system, stream, **paths)
        mine = dict(cc.LAUNCHES)
        for k, n in mine.items():
            launches[k] += n
        fe = system.frontend
        if mine["corr_lookup"] < line["frames"] - 1 or mine["corr_fused_xy"] < fe.update_rounds:
            raise SystemExit(f"export {tag}: K2 launched {mine['corr_lookup']} times for "
                             f"{line['frames']} frames, K1 {mine['corr_fused_xy']} times for "
                             f"{fe.update_rounds} update rounds")
        return line

    # ---- (a) the visual pipeline's host-rollup route
    model = DroidNet(device=dev)
    model.load_state_dict(seeded_params(20260820))
    model.eval()

    def visual(async_on: bool, oracle, tag: str, files) -> dict:
        cfg = visual_config("visual", async_on=async_on)
        cfg.save_pkl = True
        run = VisualRun(dev, cfg, model, oracle, VISUAL_SCENE)
        system = run.system
        fe, a = system.frontend, system._async
        clock = {}

        def stream():
            for k in range(N_EXPORT_VISUAL):
                if k == EXPORT_SETTLE:
                    torch.cuda.synchronize()
                    clock.update(t=time.perf_counter(), steps=fe.keyframe_steps,
                                 reads=devmod.HOST_READS["count"])
                yield run.frame(k)
            torch.cuda.synchronize()
            clock.update(wall=time.perf_counter() - clock["t"],
                         steps=fe.keyframe_steps - clock["steps"],
                         reads=devmod.HOST_READS["count"] - clock["reads"])

        line = drive(system, stream(), tag, files)
        n_timed = N_EXPORT_VISUAL - EXPORT_SETTLE
        return dict(line=line, system=system, export=system.video.export_rows(fe.t1),
                    kf_per_s=clock["steps"] / clock["wall"], reads_per_frame=clock["reads"] / n_timed,
                    host_rollups=a.host_rollups if a is not None else 0,
                    rollups=fe.rollup_count, archived=len(system.video.saved_tstamps),
                    drain_batch=a.drain_batch if a is not None else None)

    t = time.perf_counter()
    va = visual(True, visual_oracle(dev), "visual_async", "pkl")
    vs = visual(False, visual_oracle(dev), "visual_sync", "traj")
    vp = visual(False, visual_oracle(dev, perturb=1e-6), "visual_sync_perturbed", None)
    (st_a, po_a, di_a, _), (st_s, po_s, di_s, _) = va["export"], vs["export"]
    same = st_a.shape == st_s.shape and np.array_equal(st_a, st_s)
    pose_diff = float(np.abs(po_a - po_s).max()) if same else float("inf")
    disp_diff = float(np.abs(di_a - di_s).max()) if same else float("inf")
    spread = float(np.abs(vp["export"][2] - di_s).max()) if vp["export"][2].shape == di_s.shape \
        else float("inf")
    disp_bound = max(1e-4, 10.0 * spread)
    res_a = dict(frames=N_EXPORT_VISUAL, kf_per_s=va["kf_per_s"], sync_kf_per_s=vs["kf_per_s"],
                 reads_per_frame=va["reads_per_frame"], sync_reads_per_frame=vs["reads_per_frame"],
                 host_rollups=va["host_rollups"], rollups=va["rollups"],
                 sync_rollups=vs["rollups"], drain_batch=va["drain_batch"],
                 archived=va["archived"], sync_archived=vs["archived"], exported=len(st_a),
                 same_stamps=bool(same), pose_diff=pose_diff, disp_diff=disp_diff,
                 sync_spread_1e6=spread, disp_bound=disp_bound)
    log("[export] (a) " + json.dumps(res_a))
    checks = [
        (va["host_rollups"] >= 2, f"only {va['host_rollups']} host rollups"),
        (va["system"]._async.rollups == 0, "the step rolled under save_pkl"),
        (va["archived"] > 0, "nothing archived"),
        (same, "the archived and live stamps differ from the synchronous flow's"),
        (len(np.unique(st_a)) == len(st_a) and bool(np.all(np.diff(st_a) > 0)),
         "a keyframe is exported twice or out of order"),
        (pose_diff <= 1e-4, f"poses {pose_diff} apart (bound 1e-4)"),
        (disp_diff <= disp_bound, f"disparities {disp_diff} apart (bound {disp_bound})"),
    ]
    for ok, msg in checks:
        if not ok:
            raise SystemExit("export (a) visual: " + msg)
    log(f"[export] (a) visual pipeline with save_pkl: {va['kf_per_s']:.3f} kf/s (synchronous "
        f"flow {vs['kf_per_s']:.3f}) over frames {EXPORT_SETTLE}-{N_EXPORT_VISUAL - 1}, "
        f"{va['reads_per_frame']:.3f} blocking reads a frame, {va['host_rollups']} host rollups "
        f"(drain and re-activate), {va['archived']} keyframes archived, {len(st_a)} exported; "
        f"poses {pose_diff:.3e} and disparities {disp_diff:.3e} from the synchronous flow's")
    log(f"[time] phase 8 (a) took {time.perf_counter() - t:.1f} s")

    # ---- (b) the coupled pipeline's roll-out archival
    t = time.perf_counter()

    def coupled(async_on: bool, tag: str, files) -> dict:
        cfg = coupled_config(coupled_async=async_on)
        cfg.save_pkl = True
        run = CoupledRun(dev, cfg, N_COUPLED)
        system = run.system
        fe, g = system.frontend, system.graph
        drains = []  # (frame, a bias reinitialization's) of each drain of the pipeline

        def stream():
            for k, item in zip(range(N_COUPLED), run.stream(range(N_COUPLED), devmod.upload)):
                ca = fe._casync
                active = ca is not None and ca.active
                reinit = g.coupled is not None and k / run.fps - g.coupled.vi_init_time > 5.0
                yield item
                if active and not fe._casync.active:
                    drains.append((k, bool(reinit)))

        line = drive(system, stream(), tag, files)
        return dict(line=line, system=system, export=system.video.export_rows(fe.t1),
                    drains=drains, archived=len(system.video.saved_tstamps),
                    rollups=fe.rollup_count)

    ca_run = coupled(True, "coupled_async", "pkl")
    cs_run = coupled(False, "coupled_sync", "traj")
    ca = ca_run["system"].frontend._casync
    (st_a, po_a, di_a, _), (st_s, po_s, di_s, _) = ca_run["export"], cs_run["export"]
    same = st_a.shape == st_s.shape and np.array_equal(st_a, st_s)
    pos_diff = float(np.abs(po_a[:, :3] - po_s[:, :3]).max()) if same else float("inf")
    disp_diff = float(np.abs(di_a - di_s).max()) if same else float("inf")
    res_b = dict(frames=N_COUPLED, async_steps=ca.total_steps, steps_since_activation=ca.steps,
                 culls=ca.culls, rollups_in_pipeline=ca.rollups, rollups=ca_run["rollups"],
                 sync_rollups=cs_run["rollups"], drains=ca_run["drains"],
                 archived=ca_run["archived"], sync_archived=cs_run["archived"],
                 exported=len(st_a), same_stamps=bool(same), pos_diff=pos_diff,
                 disp_diff=disp_diff, pending_archive=len(ca._pending_archive))
    log("[export] (b) " + json.dumps(res_b))
    checks = [
        (same, "the archived and live stamps differ from the synchronous flow's"),
        (len(np.unique(st_a)) == len(st_a) and bool(np.all(np.diff(st_a) > 0)),
         "a keyframe is exported twice or out of order"),
        (pos_diff <= 5e-2, f"positions {pos_diff} m apart (bound 5e-2)"),
        (disp_diff <= 2e-2, f"disparities {disp_diff} apart (bound 2e-2)"),
        # steps == total_steps but for the bias reinitialization's drain
        (all(reinit for _, reinit in ca_run["drains"]),
         f"the pipeline drained outside a bias reinitialization: {ca_run['drains']}"),
        (not ca._pending_archive, f"{len(ca._pending_archive)} archives left pending"),
        (ca.rollups >= 1, "no rollup inside the pipeline"),
        (ca_run["archived"] > 0, "nothing archived"),
    ]
    for ok, msg in checks:
        if not ok:
            raise SystemExit("export (b) coupled: " + msg)
    log(f"[export] (b) coupled pipeline with save_pkl: {ca.total_steps} async steps, "
        f"{ca.rollups} rollups inside it, drains {ca_run['drains']} (frame, bias reinit), "
        f"{ca_run['archived']} keyframes archived, {len(st_a)} exported; positions "
        f"{pos_diff:.3e} m and disparities {disp_diff:.3e} from the synchronous flow's")
    log(f"[time] phase 8 (b) took {time.perf_counter() - t:.1f} s")

    # ---- (c) both exports, read back; the export's device step timed
    res_c = {}
    for tag, r in (("visual_async", va), ("coupled_async", ca_run)):
        stamps = r["export"][0]
        for suffix in ("", "_raw"):
            recon = load_reconstruction(os.path.join(out_dir, f"export_{tag}{suffix}.pkl"))
            counts = [len(e["pts"]) for e in recon["points"].values()]
            ok = (len(counts) == len(recon["cameras"]) == len(stamps)
                  and np.array_equal(list(recon["stamps"].values()), stamps)
                  and all(np.all(np.isfinite(e["pts"])) for e in recon["points"].values()))
            log(f"[export] (c) {tag}{suffix}.pkl: {len(counts)} point blocks for "
                f"{len(stamps)} exported keyframes ({r['archived']} archived), points per "
                f"block {counts}")
            if not ok:
                raise SystemExit(f"export (c): {tag}{suffix}.pkl does not hold one finite point "
                                 "block per exported keyframe")
            res_c[tag + suffix] = sum(counts)
    _, poses, disps, _ = va["export"]
    N = len(poses)
    intr = va["system"].video.intrinsics
    p_dev = torch.as_tensor(poses, device=dev)
    d_dev = torch.as_tensor(disps, device=dev)
    th = torch.full((N,), 0.1, device=dev)
    ms = cuda_ms(lambda: ex._points_and_counts(p_dev, d_dev, intr, th), 10)
    log(f"[export] (c) _points_and_counts at N={N} keyframes of {disps.shape[1]}x{disps.shape[2]}: "
        f"{ms:.3f} ms (its device -> host read included)")
    return dict(visual=res_a, coupled=res_b, points=res_c, points_and_counts_ms=ms,
                points_and_counts_n=N, launches=launches)



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
    t = time.perf_counter()
    main_res = phase_main(dev, N_FRAMES)
    phase_check(dev)
    log(f"[time] phases 3-4 took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    coupled_res = phase_coupled(dev, N_COUPLED)
    log(f"[time] phase 5 (coupled) took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    async_res = phase_coupled_async(dev, N_COUPLED, coupled_res)
    log(f"[time] phase 6 (coupled_async) took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    visual_res = phase_visual_async(dev, main_res["kf_per_s"])
    log(f"[time] phase 7 (visual_async) took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    int8_res = phase_int8(dev, main_res)
    log(f"[time] phase 7b (int8) took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    export_res = phase_export(dev)
    log(f"[time] phase 8 (export) took {time.perf_counter() - t:.1f} s")
    visual_launches = {name: sum(visual_res[m]["launches"][name]
                                 for m in ("visual", "cull", "gateonly"))
                       for name in int8_res["launches"]}
    paths = {"main": main_res["launches"], "coupled": coupled_res["launches"],
             "coupled_async": async_res["launches"], "visual_async": visual_launches,
             "int8": int8_res["launches"], "export": export_res["launches"]}

    src = "dbaf_tpu_torch/csrc/"
    kernels = [
        dict(name="corr_fused_xy", route="cuda", source=src + "corr_fused_xy.cu",
             replaces="dbaf_tpu/ops/corr_pallas.py:206", row=rows["corr_fused_xy"]),
        dict(name="corr_fused_xy_int8", route="cuda", source=src + "corr_fused_xy.cu",
             replaces="dbaf_tpu/ops/corr_pallas.py:249", row=rows["corr_fused_xy_int8"]),
        dict(name="corr_int8_vmax", route="cuda", source=src + "corr_fused_xy.cu",
             replaces="dbaf_tpu/ops/corr_pallas.py:250", row=rows["corr_int8_vmax"]),
        dict(name="corr_fused_xy_raw", route="cuda", source=src + "corr_fused_xy.cu",
             replaces="dbaf_tpu/ops/corr_pallas.py:515", row=rows["corr_fused_xy_raw"]),
        dict(name="corr_lookup", route="cuda", source=src + "corr_lookup.cu",
             replaces="dbaf_tpu/ops/corr_pallas.py:58", row=rows["corr_lookup"]),
    ]
    out = []
    for k in kernels:
        r = k.pop("row")
        by_path = {p: n[k["name"]] for p, n in paths.items()}
        out.append(dict(k, launches=sum(by_path.values()), max_abs_err=r["max_abs_err"],
                        ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                        bound_by=r["bound_by"], library_ms=None, launches_by_path=by_path))
    log(f"[main] {main_res['kf_per_s']:.3f} kf/s on {card}")
    log(f"[coupled] {coupled_res['kf_per_s']:.3f} kf/s after VI init on {card}")
    log(f"[coupled_async] {async_res['kf_per_s']:.3f} kf/s over the async steps on {card}")
    log(f"[visual_async] visual {visual_res['visual']['frames_per_s']:.3f} kf/s, cull "
        f"{visual_res['cull']['frames_per_s']:.3f} kf/s, gateonly "
        f"{visual_res['gateonly']['frames_per_s']:.3f} frames/s on {card}")
    print(card, flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
