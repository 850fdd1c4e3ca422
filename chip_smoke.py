"""Chip smoke test of the PyTorch/CUDA port (dbaf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--root DIR] [--kernels-only | --demos-only]

``--root`` names the directory that holds the ``dbaf_tpu_torch`` package to
drive (default: this checkout); ``--kernels-only`` stops after phase 2;
``--demos-only`` runs phase 11 alone after the build.  With
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
             cfg.graph.corr_int8: fatal unless K1-int8 runs once in every
             round and no other correlation build does (no max pass of its
             own), and the trajectory is finite;
             prints the largest position difference from phase 3's bf16
             rows at the same stamps.
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
  9a. train_parity  one make_train_step step of the f32 network (weights
             from seed 0 as the JAX module draws them, the delta head
             scaled by 0.01), 4 frames at 96x128, num_steps 2, on the card
             and on the CPU: the loss, each leaf's gradient and the updated
             parameters within the TRAIN_* bounds (their comment says why).
  9b. train  make_train_step at full width: 7 of phase 3's 384x512 frames,
             ground truth from eval/synthetic.scene_from_poses, the 22
             edges |i-j| in {1, 2}, num_steps 12, fixedp 2, DroidNet() in
             bf16, make_optimizer() at its defaults; one warm-up step and
             five timed ones: seconds a step, peak memory, each loss.
             Fatal unless everything stays finite, the parameters move and
             no correlation kernel launches (the unroll runs the plain
             lookup).  Then tests/test_train.py:172's objective-decrease
             scenario on the card (deterministic algorithms), fatal unless
             min(hist[4:]) < 0.85 hist[0].
  9c. upsample  phase 3's main path with cfg.upsample for 12 keyframe
             steps: K2 on every gated frame and K1 in every round, a finite
             disps_up and GraphAgg's damping for every frame with an edge,
             and GraphAgg and cvx_upsample on the card against the f32 CPU
             versions at the last keyframe's inputs; prints kf/s beside
             phase 3's (that of a second run on the same frames, whose
             convolution plans the first run built) and the ms of one
             run_upsample.
  10a. stereo  phase 3's main path with cfg.stereo for 12 keyframe steps
             (after the same frames without stereo, for a kf/s on built
             convolution plans), each frame's right image cut from the
             same texture 4 pixels to the side: K2 on every gated frame, K1 in every round,
             self-edges in every keyframe step's edge set, a finite
             trajectory, and K1 on one round's stereo operands against
             its plain version (one bf16 ulp of the largest output, and
             at least phase 2's bound), whose self-edges must
             differ from left-only operands; kf/s beside phase 3's.
  10b. oracle  phase 7's oracle scene at full width on the synchronous
             flow (the scene's camera), once with stereo and once with
             RGB-D (the scene's depth at pixels [3::8, 3::8]): fatal
             unless self-edges exist and the poses are finite (stereo) and
             the median disparity ratio to the truth lies in 0.9-1.1
             (RGB-D); prints the SE3- and Sim3-aligned ATE and the scale.
  10c. resume  phase 3's main path saved before frame 12 and run to 16; a
             fresh system loads the file and runs 12-16 again: loaded poses
             within 1e-6, resumed ones within 1e-4 of the first run (or
             twice the spread of two uninterrupted runs where larger); the
             file unpickled in a child process that sees no card, without
             importing torch.
  11. demos  each dataset demo (apps/demo_tumvi, demo_kitti360, demo_whu,
             demo_subt) built by its own parse_args and setup from the argv a
             user passes, at its preset's full width (TUM-VI and SubT
             384x512, KITTI-360 272x1032, WHU 320x640) and sensor defaults
             (device_solver False: the host f64 LM on the two-call flow), on
             sensor files written under chiprun_out/demos/ in the dataset's
             own layout and units (DemoScene: eval/synthetic's motion, the
             body turned by the demo's extrinsic; WHU with
             tests/test_georef.py's 12 m/s drift, GNSS, odometry and ZUPT)
             and the seeded weights as a .pth; the update rounds take the
             scene's oracle, the motion gate the network (filter_thresh -1
             where the preset's gate admits too few of the first frames,
             said on the line); procedural frames at the preset's size fed
             through apps/runner.run, which writes the result file (and the
             .pkl of SubT's --save_pkl).  Fatal unless every pose is finite,
             ATE is under 0.08 x span and every |bias| under 0.2, K1 runs
             in every round at the preset's grid and K2 on every gated
             frame, all_stamp adds rows (TUM-VI, WHU), and on WHU
             init_gnss fires and the ECEF rows hold tests/test_georef.py's
             bounds; K1 on the operands of the KITTI-360 run's last round at
             E=48 and 34x129 (K1's wide path, whole-block pooling)
             against its plain version (2^-7 of the largest output), and
             its ms beside its bound.  One JSON line a demo (profile tables
             in chiprun_out/profile_demo_*.txt).
  12. multi-device  the parallel layer (dbaf_tpu_torch/parallel) with its
             ranks spawned from this script on cuda:0 (NCCL takes no two
             ranks on one card, so RANKS = 2 ranks use gloo, whose
             collectives go through the host; no scaling number can be
             taken on one card).  Single-process references run first in
             this process.  12a: sharded_ba_step on 2 ranks, each with half
             of the 170 edges of bench.py's coupled window (P = 44, 48x64),
             in f64, against one process's dba.ba in f64, within
             tests/test_parallel.py's 2e-5 (poses) and 2e-4 (disps); ms a
             sharded f32 iteration beside ms a single-process one;
             sharded_feature_step, each rank extracting 2 of 4 of phase
             3's frames, bit-equal to one
             process on the same two-frame batches.  12b: a world of one over
             NCCL runs the same step and dist_worker's CLI.  12c:
             make_train_step on a dp 2 x edge 1 mesh, one tuple a rank, at
             phase 9b's width, against one process's B = 2 step, and on a
             dp 1 x edge 2 mesh at phase 9a's f32 shape: loss, gradients
             and updated parameters within SPREAD_FACTOR times the spread
             of two single-process steps, the second on images moved by
             TRAIN_EPS (with floors, see SPREAD_FACTOR); the dp step also
             by phase 9a's parity bounds, which the same step with its
             gradients not summed over dp (a planted fault) must fail;
             s/step and peak memory per rank, held under 1.05 x phase 9b's
             peak in this run.  12d: phase 3's path (30 frames) and phase
             6's configuration (36 frames: VI init, >= 10 async steps)
             with cfg.shard_video on 2 ranks, against one process with the
             flag (a world of one: no sharding, the same numerics; the
             flag turns on deterministic algorithms on the card, and every
             rank takes its host decisions from rank 0's reads): poses
             (body positions) and disparities within the larger of the
             spread of two single runs and tests/test_shard_video.py's
             1e-5 / 1e-4, and the ranks' distance from each other; each
             rank holds half of fmaps+nets+inps; kf/s with the gloo staging; K1 and K2
             launches of both ranks.  Any failed rank fails the phase.
  13. multisensor  the multi-sensor flagship on phase 6's configuration
             (the device factor graph, the fused step; the synchronous flow,
             then the asynchronous pipeline on the same frames), full width.
             13a: tests/test_georef.py's scene (52 frames, a 12 m/s drift,
             GNSS at every frame as ECEF rows of a yawed, offset ENU frame,
             ten0 the first fix, body-frame odometry; phase 11's WHU
             camera): fatal unless init_gnss fires, the pipeline waits for
             it and reactivates after it (>= 5 async steps), the live
             window's georeferenced positions hold tests/test_georef.py's
             bounds on both flows, ECEF rows are written, and the async run
             has the sync run's keyframe stamps, solved positions and
             trajectory rows within 2e-2 m with <= 3 blocking reads a step.
             13b: tests/test_zupt.py's stop-and-go (100 frames, the plateau
             admitted at its sparse cadence, 64 feeds; its camera; ZUPT on
             with its 0.12 m/s gate, its 0.2 m hysteresis, its cull
             threshold scaled to this grid): fatal unless, as
             tests/test_zupt.py:279 and :317 hold, the plateau culls, ZUPT
             fires at least 3 times between T_STOP + 3 s and T_RESUME +
             TAU, the plateau's trajectory rows (aligned from VI init) stay
             within 0.10 m of the stop point, the ATE of both runs is under
             0.08 x span, and the async run (>= 10 steps, >= 6 culls inside
             it) has the sync run's keyframes, ZUPT fires within 2 of the
             sync run's and its first fire within two frames of theirs.
             The test's async-against-sync positions (5e-2 m) and ATE rule
             are printed, not held: at this BA window of 44 the JAX package
             misses both (tests/test_torch_async_zupt_window44.py).  Every async
             steady-state frame runs under sync-debug "error".  Then K1 and
             K2 on the operands of 13a's async run's last launches against
             their plain versions (2^-7 and 1e-6 of the largest output),
             with their ms and bounds.  Prints kf/s after VI init, host
             reads (sync) or blocking reads (async) and LM passes a
             keyframe, ZUPT fires, the GNSS init frame and the ATE share of
             each run; the idle share of each run's last frame under
             torch.profiler (tables in chiprun_out/profile_multisensor_*).
Phase 2 also holds K1-int8 (one launch, its tile scales inside it) at
(E=48, 48x64, C=128, tile 256), at tiles of 128, 192 and 768 pixels, off
the image and with a NaN row, and its returned scales, against their plain
versions; and K1-raw (raw=True, the whole
32x32 block per pixel) at (E=48, 48x64, C=128), off the image and with a
NaN row: within one bf16 ulp of its largest output, rows and columns
28-31 exactly 0, its diagonal blocks against K1 on the same inputs, and
its output through the full network's update operator against the
196-channel route (delta and weight within 4 bf16 ulps of their largest
value).
Phase 2 also holds fg_linearize, the factor graph's linearize as one
kernel, against linearize_plain at NW = 20 (4 pose and 4 bias prior slots,
GNSS, odometry, a marginal) on tests/lm_windows.py's settled window, as the
LM calls it and as the device marginalization does, at
tests/test_torch_linearize_cuda.py's per-entry tolerances (H, b and err);
prints its ms (graph replay; the eager launches' beside), the plain
version's (eager and as a graph replay) and the bound's.
Phase 2 prints a digest of every case's kernel output ("[digest]" lines):
with --root, two packages' digests show whether a kernel's outputs changed.
Then one JSON line listing the kernels (launches summed over the main,
coupled, coupled_async, visual_async, int8, export, upsample, stereo,
oracle_stereo, oracle_rgbd, resume, the four demo paths, phase 12d's
sharded_main and sharded_coupled_async (both ranks' launches) and phase
13's multisensor_sync and multisensor_async (13a and 13b), each counted
from 0 just before its run; "launches_by_path" splits them).  fg_linearize
is counted over phases 5, 6 and 13 (coupled, coupled_async,
multisensor_sync, multisensor_async), from 0 just before each run: its
launches are the wrapper's calls (each eager linearize of the device
marginalization and each capture of an LM graph; a graph replay calls no
wrapper), and "lm_kernel_linearized_by_path" gives the launched LM
iterations whose linearize was the kernel, of all launched; those phases
are fatal unless LM iterations ran and every one's linearize was the
kernel.  Last the ok line.

Exits non-zero without a CUDA device, and without the port's package.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np

# deterministic cuBLAS for the phase that turns on deterministic algorithms
# (phase 9b's objective-decrease run); set before torch creates a handle
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

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


def digest(t: torch.Tensor) -> str:
    """sha1 of a tensor's bytes, shape and dtype: equal digests, equal outputs."""
    import hashlib

    h = hashlib.sha1(f"{tuple(t.shape)} {t.dtype}".encode())
    h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def bound(bytes_moved: float, op_seconds: float):
    t_bytes = bytes_moved / PEAK_BYTES
    if op_seconds > t_bytes:
        return op_seconds * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def fg_reset() -> tuple:
    """Zero the factor graph's hand-kernel launch count; the LM counters'
    marks for :func:`fg_launches`."""
    from dbaf_tpu_torch.fusion import device_graph as dg
    from dbaf_tpu_torch.utils.profiling import TRACER

    if hasattr(dg, "LAUNCHES"):
        dg.LAUNCHES["fg_linearize"] = 0
    return TRACER.lm_launched, getattr(TRACER, "lm_kernel_linearized", 0)


def fg_launches(mark: tuple) -> dict:
    """Since :func:`fg_reset`: the hand kernel's launches (its wrapper's
    calls: each eager ``linearize`` and each capture of an LM graph that
    holds one; a replay calls no wrapper), the LM iterations launched, and
    of those the ones whose ``linearize`` was the kernel.  Empty for a
    package without the kernel."""
    from dbaf_tpu_torch.fusion import device_graph as dg
    from dbaf_tpu_torch.utils.profiling import TRACER

    if not hasattr(dg, "LAUNCHES"):
        return {}
    return dict(fg_linearize=dg.LAUNCHES["fg_linearize"], lm_launched=TRACER.lm_launched - mark[0],
                lm_kernel_linearized=TRACER.lm_kernel_linearized - mark[1])


def fg_checks(tag: str, launches: dict) -> list:
    """(condition, message) pairs: LM iterations launched, and every one's
    ``linearize`` was the kernel (the launch count alone can stay 0 where
    an earlier phase captured the graphs and no window advanced)."""
    if "fg_linearize" not in launches:
        return []
    n, k = launches["lm_launched"], launches["lm_kernel_linearized"]
    return [(k == n > 0, f"{tag}: {k} of {n} launched LM iterations ran fg_linearize")]


def phase_fg_linearize(dev) -> dict:
    """Phase 2's factor-graph case: ``linearize`` (csrc/fg_linearize.cu) at
    NW = 20 (the cells' sensors.fg_cap) with 4 pose and 4 bias prior slots,
    GNSS, odometry and a marginal, on tests/lm_windows.py's window settled as
    a phase-5 pass finds its later iterations (positions tens of metres out,
    every term's gradient cancelling to a small b), as the LM calls it and as
    the device marginalization does (hold_empty off, the masks cut to two
    frames), each against ``linearize_plain`` on the same inputs at the card
    test's per-entry tolerance; then its ms (graph replay; eager launches
    beside), the plain version's (eager, and a graph replay) and the bound's.
    None for a package without the kernel."""
    from dbaf_tpu_torch.fusion import device_graph as dg

    if not hasattr(dg, "linearize_plain"):
        log("[kernels] fg_linearize: this package has no hand kernel for linearize")
        return None
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from lm_windows import cut_masks, settled_inputs, tolerance_ratios

    st, pg, vH, vv, lR, lt, mgd = settled_inputs(20, 14, 3, gnss=True, device=dev)
    worst = dict(H=0.0, b=0.0, err=0.0)
    max_abs = 0.0
    for label, args, hold in (
            ("LM", (st, pg, vH, vv, lR, lt, mgd), True),
            ("marginalization", (st, cut_masks(pg, 2), vH, vv, st.R, st.t, mgd), False)):
        kernel, plain = dg.linearize(*args, hold), dg.linearize_plain(*args, hold)
        ratios = tolerance_ratios(kernel, plain, args)
        worst = {k: max(v, ratios[k]) for k, v in worst.items()}
        max_abs = max(max_abs, float((kernel[0].double() - plain[0].double()).abs().max()))
        log(f"[kernels] fg_linearize NW=20 ({label}): H, b and err at "
            f"{ratios['H']:.4f}, {ratios['b']:.4f} and {ratios['err']:.4f} of their bounds")
        if not max(ratios.values()) <= 1.0:  # nan: a non-finite entry
            raise SystemExit(f"fg_linearize ({label}) disagrees with its plain version: {ratios}")
    args = (st, pg, vH, vv, lR, lt, mgd)
    kernel = lambda: dg.linearize(*args)  # noqa: E731
    plain = lambda: dg.linearize_plain(*args)  # noqa: E731
    ms, eager_ms = graph_ms(kernel, 50), cuda_ms(kernel, 50)
    plain_ms, plain_graph_ms = cuda_ms(plain, 10, warmup=1), graph_ms(plain, 5)
    N, NW = 15 * 20, 20
    ins = [x for x in (*st, *pg, vH, vv, lR, lt, *mgd) if isinstance(x, torch.Tensor)]
    nbytes = sum(x.numel() * x.element_size() for x in ins) + 4 * (N * N + N + 1 + NW)
    # the marginal's and visual system's products, H's additions, and each
    # band's two IMU factors' J^T L and J^T L J rows
    ops = 2 * N * N + 2 * (6 * NW) ** 2 + N * N + NW * 2 * (2 * 15 ** 3 + 2 * 15 * 30 * 15)
    bms, by = bound(nbytes, ops / PEAK_F32)
    row = dict(case="fg_linearize NW=20", max_abs_err=max_abs, tol_ratio=worst, ms=ms,
               eager_ms=eager_ms, plain_ms=plain_ms, plain_graph_ms=plain_graph_ms,
               bound_ms=bms, bound_by=by)
    log("[kernels] " + json.dumps(row))
    log(f"[rate] fg_linearize: {nbytes / (ms * 1e-3) / 1e12:.4f} TB/s, share of bound "
        f"{bms / ms:.4f} (bound by {by}; latency bounds it)")
    return row


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
        log(f"[digest] {name}: {digest(out)}")
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
        """K1-int8 (one launch) against its plain version, by
        corr_cuda.int8_agreement: at most INT8_OFF_SHARE of the outputs
        more than one bf16 ulp apart (an f32 sum in another order flips the
        rounding of a quantized entry only near a half step), each within
        one int8 quantum of its tile's scale per tap, vmax * 1.07 / 127,
        plus one bf16 ulp of P2 (2^-7 vmax) and of the output (2^-7 |out|).
        The control: K1 (bf16, no quantization) on the same inputs must
        fail the check, unless every output is 0 (off the image).  Its
        tile scales against corr_int8_vmax_plain at rtol 1e-4 (a package
        from before the one-launch design returns none)."""
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
            if "return_vmax" in inspect.signature(cc.corr_fused_xy_int8).parameters:
                _, scales = cc.corr_fused_xy_int8(f1p, f2p, coords, H, W, tile, return_vmax=True)
                s_err = float(((scales - vmax).abs() / vmax).max())
                log(f"[kernels] {name}: tile scales against the plain max, largest relative "
                    f"error {s_err} (bound 1e-4)")
                if not s_err <= 1e-4:
                    raise SystemExit(f"{name}: a tile's scale is off by {s_err}")
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
            # the build's flops once, as for K1 (this design builds it twice)
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
            # the build once, as for K1
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
        "corr_fused_xy_int8": int8_case("K1-int8 E=48 48x64 C=128 tile 256", 48, 48, 64, 128,
                                        256),
        "corr_fused_xy_int8_tile128": int8_case("K1-int8 E=8 32x60 C=128 tile 128", 8, 32, 60,
                                                128, 128, iters=20),
        # tiles of 3 and 12 blocks (corr_group 12 and 48)
        "corr_fused_xy_int8_tile192": int8_case("K1-int8 E=8 48x64 C=128 tile 192", 8, 48, 64,
                                                128, 192, iters=20),
        "corr_fused_xy_int8_tile768": int8_case("K1-int8 E=8 48x64 C=128 tile 768", 8, 48, 64,
                                                128, 768, iters=20),
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
        "fg_linearize": phase_fg_linearize(dev),
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

    def stop(self, tag: str, table_name: str, frames: int = N_PROFILED) -> dict:
        torch.cuda.synchronize()
        wall = (time.perf_counter() - self.t0) * 1e3
        self.prof.__exit__(None, None, None)
        events = self.prof.key_averages()
        kernels = {e.key: e.self_device_time_total / 1e3 for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation}
        busy = sum(kernels.values())
        idle = 1.0 - busy / wall
        log(f"[{tag}] profile of the last {frames} frame(s): device busy {busy:.3f} ms of "
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
    system = DBAFusion(cfg, params=seeded_params(20260820), device=dev)
    frame, intr = main_frames(cfg)

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

    def __init__(self, dev, cfg, n_frames: int, scene=None, sensors=None):
        """``scene``: (IMU rows, {frame: (R, p)}, focal over the feature
        grid's width, plane depth), by default eval/synthetic's motion seen
        by a camera of focal 2 at 4 m; ``sensors``: set_multisensor's GNSS
        and odometry keywords."""
        from dbaf_tpu_torch.eval.synthetic import (make_oracle, scene_from_poses,
                                                   simulate_imu_and_poses)
        from dbaf_tpu_torch.models.net import DroidNet
        from dbaf_tpu_torch.slam.system import DBAFusion

        self.dev, self.cfg, self.fps = dev, cfg, COUPLED_FPS
        HT, WD = self.image_size = cfg.image_size
        H8, W8 = cfg.feat_size
        if scene is None:
            scene = simulate_imu_and_poses(n_frames / self.fps + 0.5, fps=self.fps) + (2.0, 4.0)
        imu_rows, self.poses_at, focal, z0 = scene
        self.intr8 = np.asarray([focal * W8, focal * W8, W8 / 2, H8 / 2], np.float32)
        gt_cw, gt_disps = scene_from_poses(self.poses_at, n_frames, self.intr8, H8, W8, z0=z0)
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
        self.system.set_multisensor(imu_rows, np.eye(4), imu_noise=[0.05, 0.005, 1e-4, 1e-6],
                                    **(sensors or {}))
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
    fg0 = fg_reset()
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
    launches = {**cc.LAUNCHES, **fg_launches(fg0)}
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
    for ok, msg in fg_checks("coupled", launches):
        if not ok:
            raise SystemExit(msg)
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
    fg0 = fg_reset()
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
    launches = {**cc.LAUNCHES, **fg_launches(fg0)}
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
        *fg_checks("coupled_async", launches),
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

    def track(self, k: int, **sensors) -> None:
        t, image, intr = self.frame(k)
        self.system.track(t, image, intrinsics=intr, **sensors)

    def right(self, k: int):
        """The right camera's frame k: the same texture, STEREO_SHIFT
        pixels to the side."""
        HT, WD = self.cfg.image_size
        ox, oy = right_offset((3 * k) % 64, STEREO_SHIFT), (2 * k) % 64
        return self.base[oy:oy + HT, ox:ox + WD]


VISUAL_SCENE = 128  # frames of the visual phases' synthetic scene


def visual_scene():
    """The synthetic scene of the visual phases at tumvi_config()'s feature
    grid: (world->camera poses, disparities at 1/8 resolution, intrinsics
    at 1/8 resolution)."""
    from dbaf_tpu_torch.eval.synthetic import scene_from_poses, simulate_imu_and_poses

    H8, W8 = visual_config("visual").feat_size
    _, poses_at = simulate_imu_and_poses(VISUAL_SCENE / 10.0 + 0.5, fps=10.0)
    intr8 = np.asarray([2.0 * W8, 2.0 * W8, W8 / 2, H8 / 2], np.float32)
    gt_cw, gt_disps = scene_from_poses(poses_at, VISUAL_SCENE, intr8, H8, W8)
    return gt_cw, gt_disps, intr8


def visual_oracle(dev, perturb: float = 0.0):
    """The synthetic-scene oracle of the visual phases; ``perturb`` moves
    the scene's disparities by that much (relative, seeded noise)."""
    from dbaf_tpu_torch.eval.synthetic import make_oracle

    gt_cw, gt_disps, intr8 = visual_scene()
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
    keyframe steps; one K1-int8 launch in every update round and no other
    correlation build (no max pass of its own)."""
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
    # one K1-int8 launch a round and no other correlation build: no max pass
    # of its own, no bf16 or raw round
    if not (L["corr_fused_xy_int8"] == fe.update_rounds > 0 and L["corr_fused_xy"] == 0
            and L["corr_fused_xy_raw"] == 0):
        raise SystemExit(f"int8: K1-int8 launched {L['corr_fused_xy_int8']} times for "
                         f"{fe.update_rounds} update rounds; launches {L}")
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



# phase 9a: parity bounds of one training step, card against CPU (the same
# port, f32).  The weights are drawn as the JAX module initializes them
# (DroidNet.init_weights), the delta head scaled by 0.01, as in
# tests/test_torch_train_unroll.py: with the seeded checkpoint weights the
# update proposes flows of many pixels, the unroll's gradients are
# ill-conditioned and GradientClip's 0.01 threshold flips entries, so on the
# CPU alone they move by percents when the images move by 1e-4 intensity
# levels, far past TRAIN_GRAD_TOL; train_spread measures and the phase
# prints that spread at both weight sets, beside the card's difference.  The
# biases ahead of fnet's instance norms have a zero gradient, which each
# device gives as rounding noise: held to TRAIN_NOISE_TOL of the largest
# leaf's norm.  AdamW's first step moves an entry by lr g / (|g| + 1e-8),
# about lr times the sign of its gradient: an entry whose gradient the two
# devices give more than 1% apart (one near zero, at the devices' noise) may
# move by any amount up to lr either way, so those entries are held to
# 2 lr and to TRAIN_NOISY_SHARE of all.
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL, TRAIN_NOISE_TOL, TRAIN_PARAM_ATOL = 1e-4, 1e-3, 2e-3, 1e-5
TRAIN_NOISY_SHARE = 5e-2


def tiny_train_batch(dev, seed: int, n: int = 4, h8: int = 6, w8: int = 8) -> dict:
    """One covisible tuple as tests/test_train.py builds it (_tiny_problem,
    then the images, in the same numpy draw order), with the port's SE3;
    leading batch dimension 1, on ``dev``."""
    from dbaf_tpu_torch.ops import lie

    rng = np.random.default_rng(seed)
    poses = [lie.se3_identity()]
    for _ in range(n - 1):
        xi = np.concatenate([rng.normal(size=3) * 0.1, rng.normal(size=3) * 0.03])
        poses.append(lie.se3_mul(lie.se3_exp(torch.as_tensor(xi, dtype=torch.float32)),
                                 poses[-1]))
    disps = torch.as_tensor(0.5 + 0.3 * rng.random((n, h8, w8)), dtype=torch.float32)
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    keep = np.abs(ii - jj) == 1
    batch = dict(
        images=torch.as_tensor(rng.integers(0, 255, size=(n, 8 * h8, 8 * w8, 3)),
                               dtype=torch.float32),
        poses0=lie.se3_identity((n,)), disps0=torch.ones((n, h8, w8)),
        poses_gt=torch.stack(poses), disps_gt=disps,
        intrinsics=torch.as_tensor([2.0 * w8, 2.0 * w8, w8 / 2, h8 / 2]),
        ii=torch.as_tensor(ii[keep]), jj=torch.as_tensor(jj[keep]))
    return {k: v[None].to(dev) for k, v in batch.items()}


def train_spread(params: dict, batch: dict, eps: float = 1e-4) -> dict:
    """The f32 unroll's own spread on the CPU: how far the loss and each
    parameter leaf's gradient (num_steps 2) move when the images move by
    ``eps`` intensity levels, relative to their size (the leaves with a
    true zero gradient, the biases ahead of fnet's instance norms, left
    out).  Returns the loss's change and the median and worst leaf's."""
    from dbaf_tpu_torch.models.net import DroidNet
    from dbaf_tpu_torch.train.trainer import loss_sample

    sample = {k: v[0] for k, v in batch.items()}
    runs = []
    for shift in (0.0, eps):
        model = DroidNet(dtype=torch.float32, device="cpu")
        model.load_state_dict(params)
        loss, _ = loss_sample(model, dict(sample, images=sample["images"] + shift), 2)
        loss.backward()
        runs.append((float(loss), {k: p.grad for k, p in model.named_parameters()}))
    (l0, g0), (l1, g1) = runs
    rel = [float((g1[k] - g).norm() / g.norm()) for k, g in g0.items()
           if not (k.startswith("fnet.") and k.endswith(".bias") and k != "fnet.conv2.bias")]
    return dict(loss=abs(l1 - l0) / abs(l0), median=float(np.median(rel)), worst=max(rel))


def step_parity(a, b, lr: float) -> dict:
    """Phase 9a's parity measures of training step ``a`` against ``b``, each
    (loss, {leaf: gradient}, {leaf: updated parameter}) on the host: the
    loss (relative), each leaf's gradient (L2 of the difference over the
    leaf's norm; the zero-gradient biases ahead of fnet's instance norms
    over the largest leaf norm), the updated parameters where the two
    gradients agree to 1%, and the share of entries at the noise (held to
    2 lr); ``bad`` names each measure over its TRAIN_* bound."""
    (loss_a, g_a, p_a), (loss_b, g_b, p_b) = a, b
    g_a, g_b, p_a, p_b = ({k: torch.as_tensor(v) for k, v in d.items()}
                          for d in (g_a, g_b, p_a, p_b))
    loss_rel = abs(loss_a - loss_b) / abs(loss_b)
    top = max(float(g.norm()) for g in g_b.values())
    worst_rel, worst_noise = 0.0, 0.0
    bad = ["loss"] if not loss_rel <= TRAIN_LOSS_RTOL else []
    if g_a.keys() != g_b.keys():
        bad.append("gradient leaves")
    for k, g in g_b.items():
        d = float((g_a[k] - g).norm())
        if k.startswith("fnet.") and k.endswith(".bias") and k != "fnet.conv2.bias":
            worst_noise = max(worst_noise, d / top)
            if d > TRAIN_NOISE_TOL * top:
                bad.append(k)
        else:
            worst_rel = max(worst_rel, d / max(float(g.norm()), 1e-30))
            if not d <= TRAIN_GRAD_TOL * float(g.norm()):
                bad.append(k)
    noisy = total = 0
    worst_p = 0.0
    for k, p in p_b.items():
        err = (p_a[k] - p).abs()
        at_noise = ((g_a[k] - g_b[k]).abs() > 0.01 * torch.maximum(g_a[k].abs(), g_b[k].abs())
                    if k in g_b else torch.zeros_like(err, dtype=torch.bool))
        if bool((err[at_noise] > 2 * lr + TRAIN_PARAM_ATOL).any()):
            bad.append(k + " (update)")
        if (~at_noise).any():
            worst_p = max(worst_p, float(err[~at_noise].max()))
        noisy += int(at_noise.sum())
        total += p.numel()
    if worst_p > TRAIN_PARAM_ATOL:
        bad.append("parameters")
    if noisy > TRAIN_NOISY_SHARE * total:
        bad.append("noisy share")
    return dict(loss_rel=loss_rel, grad_rel=worst_rel, grad_noise=worst_noise, param_err=worst_p,
                noisy=noisy, total=total, noisy_share=noisy / total, bad=bad)


def parity_line(m: dict) -> str:
    return (f"loss rel {m['loss_rel']:.2e} (bound {TRAIN_LOSS_RTOL:g}); worst leaf gradient "
            f"{m['grad_rel']:.2e} of its norm (bound {TRAIN_GRAD_TOL:g}), zero-gradient biases "
            f"{m['grad_noise']:.2e} of the largest leaf norm (bound {TRAIN_NOISE_TOL:g}); "
            f"updated parameters {m['param_err']:.2e} (bound {TRAIN_PARAM_ATOL:g}) where the "
            f"gradients agree to 1%, {m['noisy']} of {m['total']} entries with gradients at the "
            f"noise (share bound {TRAIN_NOISY_SHARE:g}, held to 2 lr)")


def train_parity(dev) -> dict:
    """Phase 9a: one make_train_step step (f32 DroidNet, weights from seed 0
    with the delta head scaled by 0.01, 4 frames at 96 x 128, num_steps 2,
    AdamW at a constant lr 1e-4) on the card
    and on the CPU from the same weights and batch.  Raises SystemExit unless
    the loss, every leaf's gradient and every updated parameter agree within
    the TRAIN_* bounds."""
    from dbaf_tpu_torch.models.net import DroidNet
    from dbaf_tpu_torch.train.trainer import make_optimizer, make_train_step

    lr = 1e-4
    model = DroidNet(dtype=torch.float32, device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.update.delta_2.weight.mul_(0.01)
        model.update.delta_2.bias.mul_(0.01)
    params = {k: v.clone() for k, v in model.state_dict().items()}
    batch = tiny_train_batch("cpu", 0, n=4, h8=12, w8=16)
    runs = []
    for where in (torch.device(dev), torch.device("cpu")):
        model = DroidNet(dtype=torch.float32, device=where)
        model.load_state_dict(params)
        opt = make_optimizer(model.parameters(), lr=lr, total_steps=2)  # constant lr
        met = make_train_step(model, opt, num_steps=2)({k: v.to(where) for k, v in batch.items()})
        runs.append((float(met["loss"]),
                     {k: p.grad.detach().cpu() for k, p in model.named_parameters()},
                     {k: p.detach().cpu() for k, p in model.named_parameters()}))
    m = step_parity(runs[0], runs[1], lr)
    loss_c, loss_h = runs[0][0], runs[1][0]
    spread = train_spread(params, batch)
    spread_ckpt = train_spread(seeded_params(20260820), batch)
    res = dict(loss_card=loss_c, loss_cpu=loss_h, spread=spread, spread_checkpoint=spread_ckpt,
               **{k: m[k] for k in ("loss_rel", "grad_rel", "grad_noise", "param_err",
                                    "noisy_share")})
    log(f"[train_parity] loss card {loss_c:.7f} cpu {loss_h:.7f}; {parity_line(m)}")
    for tag, sp in (("these weights", spread), ("the seeded checkpoint's", spread_ckpt)):
        log(f"[train_parity] the CPU's own spread at {tag}, images moved by 1e-4: loss "
            f"{sp['loss']:.2e}, leaf gradients {sp['median']:.2e} (median) to "
            f"{sp['worst']:.2e} (worst) of their norms")
    if m["bad"] or not np.isfinite(loss_c):
        raise SystemExit(f"train parity: card and CPU disagree ({m['bad'][:6]})")
    return res


TRAIN_FRAMES, TRAIN_WARM, TRAIN_TIMED = 7, 1, 5


def full_train_batch(dev, tuples: int) -> dict:
    """Phase 9b's batch: ``tuples`` tuples of TRAIN_FRAMES of phase 3's 384 x
    512 frames (tuple b takes frames [7b, 7b + 7)), ground truth from
    eval/synthetic.scene_from_poses, poses0 the identity and disps0 ones,
    the 22 edges |i - j| in {1, 2}; on ``dev``."""
    from dbaf_tpu_torch.eval.synthetic import scene_from_poses, simulate_imu_and_poses
    from dbaf_tpu_torch.ops import lie
    from dbaf_tpu_torch.utils.config import tumvi_config

    HT, WD = tumvi_config().image_size
    h8, w8, n = HT // 8, WD // 8, TRAIN_FRAMES
    intr8 = np.asarray([460.0, 460.0, WD / 2, HT / 2], np.float32) / 8.0
    _, poses_at = simulate_imu_and_poses(tuples * n / 10.0 + 0.5, fps=10.0)
    gt_cw, gt_disps = scene_from_poses(poses_at, tuples * n, intr8, h8, w8)
    images = feature_frames(tuples * n)
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    keep = (np.abs(ii - jj) >= 1) & (np.abs(ii - jj) <= 2)
    out = []
    for b in range(tuples):
        fr = slice(b * n, (b + 1) * n)
        out.append(dict(images=torch.as_tensor(images[fr], dtype=torch.float32),
                        poses0=lie.se3_identity((n,)), disps0=torch.ones((n, h8, w8)),
                        poses_gt=torch.as_tensor(gt_cw[fr]),
                        disps_gt=torch.as_tensor(gt_disps[fr]),
                        intrinsics=torch.as_tensor(intr8), ii=torch.as_tensor(ii[keep]),
                        jj=torch.as_tensor(jj[keep])))
    return {k: torch.stack([o[k] for o in out]).to(dev) for k in out[0]}


def phase_train(dev) -> dict:
    """Phase 9b: make_train_step at full width (one tuple of 7 of phase 3's
    384 x 512 frames, ground truth from eval/synthetic.scene_from_poses,
    poses0 the identity and disps0 ones, the 22 edges |i - j| in {1, 2},
    num_steps 12, fixedp 2, DroidNet() in bf16 with the seeded weights,
    make_optimizer() at its defaults): TRAIN_WARM step, then TRAIN_TIMED
    timed steps.  Fatal unless every loss, gradient and parameter stays
    finite, the parameters move, and no correlation kernel launches (the
    training unroll runs the plain lookup).  Then the objective-decrease
    scenario of tests/test_train.py:172-217 on the card."""
    from dbaf_tpu_torch.models.net import DroidNet
    from dbaf_tpu_torch.ops import corr_cuda as cc
    from dbaf_tpu_torch.train.trainer import make_optimizer, make_train_step
    from dbaf_tpu_torch.utils.config import tumvi_config

    HT, WD = tumvi_config().image_size
    n = TRAIN_FRAMES
    batch = full_train_batch(dev, 1)
    E = int(batch["ii"].shape[1])

    model = DroidNet(device=dev)
    model.load_state_dict(seeded_params(20260820))
    init = {k: p.detach().clone() for k, p in model.named_parameters()}
    step = make_train_step(model, make_optimizer(model.parameters()), num_steps=12, fixedp=2)
    cc.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for k in range(TRAIN_WARM + TRAIN_TIMED):
        t = time.perf_counter()
        met = step(batch)
        losses.append(float(met["loss"]))  # one read; the step has ended
        secs.append(time.perf_counter() - t)
        finite = all(bool(torch.isfinite(p).all()) and p.grad is not None
                     and bool(torch.isfinite(p.grad).all()) for p in model.parameters())
        if not (np.isfinite(losses[-1]) and finite):
            raise SystemExit(f"train: step {k} gave a non-finite loss, gradient or parameter")
    peak = torch.cuda.max_memory_allocated()
    launches = dict(cc.LAUNCHES)
    moved = sum(int((p.detach() != init[k]).sum()) for k, p in model.named_parameters())
    total = sum(p.numel() for p in model.parameters())
    s_step = float(np.mean(secs[TRAIN_WARM:]))
    log(f"[train] {n} frames at {HT}x{WD}, {E} edges, num_steps 12, bf16: losses "
        f"{[round(x, 5) for x in losses]}; {s_step:.4f} s/step over {TRAIN_TIMED} steps "
        f"({[round(x, 4) for x in secs]}); peak memory {peak / 2**30:.3f} GiB "
        f"(max_memory_allocated); parameters moved {moved} of {total}; launches {launches}")
    if any(launches.values()):
        raise SystemExit(f"train: correlation kernels launched during training: {launches}")
    if moved < total // 2:
        raise SystemExit(f"train: only {moved} of {total} parameter entries moved")

    # tests/test_train.py:172-217: 8 AdamW steps (lr 2e-3 over a 400-step
    # schedule) on one tiny tuple, the f32 network drawn as the JAX module
    # initializes it; deterministic algorithms, so the run repeats exactly
    tiny = tiny_train_batch(dev, 0)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        m = DroidNet(dtype=torch.float32, device="cpu").init_weights(
            torch.Generator().manual_seed(0)).to(dev)
        step = make_train_step(m, make_optimizer(m.parameters(), lr=2e-3, total_steps=400),
                               num_steps=1)
        hist = [float(step(tiny)["loss"]) for _ in range(8)]
    finally:
        torch.use_deterministic_algorithms(False)
    log(f"[train] objective decrease (tests/test_train.py:172): losses "
        f"{[round(x, 4) for x in hist]}; min(hist[4:]) / hist[0] = "
        f"{min(hist[4:]) / hist[0]:.4f} (bound 0.85)")
    if not (all(np.isfinite(hist)) and min(hist[4:]) < 0.85 * hist[0]):
        raise SystemExit("train: the objective did not decrease")
    return dict(s_per_step=s_step, peak_bytes=peak, losses=losses, hist=hist, edges=E)


UPSAMPLE_FRAMES = 20  # initialization at 8, then 12 keyframe steps
AGG_TOL = 2.0 ** -5   # GraphAgg in bf16 on the card against f32 on the CPU: 4 bf16 ulps of max
UP_TOL = 1e-5         # cvx_upsample, f32 mask, of max: a softmax and nine f32 products
UP16_TOL = 2.0 ** -7  # the bf16 mask the path passes: its softmax rounds to bf16 (1 ulp)


def phase_upsample(dev, main_kfs: float) -> dict:
    """Phase 9c: phase 3's main path with cfg.upsample for 12 keyframe steps
    (the seeded checkpoint carries update.agg), twice: the checks and the
    kf/s are the second run's.  Fatal unless K2 runs on
    every gated frame and K1 in every round, every frame with an active
    edge has a finite disps_up and GraphAgg's damping, and GraphAgg and
    cvx_upsample on the card, at the last keyframe's inputs, agree with the
    port's f32 CPU versions within AGG_TOL and UP_TOL."""
    from dbaf_tpu_torch.models.net import DroidNet
    from dbaf_tpu_torch.ops import corr_cuda as cc
    from dbaf_tpu_torch.slam.system import DBAFusion
    from dbaf_tpu_torch.train.unroll import upsample_disp
    from dbaf_tpu_torch.utils.config import tumvi_config

    cfg = tumvi_config()
    cfg.frontend.filter_thresh = -1.0
    cfg.upsample = True
    HT, WD = cfg.image_size
    params = seeded_params(20260820)
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, size=(HT + 64, WD + 64, 3)).astype(np.uint8)
    intr = np.asarray([460.0, 460.0, WD / 2, HT / 2], np.float32)

    def drive():
        system = DBAFusion(cfg, params=params, device=dev)
        fe = system.frontend
        if system.graph.agg_fn is None:
            raise SystemExit("upsample: DBAFusion built no GraphAgg head from the seeded checkpoint")
        cc.reset_launch_counts()
        t_steady = None
        for k in range(UPSAMPLE_FRAMES):
            if fe.is_initialized and t_steady is None:
                torch.cuda.synchronize()
                t_steady, steps0 = time.perf_counter(), fe.keyframe_steps
            ox, oy = (3 * k) % 64, (2 * k) % 64
            system.track(float(k), base[oy:oy + HT, ox:ox + WD], intrinsics=intr)
        torch.cuda.synchronize()
        return system, (fe.keyframe_steps - steps0) / (time.perf_counter() - t_steady)

    # the head sees a new edge and frame count at nearly every step, and the
    # first call of each convolution shape builds its cuDNN plan, which
    # takes several times a call on a built one: the first run pays that,
    # the second, on the same frames, runs on built plans
    _, kfs_cold = drive()
    system, kfs = drive()
    fe, g, v = system.frontend, system.graph, system.video
    L = dict(cc.LAUNCHES)
    if L["corr_lookup"] < UPSAMPLE_FRAMES - 1 or L["corr_fused_xy"] < fe.update_rounds \
            or fe.update_rounds == 0:
        raise SystemExit(f"upsample: launches {L} for {UPSAMPLE_FRAMES - 1} gated frames and "
                         f"{fe.update_rounds} rounds")
    frames, local = np.unique(g.ii, return_inverse=True)
    up = v.disps_up[frames]
    ii = torch.as_tensor(local, device=dev)
    net = g.edges.net[:g.n]
    eta, upmask = g.agg_fn(net, ii, len(frames))
    # one bf16 ulp: the head's per-frame mean sums in another order here
    damp_err = float((v.damping[frames] - eta).abs().max()) / float(eta.abs().max())
    ok = (up.shape[1:] == (HT, WD) and bool(torch.isfinite(up).all())
          and bool((up.abs().sum(dim=(1, 2)) > 0).all()) and damp_err <= 2.0 ** -7)

    # the head and the upsampling at this keyframe's inputs: card against CPU
    cpu_model = DroidNet(dtype=torch.float32, device="cpu")
    cpu_model.load_state_dict(params)
    eta_h, upmask_h = cpu_model.agg_fn(net.cpu().float(), ii.cpu(), len(frames))
    agg_err = max(float((eta.cpu() - eta_h).abs().max()) / float(eta_h.abs().max()),
                  float((upmask.float().cpu() - upmask_h).abs().max())
                  / float(upmask_h.abs().max()))
    disps = v.disps[frames]

    def up_err_of(mask):  # card against CPU, of the largest value
        ref = upsample_disp(disps.cpu(), mask.cpu())
        return float((upsample_disp(disps, mask).cpu() - ref).abs().max() / ref.abs().max())

    up_err, up16_err = up_err_of(upmask.float()), up_err_of(upmask)
    ms = cuda_ms(lambda: g.run_upsample(g.agg_fn), iters=10)
    log(f"[upsample] {fe.keyframe_steps} keyframe steps, {fe.update_rounds} rounds, launches "
        f"{L}; {len(frames)} frames with edges, disps_up {tuple(up.shape)} finite, damping "
        f"from GraphAgg within {damp_err:.2e} of max (bound 2^-7); GraphAgg card (bf16) vs CPU (f32) "
        f"{agg_err:.3e} of max (bound {AGG_TOL:g}), cvx_upsample card vs CPU {up_err:.2e} "
        f"of max with the mask in f32 (bound {UP_TOL:g}), {up16_err:.2e} in bf16 (bound "
        f"{UP16_TOL:g}); {kfs:.3f} kf/s on built plans, {kfs_cold:.3f} in the first run "
        f"(phase 3: {main_kfs:.3f}); run_upsample {ms:.3f} ms")
    if not ok or agg_err > AGG_TOL or up_err > UP_TOL or up16_err > UP16_TOL:
        raise SystemExit("upsample: disps_up, damping or the card's head is off")
    return dict(launches=L, kf_per_s=kfs, kf_per_s_cold=kfs_cold, run_upsample_ms=ms,
                agg_err=agg_err, up_err=up_err, up16_err=up16_err)


# ---------------------------------------------------------------------------
# phase 10: stereo and RGB-D input, save_state/load_state
# ---------------------------------------------------------------------------

STEREO_FRAMES = 20  # 10a: initialization at 8, then 12 keyframe steps
STEREO_SHIFT = 4    # the right frame: the same texture, 4 pixels to the side
ORACLE_FRAMES = 20  # 10b: each input mode
SAVE_AT, RESUME_TO = 12, 16  # 10c: the state saved before frame 12, frames 12-15 again
RESUME_TOL = 1e-4   # 10c: tests/test_slam_e2e.py:230-272's bound on the resumed poses
K1_TOL = 2e-2       # phase 2's K1 bound (test_corr.py's bf16 bound at outputs of order 1)


def right_offset(ox: int, shift: int) -> int:
    """The right frame's x offset in the texture (64 pixels wider than a
    frame): ``shift`` to the right, or to the left near the edge."""
    return ox + shift if ox + shift <= 64 else ox - shift


def main_frames(cfg):
    """Phase 3's procedural frames (left) and their right frames."""
    HT, WD = cfg.image_size
    base = np.random.default_rng(0).integers(0, 255, size=(HT + 64, WD + 64, 3)).astype(np.uint8)

    def frame(k, shift=0):
        ox, oy = right_offset((3 * k) % 64, shift), (2 * k) % 64
        return base[oy:oy + HT, ox:ox + WD]
    return frame, np.asarray([460.0, 460.0, WD / 2, HT / 2], np.float32)


def stereo_k1_check(system) -> dict:
    """One round's operands of the last edge set (self-edges among them)
    through K1 against its plain version; the self-edges' outputs must
    differ from those of left-only operands (the right buffer is read)."""
    from dbaf_tpu_torch.ops import corr_cuda as cc
    from dbaf_tpu_torch.ops import projective as pj
    from dbaf_tpu_torch.slam.graph import corr_operands

    g, v = system.graph, system.video
    g.flush()
    dev = v.device
    ii, jj = torch.as_tensor(g.ii, device=dev), torch.as_tensor(g.jj, device=dev)
    selfs = ii == jj
    coords1, _ = pj.projective_transform(v.poses, v.disps, v.intrinsics, ii, jj)
    f1p, f2p, _ = corr_operands(system.cfg, v, ii, jj)
    out = cc.corr_fused_xy(f1p, f2p, coords1, v.h8, v.w8)
    ref = cc.corr_fused_xy_plain(f1p, f2p, coords1, v.h8, v.w8)
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    # phase 2's bound is one bf16 ulp of outputs of order 1 there; the
    # network's features give outputs of order 10, so it scales with them
    # (2^-7 of the largest output, tests/test_torch_corr.py's K1 bound)
    tol = max(K1_TOL, 2.0 ** -7 * float(ref.float().abs().max()))
    mono = cc.corr_fused_xy(*corr_operands(system.cfg, v, ii, jj, right=False)[:2], coords1,
                            v.h8, v.w8)
    right_read = bool((mono[selfs] != out[selfs]).any()) and bool(
        (mono[~selfs] == out[~selfs]).all())
    return dict(edges=int(ii.numel()), self_edges=int(selfs.sum()), k1_err=err, k1_tol=tol,
                max_out=float(ref.float().abs().max()), n_apart=int((diff > 0).sum()),
                n_out=int(diff.numel()), right_read=right_read)


def phase_stereo(dev, main_kfs: float) -> dict:
    """Phase 10a: phase 3's main path with cfg.stereo, the right frames cut
    from the same texture STEREO_SHIFT pixels to the side, after the same
    frames without stereo: phase 3 runs first in the script and builds the
    convolution plans of each new edge count, so its kf/s is not the
    baseline of a run on built plans."""
    from dbaf_tpu_torch.ops import corr_cuda as cc
    from dbaf_tpu_torch.slam.system import DBAFusion
    from dbaf_tpu_torch.utils.config import tumvi_config

    frame, intr = main_frames(tumvi_config())
    params = seeded_params(20260820)

    def drive(stereo: bool):
        cfg = tumvi_config()
        cfg.frontend.filter_thresh = -1.0
        cfg.stereo = stereo
        system = DBAFusion(cfg, params=params, device=dev)
        fe = system.frontend
        cc.reset_launch_counts()
        t_steady = None
        self_edges = []
        for k in range(STEREO_FRAMES):
            if fe.is_initialized and t_steady is None:
                torch.cuda.synchronize()
                t_steady, steps0 = time.perf_counter(), fe.keyframe_steps
            steps = fe.keyframe_steps
            system.track(float(k), frame(k), intrinsics=intr,
                         image_right=frame(k, STEREO_SHIFT) if stereo else None)
            if fe.keyframe_steps > steps:
                self_edges.append(int(np.sum(system.graph.ii == system.graph.jj)))
        torch.cuda.synchronize()
        kfs = (fe.keyframe_steps - steps0) / (time.perf_counter() - t_steady)
        return system, kfs, self_edges, dict(cc.LAUNCHES)

    mono, mono_kfs, _, _ = drive(False)
    system, kfs, self_edges, L = drive(True)
    fe = system.frontend
    traj = system.terminate()
    chk = stereo_k1_check(system)
    log(f"[stereo] {fe.keyframe_steps} keyframe steps, {fe.culls} culls, {fe.update_rounds} "
        f"update rounds, launches {L}; self-edges per keyframe step {self_edges}; {kfs:.3f} "
        f"kf/s (the same frames without stereo: {mono_kfs:.3f} kf/s, {mono.frontend.culls} "
        f"culls, {mono.frontend.update_rounds} rounds; phase 3: {main_kfs:.3f}); K1 on the "
        f"last edge set ({chk['edges']} edges, {chk['self_edges']} self-edges) against its "
        f"plain version {chk['k1_err']:.3e} (bound {chk['k1_tol']:.4g}: 2^-7 of the largest "
        f"output {chk['max_out']:.4g}, or phase 2's {K1_TOL:g}), {chk['n_apart']} of "
        f"{chk['n_out']} outputs apart; self-edges read the right buffer: {chk['right_read']}")
    if L["corr_lookup"] < STEREO_FRAMES - 1 or L["corr_fused_xy"] < fe.update_rounds \
            or fe.update_rounds == 0:
        raise SystemExit(f"stereo: launches {L} for {STEREO_FRAMES - 1} gated frames and "
                         f"{fe.update_rounds} rounds")
    if len(self_edges) < 10 or min(self_edges) == 0:
        raise SystemExit(f"stereo: a keyframe step without self-edges: {self_edges}")
    if traj.shape != (fe.keyframe_steps, 8) or not np.all(np.isfinite(traj)):
        raise SystemExit(f"stereo: trajectory {traj.shape} not finite / not one row per step")
    if not (chk["k1_err"] <= chk["k1_tol"] and chk["right_read"] and chk["self_edges"] > 0):
        raise SystemExit(f"stereo: K1 on the stereo operands is off: {chk}")
    return dict(launches=L, kf_per_s=kfs, mono_kf_per_s=mono_kfs, culls=fe.culls,
                mono_culls=mono.frontend.culls, self_edges_per_step=self_edges, k1_check=chk)


def phase_oracle_inputs(dev) -> dict:
    """Phase 10b: phase 7's oracle scene at full width on the synchronous
    flow (bench.py's visual configuration with the pipeline off), once with
    stereo and once with RGB-D (the scene's depth at pixels [3::8, 3::8],
    as tests/test_slam_e2e.py:208-209 renders it).  Fatal unless (stereo)
    self-edges exist and the poses are finite
    (tests/test_slam_e2e.py:170-194) and (RGB-D) the median ratio of the
    live disparities to the truth lies in 0.9-1.1 (:198-227)."""
    from dbaf_tpu_torch.eval.ate import ate_rmse, umeyama
    from dbaf_tpu_torch.models.net import DroidNet
    from dbaf_tpu_torch.ops import corr_cuda as cc
    from dbaf_tpu_torch.ops import lie_np

    gt_cw, gt_disps, intr8 = visual_scene()
    oracle = visual_oracle(dev)
    model = DroidNet(device=dev)
    model.load_state_dict(seeded_params(20260820))
    model.eval()
    res = {}
    for mode in ("stereo", "rgbd"):
        cfg = visual_config("visual", async_on=False)
        cfg.stereo = mode == "stereo"
        run = VisualRun(dev, cfg, model, oracle, VISUAL_SCENE)
        run.intr = intr8 * 8.0  # the scene's camera, so that the oracle's targets are its views
        system = run.system
        HT, WD = cfg.image_size
        cc.reset_launch_counts()
        for k in range(ORACLE_FRAMES):
            if mode == "stereo":
                run.track(k, image_right=run.right(k))
            else:
                depth = np.zeros((HT, WD), np.float32)
                depth[3::8, 3::8] = 1.0 / gt_disps[k]
                run.track(k, depth=depth)
        L = dict(cc.LAUNCHES)
        traj = system.terminate()
        t1 = system.frontend.t1
        ids = np.round(system.video.tstamp[:t1]).astype(int)
        poses = system.video.poses[:t1].cpu().numpy().astype(np.float64)
        disps = system.video.disps[:t1].cpu().numpy()
        est = lie_np.se3_inv(poses)[:, :3]
        ref = lie_np.se3_inv(gt_cw[ids].astype(np.float64))[:, :3]
        ratio = float(np.median(disps[1:t1 - 1] / gt_disps[ids[1:t1 - 1]]))
        r = dict(launches=L, t1=t1, ratio=ratio, ate_se3=ate_rmse(est, ref, align="se3"),
                 ate_sim3=ate_rmse(est, ref, align="sim3"), scale=umeyama(est, ref)[0],
                 span=float(np.linalg.norm(ref.max(0) - ref.min(0))),
                 self_edges=int(np.sum(system.graph.ii == system.graph.jj)),
                 has_depth=system.video.has_depth)
        log(f"[oracle_{mode}] {t1} keyframes, launches {L}, self-edges {r['self_edges']}, "
            f"median disparity ratio {ratio:.4f}, ATE se3 {r['ate_se3']:.4e} m, sim3 "
            f"{r['ate_sim3']:.4e} m, scale {r['scale']:.4f}, span {r['span']:.3f} m")
        finite = np.all(np.isfinite(poses)) and np.all(np.isfinite(traj))
        if mode == "stereo" and not (r["self_edges"] > 0 and finite):
            raise SystemExit(f"oracle stereo: no self-edges or poses not finite: {r}")
        if mode == "rgbd" and not (r["has_depth"] and finite and 0.9 < ratio < 1.1):
            raise SystemExit(f"oracle RGB-D: the depth prior did not hold the scale: {r}")
        rounds = system.frontend.update_rounds
        if L["corr_fused_xy"] < rounds or L["corr_lookup"] < ORACLE_FRAMES - 1:
            raise SystemExit(f"oracle {mode}: launches {L}")
        res[mode] = r
    return res


def _state_has_no_tensor(path: str) -> str:
    """Unpickle a state file in a child process that sees no card; it fails
    if the load imports torch (a tensor in the file) or finds a non-numpy
    array among the video's buffers.  Returns its line."""
    code = (
        "import pickle, sys\n"
        "import numpy as np\n"
        f"s = pickle.load(open({path!r}, 'rb'))\n"
        "assert 'torch' not in sys.modules, 'the file holds a torch object'\n"
        "assert all(a is None or type(a) is np.ndarray for a in s['video'].values())\n"
        "print('state file loads without torch or a card:', sorted(s))\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=300)
    if out.returncode != 0:
        raise SystemExit(f"resume: the state file does not load without a card:\n{out.stderr}")
    return out.stdout.strip()


def phase_resume(dev) -> dict:
    """Phase 10c: phase 3's main path saved before frame SAVE_AT and run on
    to RESUME_TO; a fresh system loads the file and runs the same frames;
    an uninterrupted run gives the card's own spread.  Bounds: the loaded
    poses within 1e-6 of the saved ones, the resumed run's within RESUME_TOL
    of the first run's (the JAX test's bounds), or within twice the spread
    of two uninterrupted runs where that is larger."""
    from dbaf_tpu_torch.ops import corr_cuda as cc
    from dbaf_tpu_torch.slam.system import DBAFusion
    from dbaf_tpu_torch.utils.config import tumvi_config

    cfg = tumvi_config()
    cfg.frontend.filter_thresh = -1.0
    frame, intr = main_frames(cfg)
    params = seeded_params(20260820)
    path = os.path.join(ROOT, "dbaf_tpu_torch", "_build", "state_resume.pkl")
    os.makedirs(os.path.dirname(path), exist_ok=True)

    def run(system, k0, k1):
        for k in range(k0, k1):
            system.track(float(k), frame(k), intrinsics=intr)
        return system.video.poses[:system.frontend.t1].cpu().numpy().copy()

    cc.reset_launch_counts()
    a = DBAFusion(cfg, params=params, device=dev)
    run(a, 0, SAVE_AT)
    t = time.perf_counter()
    a.save_state(path)
    save_s = time.perf_counter() - t
    saved = a.video.poses[:a.frontend.t1].cpu().numpy().copy()
    end_a = run(a, SAVE_AT, RESUME_TO)
    b = DBAFusion(cfg, params=params, device=dev)
    t = time.perf_counter()
    b.load_state(path)
    load_s = time.perf_counter() - t
    loaded = b.video.poses[:b.frontend.t1].cpu().numpy().copy()
    end_b = run(b, SAVE_AT, RESUME_TO)
    L = dict(cc.LAUNCHES)
    end_c = run(DBAFusion(cfg, params=params, device=dev), 0, RESUME_TO)
    size = os.path.getsize(path)
    child = _state_has_no_tensor(path)
    os.remove(path)
    load_err = float(np.abs(loaded - saved).max())
    same = end_a.shape == end_b.shape == end_c.shape
    resume_err = float(np.abs(end_b - end_a).max()) if same else float("inf")
    spread = float(np.abs(end_c - end_a).max()) if same else float("inf")
    tol = max(RESUME_TOL, 2.0 * spread)
    log(f"[resume] state file {size / 2**20:.1f} MiB, save {save_s:.3f} s, load {load_s:.3f} s; "
        f"poses after the load {load_err:.3e} from the saved ones (bound 1e-6); after frames "
        f"{SAVE_AT}-{RESUME_TO - 1} {resume_err:.3e} from the uninterrupted run (bound {tol:g}); "
        f"two uninterrupted runs {spread:.3e} apart; launches {L}; {child}")
    if not (same and load_err <= 1e-6 and resume_err <= tol and np.all(np.isfinite(end_b))):
        raise SystemExit("resume: the loaded or resumed poses are off")
    return dict(launches=L, load_err=load_err, resume_err=resume_err, spread=spread, tol=tol,
                file_mib=size / 2**20, save_s=save_s, load_s=load_s)


# ---------------------------------------------------------------------------
# phase 11: the dataset demos' setup at each preset's full width
# ---------------------------------------------------------------------------

DEMOS = ("tumvi", "kitti360", "whu", "subt")
DEMO_FPS = 10.0
DEMO_FRAMES = 44  # VI initialization near frame 13, then about 28 keyframe steps
DEMO_GATE_PROBE = 10  # frames the preset's gate is tried on (DemoRun.probe_gate)
DEMO_Z0 = {"tumvi": 4.0, "kitti360": 4.0, "whu": 8.0, "subt": 4.0}  # camera to plane, m
# focal length over the feature grid's width: phase 5's camera (2), and for
# WHU a wide one, so that its 1.2 m a frame moves the view by a few percent
DEMO_FOCAL = {"tumvi": 2.0, "kitti360": 2.0, "whu": 0.5, "subt": 2.0}
DEMO_SAVE_PKL = "subt"  # the demo run with --save_pkl
# WHU: the GNSS scene of tests/test_georef.py:33-74: a 12 m/s forward drift
# (a 10 m baseline within ten keyframes) and the rows' true ENU frame yawed
# and offset from the world; ECEF about ten0_base (:97)
WHU_SPEED = 12.0
WHU_PSI = np.deg2rad(35.0)
WHU_OFFSET = np.array([100.0, -50.0, 3.0])
WHU_TEN0 = np.array([-2694045.0, -4293642.0, 3857878.0])
# SubT's --Tbc file: the camera looks along the body's x axis, 10 cm ahead
SUBT_TBC = np.array([[0.0, 0.0, 1.0, 0.10], [-1.0, 0.0, 0.0, 0.0], [0.0, -1.0, 0.0, 0.05],
                     [0.0, 0.0, 0.0, 1.0]])
DEMO_CALIB = {  # fx fy cx cy [distortion] in each dataset's calib layout
    "tumvi": "190.978477 190.973307 254.931706 256.897442 0.003482 0.000715 -0.002053 0.000203",
    "kitti360": "552.554261 552.554261 682.049453 238.769549 -0.05 0.01 0.001 -0.001",
    # no distortion: demo_whu's stream would undistort into 512x512
    # (image_stream's default size; ROADMAP Queue 3), which the preset's
    # 320x640 buffers do not take
    "whu": "1145.0 1145.0 640.0 512.0",
    "subt": "640.0 640.0 360.0 270.0",
}


def whu_body_state(t: float):
    """tests/test_georef.py:_body_state_fast: ms_body_state with a 12 m/s
    forward drift."""
    p, v, a, w = ms_body_state(t)
    return p + np.array([WHU_SPEED * t, 0.0, 0.0]), v + np.array([WHU_SPEED, 0.0, 0.0]), a, w


def whu_ecef(p_world: np.ndarray) -> np.ndarray:
    """ECEF of a world position through the yawed, offset true ENU frame."""
    from dbaf_tpu_torch.utils import geodesy

    Rz = np.array([[np.cos(WHU_PSI), -np.sin(WHU_PSI), 0.0],
                   [np.sin(WHU_PSI), np.cos(WHU_PSI), 0.0], [0.0, 0.0, 1.0]])
    return WHU_TEN0 + geodesy.Cen(WHU_TEN0) @ (Rz @ np.asarray(p_world, float) + WHU_OFFSET)


def demo_extrinsic(kind: str) -> np.ndarray:
    """The body<-camera extrinsic the demo passes to set_multisensor."""
    from dbaf_tpu_torch.apps import demo_kitti360, demo_tumvi, demo_whu

    return {"tumvi": np.linalg.inv(demo_tumvi.TUMVI_TIC), "kitti360": demo_kitti360.KITTI360_TBC,
            "whu": demo_whu.WHU_TBC, "subt": SUBT_TBC}[kind]


class DemoScene:
    """One demo's synthetic world, from eval/synthetic.simulate_imu_and_poses
    (WHU: with whu_body_state).  The simulated frame S is the camera's
    attitude: it looks up at the plane z = z0, as in phase 5.  The body is S
    turned by the demo's extrinsic (R_wb = R_s Rbc^T) at S's position, so the
    body's IMU reads S's rates and specific force turned by Rbc, and the
    camera sits at the lever arm R_wb tbc.  ``imu`` rows are the internal
    convention [t, gyro deg/s, acc], ``body`` maps a frame to (R_wb, p_wb)."""

    def __init__(self, kind: str, n_frames: int, image_size):
        from unittest import mock

        from dbaf_tpu_torch.eval import synthetic

        self.kind, self.n_frames, self.fps = kind, n_frames, DEMO_FPS
        self.state_fn = whu_body_state if kind == "whu" else synthetic.body_state
        with mock.patch.object(synthetic, "body_state", self.state_fn):
            rows, poses_s = synthetic.simulate_imu_and_poses(n_frames / self.fps + 0.5,
                                                             fps=self.fps)
        self.Tbc = demo_extrinsic(kind)
        Rbc, tbc = self.Tbc[:3, :3], self.Tbc[:3, 3]
        self.imu = rows.copy()
        self.imu[:, 1:4] = rows[:, 1:4] @ Rbc.T
        self.imu[:, 4:7] = rows[:, 4:7] @ Rbc.T
        self.body = {k: (R @ Rbc.T, p) for k, (R, p) in poses_s.items()}
        cam = {k: (R, p + R @ (Rbc.T @ tbc)) for k, (R, p) in poses_s.items()}
        HT, WD = image_size
        H8, W8 = HT // 8, WD // 8
        f8 = DEMO_FOCAL[kind] * W8
        self.intr8 = np.asarray([f8, f8, W8 / 2, H8 / 2], np.float32)
        z_plane = DEMO_Z0[kind] + (Rbc.T @ tbc)[2]
        self.gt_cw, self.gt_disps = synthetic.scene_from_poses(cam, n_frames, self.intr8, H8, W8,
                                                               z0=z_plane)

    def velocity_body(self, k: int) -> np.ndarray:
        """The body's velocity in the body frame at frame k (wheel odometry)."""
        R, _ = self.body[k]
        return R.T @ self.state_fn(k / self.fps)[1]


def write_demo_files(kind: str, scene: DemoScene, root: str, weights: str,
                     resultpath: str, pklpath: str) -> list:
    """Write ``scene``'s sensor files in the dataset's own layout and units
    under ``root`` and return the demo's argv.  Camera stamps: TUM-VI's
    data.csv lists 4 images a frame (the demo's stride 4), WHU's stamp file 2
    (stride 2); each image folder is left empty (the phase feeds rendered
    frames)."""
    os.makedirs(root, exist_ok=True)
    calib = os.path.join(root, "calib.txt")
    with open(calib, "w") as f:
        f.write(DEMO_CALIB[kind] + "\n")
    fps, n, imu = scene.fps, scene.n_frames, scene.imu
    common = ["--calib", calib, "--weights", weights, "--resultpath", resultpath,
              "--pklpath", pklpath]
    if kind == "tumvi":
        data = os.path.join(root, "dataset-room1_512_16", "mav0")
        os.makedirs(os.path.join(data, "cam0", "data"), exist_ok=True)
        os.makedirs(os.path.join(data, "imu0"), exist_ok=True)
        imupath = os.path.join(data, "imu0", "data.csv")
        with open(imupath, "w") as f:  # ns, gyro rad/s, acc m/s^2
            f.write("#timestamp [ns],w_RS_S_x [rad s^-1],w_RS_S_y [rad s^-1],w_RS_S_z "
                    "[rad s^-1],a_RS_S_x [m s^-2],a_RS_S_y [m s^-2],a_RS_S_z [m s^-2]\n")
            for r in imu:
                g = np.deg2rad(r[1:4])
                f.write(f"{int(round(r[0] * 1e9))}," + ",".join(f"{x:.17g}" for x in g)
                        + "," + ",".join(f"{x:.17g}" for x in r[4:7]) + "\n")
        with open(os.path.join(data, "cam0", "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n")
            for j in range(4 * n):
                ns = int(round(j / (4 * fps) * 1e9))
                f.write(f"{ns},{ns}.png\n")
        return ["--datadir", os.path.dirname(data), "--imupath", imupath] + common
    if kind == "kitti360":
        imagedir = os.path.join(root, "image_00", "data_rgb")
        os.makedirs(imagedir, exist_ok=True)
        imupath = os.path.join(root, "imu.txt")
        rows = imu.copy()
        rows[:, 0] -= demo_module("kitti360").IMU_CAM_TIME_OFFSET  # the demo moves it back
        np.savetxt(imupath, rows, fmt="%.17g")  # seconds, gyro deg/s, whitespace
        return ["--imagedir", imagedir, "--imupath", imupath] + common
    if kind == "whu":
        imagedir = os.path.join(root, "cam0")
        os.makedirs(imagedir, exist_ok=True)
        imupath = os.path.join(root, "imu.csv")
        np.savetxt(imupath, imu, delimiter=",", fmt="%.17g")  # seconds, gyro deg/s
        stamps = os.path.join(root, "image_stamps.csv")
        with open(stamps, "w") as f:
            for j in range(2 * n):
                f.write(f"{j / (2 * fps):.17g},{j:06d}.png\n")
        gnss = os.path.join(root, "gnss.txt")
        tbg = demo_module("whu").WHU_TBG
        with open(gnss, "w") as f:  # t, ECEF x y z, 12 more columns, Fixed (column 16)
            for k in range(n):
                R, p = scene.body[k]
                e = whu_ecef(p + R @ tbg)  # the antenna
                f.write(" ".join(f"{x:.17g}" for x in [k / fps, *e]) + " "
                        + " ".join(["0.0"] * 12) + " Fixed\n")
        odo = os.path.join(root, "odo.txt")
        np.savetxt(odo, [[k / fps, *scene.velocity_body(k)] for k in range(n)], fmt="%.17g")
        return (["--imagedir", imagedir, "--imagestamp", stamps, "--imupath", imupath,
                 "--use_gnss", "--gnsspath", gnss, "--use_odo", "--odopath", odo, "--use_zupt"]
                + common)
    imagedir = os.path.join(root, "cam_0")
    os.makedirs(imagedir, exist_ok=True)
    imupath = os.path.join(root, "imu_data.csv")
    rows = imu.copy()
    rows[:, 0] = np.round(rows[:, 0] * 1e9)
    rows[:, 1:4] = np.deg2rad(rows[:, 1:4])
    np.savetxt(imupath, rows, delimiter=",", fmt="%.17g")  # ns, gyro rad/s
    tbc = os.path.join(root, "Tbc.txt")
    np.savetxt(tbc, SUBT_TBC, fmt="%.17g")
    argv = ["--imagedir", imagedir, "--imupath", imupath, "--Tbc", tbc] + common
    return argv + (["--save_pkl"] if kind == DEMO_SAVE_PKL else [])


def demo_module(kind: str):
    import importlib

    return importlib.import_module(f"dbaf_tpu_torch.apps.demo_{kind}")


def demo_stamps(kind: str, n: int) -> np.ndarray:
    """The camera stamps of the frames the demo's stream would yield, as
    the stream reads them from the files (TUM-VI and SubT in nanoseconds)."""
    t = np.arange(n) / DEMO_FPS
    return np.round(t * 1e9) * 1e-9 if kind in ("tumvi", "subt") else t


class DemoRun:
    """A demo's system built by its own ``setup`` from ``argv``, the
    update rounds' outputs replaced by the scene's oracle (the network still
    runs in each round and in the motion gate, as in phase 5), and the
    rendered frames it is fed: phase 5's procedural texture at the
    preset's size."""

    def __init__(self, kind: str, scene: DemoScene, argv: list, device=None):
        from dbaf_tpu_torch.eval.synthetic import make_oracle

        self.kind, self.scene = kind, scene
        mod = demo_module(kind)
        self.args = mod.parse_args(argv)
        self.system, self.demo_stream = mod.setup(self.args, device)
        system = self.system
        self.dev = system.device
        step = system.graph.update_step
        model_update = step.update_fn
        oracle = make_oracle(scene.gt_cw, scene.gt_disps, scene.intr8, device=self.dev)

        def update_fn(net, inp, corr, motn, ii, jj, aux):
            net2, delta, weight = model_update(net, inp, corr, motn, ii, jj, aux)
            _, d_o, w_o = oracle(net, inp, corr, motn, ii, jj, aux)
            return net2, d_o + delta.float() * 1e-30, w_o + weight.float() * 1e-30

        step.update_fn = update_fn
        HT, WD = system.cfg.image_size
        self.base = np.random.default_rng(1).integers(0, 255, size=(HT + 64, WD + 64, 3)) \
            .astype(np.uint8)
        self.id_map = np.zeros(system.cfg.buffer, np.int64)
        self.stamps = demo_stamps(kind, scene.n_frames)
        self.probe_gate(mod, device)

    def frame(self, k: int) -> np.ndarray:
        HT, WD = self.system.cfg.image_size
        ox, oy = (3 * k) % 64, (2 * k) % 64
        return self.base[oy:oy + HT, ox:ox + WD]

    def probe_gate(self, mod, device) -> None:
        """The preset's motion gate on the first DEMO_GATE_PROBE frames, in a
        second system from the same setup (its MotionFilter alone, no
        keyframe step).  If it admits fewer than all but one of them, the run
        sets filter_thresh to -1 (every frame admitted): the seeded random
        network's flow is no motion estimate, and VI initialization needs
        12 keyframes on a motion the IMU can follow."""
        probe, _ = mod.setup(self.args, device)
        intr = self.scene.intr8 * 8.0
        for k in range(DEMO_GATE_PROBE):
            probe.filter.track(float(self.stamps[k]), self.frame(k), intrinsics=intr)
        self.gate_admitted = int(probe.video.counter)
        del probe
        if self.gate_admitted < DEMO_GATE_PROBE - 1:
            self.system.cfg.frontend.filter_thresh = -1.0

    def stream(self, hooks=None):
        """(t, image, intrinsics) of every frame for ``runner.run``; the
        oracle's slot -> frame map goes up around each yield, and
        ``hooks(k)`` runs before frame k is yielded (and once after the
        last)."""
        v, g = self.system.video, self.system.graph
        intr = self.scene.intr8 * 8.0
        for k in range(self.scene.n_frames):
            if hooks is not None:
                hooks(k)
            self.id_map[v.counter] = k
            g.aux = {"id_map": torch.as_tensor(self.id_map, device=self.dev)}
            yield float(self.stamps[k]), self.frame(k), intr
            n = v.counter
            self.id_map[:n] = np.round(v.tstamp[:n] * self.scene.fps).astype(np.int64)
            g.aux = {"id_map": torch.as_tensor(self.id_map, device=self.dev)}
        if hooks is not None:
            hooks(self.scene.n_frames)

    def accuracy(self):
        """(ATE of the keyframes' solved body positions, span, max |bias|)."""
        from dbaf_tpu_torch.eval.ate import ate_rmse

        v, st = self.system.video, self.system.graph.coupled.state
        t1 = self.system.frontend.t1
        est = np.asarray([st.wTbs[k].t for k in range(t1)])
        ids = np.round(v.tstamp[:t1] * self.scene.fps).astype(int)
        ref = np.stack([self.scene.body[i][1] for i in ids])
        return (ate_rmse(est, ref, align="se3"), float(np.linalg.norm(ref.max(0) - ref.min(0))),
                float(np.abs(np.asarray([st.bs[k] for k in range(t1)])).max()), est)


def read_result_rows(path: str) -> list:
    """The result file's rows: 8 TUM fields, 11 once georeferenced."""
    with open(path) as f:
        return [[float(x) for x in line.split()] for line in f if line.strip()]


def whu_enu_check(run: DemoRun, rows: list) -> dict:
    """The rows written after GNSS initialization, their ECEF columns in
    the local frame at ten0 against the truth there
    (tests/test_georef.py:146-170's bounds on the same quantities)."""
    from dbaf_tpu_torch.eval.ate import ate_rmse
    from dbaf_tpu_torch.utils import geodesy

    c = run.system.graph.coupled
    geo = [r for r in rows if len(r) == 11 and r[0] > c.gnss_init_time + 1e-9]
    if len(geo) < 3:
        return dict(rows=len(geo))
    C0 = geodesy.Cen(c.ten0)
    est = np.asarray([C0.T @ (np.asarray(r[8:11]) - c.ten0) for r in geo])
    truth_w = np.asarray([whu_body_state(r[0])[0] for r in geo])
    ref = np.asarray([C0.T @ (whu_ecef(p) - c.ten0) for p in truth_w])
    err = np.linalg.norm(est - ref, axis=1)
    span = float(np.linalg.norm(ref.max(0) - ref.min(0)))
    rmse = ate_rmse(est, truth_w, align="se3")
    # the ECEF columns are the rows' local positions taken to ECEF
    col = max(float(np.abs(C0.T @ (np.asarray(r[8:11]) - c.ten0) - r[1:4]).max()) for r in geo)
    return dict(rows=len(geo), span=span, err_max=float(err.max()),
                err_median=float(np.median(err)), rmse_se3=rmse, ecef_vs_local=col,
                ok=bool(err.max() < 0.08 * span and np.median(err) < 0.05 * span
                        and rmse < 0.05 * span and col < 1e-3))


def count_host_lm():
    """Count the host LM solver's passes and iterations (a linearization
    each) while the returned restore function is not called."""
    from dbaf_tpu_torch.fusion import graph as fg

    counts = {"passes": 0, "iters": 0}
    optimize = fg.LevenbergMarquardt.optimize

    def counted(self):
        counts["passes"] += 1
        linearize = self.graph.linearize

        def lin(values):
            counts["iters"] += 1
            return linearize(values)

        self.graph.linearize = lin
        try:
            return optimize(self)
        finally:
            del self.graph.linearize

    fg.LevenbergMarquardt.optimize = counted
    return counts, lambda: setattr(fg.LevenbergMarquardt, "optimize", optimize)


def k1_round_check(operands) -> dict:
    """K1 on one round's operands (``(f1p, f2p, coords1, H, W)`` of a launch
    the run made, and its ``whole`` where given) against its plain version
    at 2^-7 of the largest output (phase 10a's bound), and its ms a launch
    at that shape beside its bound, computed as phase 2 computes them."""
    from dbaf_tpu_torch.ops import corr_cuda as cc

    f1p, f2p, coords1, H, W, *rest = operands
    whole = bool(rest[0]) if rest else False
    E = int(coords1.shape[0])
    out = cc.corr_fused_xy(f1p, f2p, coords1, H, W, whole=whole)
    ref = cc.corr_fused_xy_plain(f1p, f2p, coords1, H, W, whole)
    err = float((out.float() - ref.float()).abs().max())
    max_out = float(ref.float().abs().max())
    tol = max(K1_TOL, 2.0 ** -7 * max_out)
    ms = graph_ms(lambda: cc.corr_fused_xy(f1p, f2p, coords1, H, W, whole=whole), 20)
    plain_ms = cuda_ms(lambda: cc.corr_fused_xy_plain(f1p, f2p, coords1, H, W, whole), 2,
                       warmup=1)
    P, C = H * W, 128
    bms, by = bound(E * P * C * 2 * 2 + E * P * 2 * 4 + E * P * 196 * 2,
                    (2.0 * E * P * P * C + lookup_flops(coords1, H, W, True)) / PEAK_BF16)
    return dict(E=E, grid=f"{H}x{W}", whole=whole, k1_err=err, k1_tol=tol, max_out=max_out,
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)


def run_demo(kind: str, weights: str, out_root: str, build_root: str, dev) -> dict:
    """Phase 11 for one demo: write its files, build it through its setup,
    feed its frames through runner.run, and hold the results."""
    from dbaf_tpu_torch.apps import runner
    from dbaf_tpu_torch.ops import corr_cuda as cc
    from dbaf_tpu_torch.utils import config
    from dbaf_tpu_torch.utils import device as devmod

    n = DEMO_FRAMES
    image_size = getattr(config, f"{kind}_config")().image_size
    scene = DemoScene(kind, n, image_size)
    root = os.path.join(out_root, kind)
    result = os.path.join(root, f"result_{kind}.txt")
    pkl = os.path.join(build_root, f"reconstruction_{kind}.pkl")
    argv = write_demo_files(kind, scene, root, weights, result, pkl)
    run = DemoRun(kind, scene, argv, dev)
    system = run.system
    fe, v, g = system.frontend, system.video, system.graph
    shapes = set()
    k1 = cc.corr_fused_xy
    full = {}  # the operands of the run's last K1 launch at E = 48

    def k1_shapes(f1p, f2p, coords, H, W, *a, **kw):
        shapes.add((int(coords.shape[0]), H, W))
        if coords.shape[0] == 48:
            full["ops"] = (f1p, f2p, coords, H, W, kw.get("whole", False))
        return k1(f1p, f2p, coords, H, W, *a, **kw)

    lm, restore = count_host_lm()
    clock = {}

    def hooks(k):
        if "t0" not in clock and v.imu_enabled:  # VI initialization ran in frame k - 1
            torch.cuda.synchronize()
            clock.update(t0=time.perf_counter(), steps0=fe.keyframe_steps, vi_frame=k - 1,
                         reads0=devmod.HOST_READS["count"], lm0=dict(lm))
        if k == n - N_PROFILED:
            if "t0" not in clock:
                raise SystemExit(f"demo {kind}: VI initialization did not trigger in {k} frames")
            torch.cuda.synchronize()
            clock.update(wall=time.perf_counter() - clock["t0"],
                         steps=fe.keyframe_steps - clock["steps0"],
                         reads=devmod.HOST_READS["count"] - clock["reads0"],
                         lm_passes=lm["passes"] - clock["lm0"]["passes"],
                         lm_iters=lm["iters"] - clock["lm0"]["iters"])
            clock["prof"] = Profile()
        if k == n:
            clock["profile"] = clock.pop("prof").stop(f"demo_{kind}", f"profile_demo_{kind}.txt")

    cc.reset_launch_counts()
    cc.corr_fused_xy = k1_shapes
    try:
        out = runner.run(system, run.stream(hooks), run.args.resultpath, run.args.pklpath
                         if run.args.save_pkl else None, None, None)
    finally:
        cc.corr_fused_xy = k1
        restore()
    launches = dict(cc.LAUNCHES)
    rows = read_result_rows(result)
    traj = np.asarray([r[:8] for r in rows])
    ate, span, bias, est = run.accuracy()
    c = g.coupled
    res = dict(
        demo=kind, argv=" ".join(a if not a.startswith(ROOT) else os.path.relpath(a, ROOT)
                                 for a in argv),
        image_size=list(system.cfg.image_size), frames=out["frames"], keyframes=out["keyframes"],
        keyframe_steps=fe.keyframe_steps, culls=fe.culls, rollups=fe.rollup_count,
        update_rounds=fe.update_rounds, vi_init_frame=clock["vi_frame"],
        kf_per_s=clock["steps"] / clock["wall"], steady_steps=clock["steps"],
        host_reads_per_kf=clock["reads"] / max(clock["steps"], 1),
        lm_iters_per_pass=clock["lm_iters"] / max(clock["lm_passes"], 1),
        lm_passes_per_kf=clock["lm_passes"] / max(clock["steps"], 1),
        idle_share=clock["profile"]["idle_share"],
        k1_launches=launches["corr_fused_xy"], k2_launches=launches["corr_lookup"],
        k1_grid=f"{v.h8}x{v.w8}", k1_max_edges=max((e for e, _, _ in shapes), default=0),
        traj_rows=len(rows), all_stamp_rows=len(rows) - fe.keyframe_steps,
        ecef_rows=sum(len(r) == 11 for r in rows),
        gnss_init_frame=None, ate=ate, span=span, ate_share=ate / span, max_abs_bias=bias,
        filter_thresh=system.cfg.frontend.filter_thresh,
        gate=(f"the preset's gate admitted {run.gate_admitted} of the first {DEMO_GATE_PROBE} "
              "frames" + ("" if system.cfg.frontend.filter_thresh >= 0 else
                          ", so filter_thresh is -1 (every frame admitted)")),
        device_solver=system.cfg.sensors.device_solver)
    if c.gnss_init_time > 0:
        res["gnss_init_frame"] = int(round(c.gnss_init_time * DEMO_FPS))
    checks = [
        (np.all(np.isfinite(traj)) and np.all(np.isfinite(est)), "a pose is not finite"),
        (traj.shape[0] >= fe.keyframe_steps > 0, f"{traj.shape[0]} rows for "
         f"{fe.keyframe_steps} keyframe steps"),
        (launches["corr_lookup"] >= n - 1, f"K2 launched {launches['corr_lookup']} times for "
         f"{n - 1} gated frames"),
        (launches["corr_fused_xy"] >= fe.update_rounds > 0, f"K1 launched "
         f"{launches['corr_fused_xy']} times for {fe.update_rounds} update rounds"),
        (all((h, w) == (v.h8, v.w8) for _, h, w in shapes), f"K1 ran at {shapes}"),
        (ate < 0.08 * span, f"ATE {ate} m is not under 0.08 x span ({span} m)"),
        (bias < 0.2, f"a bias reached {bias} (bound 0.2)"),
        (not system.cfg.sensors.device_solver, "the preset's device_solver=False changed"),
    ]
    if kind in ("tumvi", "whu"):
        checks.append((res["all_stamp_rows"] > 0, "all_stamp added no trajectory row"))
    if kind == "whu":
        enu = whu_enu_check(run, rows)
        res["enu"] = enu
        checks += [(c.gnss_init_time > 0, "init_gnss did not fire"),
                   (len(system.trajectory_ecef) > 0, "trajectory_ecef has no rows"),
                   (enu.get("ok", False), f"the ECEF rows are off the truth: {enu}")]
    if kind == DEMO_SAVE_PKL:
        from dbaf_tpu_torch.eval.visualize import load_reconstruction

        recon = load_reconstruction(pkl)
        exported = len(v.saved_tstamps) + fe.t1 - min(v.archive_mark, fe.t1)
        res["pkl_keyframes"] = len(recon["points"])
        res["pkl_mib"] = (os.path.getsize(pkl) + os.path.getsize(pkl[:-4] + "_raw.pkl")) / 2**20
        checks.append((len(recon["points"]) == exported > 0 and all(
            np.all(np.isfinite(e["pts"])) for e in recon["points"].values()),
            f"the reconstruction is not one finite block per keyframe ({exported})"))
        os.remove(pkl)
        os.remove(pkl[:-4] + "_raw.pkl")
    if kind == "kitti360":
        if "ops" not in full:
            raise SystemExit(f"demo {kind}: no round ran K1 at E=48 ({shapes})")
        chk = k1_round_check(full.pop("ops"))
        res["k1_check"] = chk
        checks.append((chk["k1_err"] <= chk["k1_tol"], f"K1 at E=48 {chk['grid']} off its "
                       f"plain version: {chk}"))
    res["launches"] = launches
    log(f"[demo_{kind}] " + json.dumps(res))
    for ok, msg in checks:
        if not ok:
            raise SystemExit(f"demo {kind}: {msg}")
    return res


def write_demo_weights(path: str) -> str:
    """The seeded reference-format checkpoint, as a user's droid.pth."""
    from dbaf_tpu_torch.models.convert import synth_reference_state_dict

    with open(MANIFEST) as f:
        manifest = json.load(f)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({k: torch.as_tensor(a) for k, a in synth_reference_state_dict(
        manifest, 20260820).items()}, path)
    return path


def phase_demos(dev) -> dict:
    """Phase 11: each dataset demo's setup at its preset's full width."""
    build = os.path.join(ROOT, "dbaf_tpu_torch", "_build", "demos")
    weights = write_demo_weights(os.path.join(build, "droid_seeded.pth"))
    out_root = os.path.join(ROOT, "chiprun_out", "demos")
    res = {}
    for kind in DEMOS:
        t = time.perf_counter()
        res[kind] = run_demo(kind, weights, out_root, build, dev)
        log(f"[time] phase 11 {kind} took {time.perf_counter() - t:.1f} s")
    os.remove(weights)
    return res


# ---------------------------------------------------------------------------
# phase 12: multi-device on the one card.  The ranks are processes of this
# script (torch.multiprocessing spawn, through parallel/launch.py), each on
# cuda:0.  NCCL puts no two ranks on one card, so two ranks use gloo, whose
# collectives go through the host; a world of one runs over NCCL.  No
# scaling number can be taken on one card: the phase measures agreement,
# memory per rank and what the host-staged collectives cost.

# phase 13: the multi-sensor flagship (GNSS, odometry, ZUPT) on phase 6's
# configuration.  13a: tests/test_georef.py's scene (WHU_* above, a 12 m/s
# drift, GNSS as ECEF rows of a yawed, offset ENU frame), phase 11's WHU
# camera (focal 0.5 of the grid's width, plane at 8 m), body-frame odometry.
# 13b: tests/test_zupt.py's stop-and-go and its camera (focal 16 pixels on
# its 16-wide grid: the grid's width; plane at 4 m).  With phase 5's camera
# (focal twice the width) the stationary velocity estimate stays over the
# gate's 0.12 m/s and no ZUPT fires.
ZUPT_FOCAL, ZUPT_Z0 = 1.0, 4.0
MS_GEO_FRAMES = 52
MS_ZUPT_FRAMES = 100
MS_ASYNC_TOL = 2e-2   # 13a: async against sync, phase 6's bound against phase 5
ZUPT_T_STOP, ZUPT_T_RESUME, ZUPT_TAU = 4.0, 9.4, 0.5  # tests/test_zupt.py:61-63
ZUPT_VEL_THRESH = 0.12  # tests/test_zupt.py's scene-level gate (its docstring says why)
K2_REL_TOL = 1e-6     # K2 on a path's operands: of its largest output (f32 sums)
MS_PROFILED = 1       # frames under torch.profiler at a run's end (its stop costs 5-13 s a frame)


def ms_body_state(t: float):
    """The multisensor tests' trajectory (tests/test_slam_multisensor.py:33-39)."""
    p = np.array([1.2 * np.sin(1.3 * t), 0.9 * np.cos(1.7 * t), 0.25 * t])
    v = np.array([1.56 * np.cos(1.3 * t), -1.53 * np.sin(1.7 * t), 0.25])
    a = np.array([-2.03 * np.sin(1.3 * t), -2.60 * np.cos(1.7 * t), 0.0])
    w = np.array([0.25 * np.sin(0.9 * t), 0.2 * np.cos(0.7 * t), 0.15])
    return p, v, a, w


def zupt_warp(t: float):
    """tests/test_zupt.py:_warp: unit speed, a cosine ramp to a dead stop at
    ZUPT_T_STOP, a plateau until ZUPT_T_RESUME, a ramp back; (s, s', s'')."""
    s0, tau = ZUPT_T_STOP, ZUPT_TAU
    if t < s0:
        return t, 1.0, 0.0
    if t < s0 + tau:
        x = t - s0
        return (s0 + 0.5 * (x + tau / np.pi * np.sin(np.pi * x / tau)),
                0.5 * (1 + np.cos(np.pi * x / tau)), -0.5 * np.pi / tau * np.sin(np.pi * x / tau))
    s1 = s0 + 0.5 * tau
    if t < ZUPT_T_RESUME:
        return s1, 0.0, 0.0
    if t < ZUPT_T_RESUME + tau:
        x = t - ZUPT_T_RESUME
        return (s1 + 0.5 * (x - tau / np.pi * np.sin(np.pi * x / tau)),
                0.5 * (1 - np.cos(np.pi * x / tau)), 0.5 * np.pi / tau * np.sin(np.pi * x / tau))
    return s1 + 0.5 * tau + (t - ZUPT_T_RESUME - tau), 1.0, 0.0


def zupt_admit(k: int) -> bool:
    """tests/test_zupt.py:_admit: every frame in motion, one frame in eight
    on the plateau (the motion filter's cadence), every frame from 8.8 s."""
    return k <= 45 or k >= 88 or (k - 46) % 8 == 0


def zupt_scene(n_frames: int, fps: float = COUPLED_FPS, imu_hz: float = 200.0):
    """tests/test_zupt.py:_simulate_warped: IMU rows consistent with the
    preintegrator's rule (midpoint rates, finite-difference specific force)
    and the frames' (R, p) of ms_body_state through zupt_warp."""
    from dbaf_tpu_torch.eval.synthetic import GRAVITY_W
    from dbaf_tpu_torch.fusion.se3np import so3_exp

    dt = 1.0 / imu_hz

    def vel(t):
        s, sp, _ = zupt_warp(t)
        return ms_body_state(s)[1] * sp

    def rate(t):
        s, sp, _ = zupt_warp(t)
        return ms_body_state(s)[3] * sp

    R = np.eye(3)
    rows = [np.concatenate([[0.0], np.rad2deg(rate(0.0)), -GRAVITY_W])]
    poses_at = {0: (R.copy(), ms_body_state(0.0)[0])}
    for k in range(int(round((n_frames / fps + 0.5) / dt))):
        t0k, t1k = k * dt, (k + 1) * dt
        w_m = rate(t0k + dt / 2)
        rows.append(np.concatenate([[t1k], np.rad2deg(w_m),
                                    R.T @ ((vel(t1k) - vel(t0k)) / dt - GRAVITY_W)]))
        R = R @ so3_exp(w_m * dt)
        fid = t1k * fps
        if abs(fid - round(fid)) < 1e-6:
            poses_at[int(round(fid))] = (R.copy(), ms_body_state(zupt_warp(t1k)[0])[0])
    return np.asarray(rows), poses_at


def georef_scene(n_frames: int, fps: float = COUPLED_FPS):
    """13a's scene and sensors: eval/synthetic's IMU simulation of
    whu_body_state, GNSS fixes at every frame (ECEF through the yawed ENU
    frame, no lever arm) and the body-frame velocity as odometry; ten0 is
    the first fix, as apps/demo_whu.py seeds it."""
    from unittest import mock

    from dbaf_tpu_torch.eval import synthetic

    with mock.patch.object(synthetic, "body_state", whu_body_state):
        rows, poses_at = synthetic.simulate_imu_and_poses(n_frames / fps + 0.5, fps=fps)
    gnss = np.asarray([[k / fps, *whu_ecef(poses_at[k][1])] for k in range(n_frames)])
    odo = np.asarray([[k / fps, *(poses_at[k][0].T @ whu_body_state(k / fps)[1])]
                      for k in range(n_frames)])
    sensors = dict(all_gnss=gnss, all_odo=odo, ten0=gnss[0, 1:4].copy())
    return (rows, poses_at, DEMO_FOCAL["whu"], DEMO_Z0["whu"]), sensors


def multisensor_config(kind: str, coupled_async: bool):
    """Phase 6's configuration; 13b with tests/test_zupt.py's cull and ZUPT
    settings (its keyframe threshold, in pixels of its 16-wide grid, scaled
    to this grid's width)."""
    cfg = coupled_config(coupled_async)
    if kind == "zupt":
        cfg.frontend.keyframe_thresh = 0.1 * cfg.feat_size[1] / 16.0
        cfg.frontend.translation_threshold = 0.2
        cfg.sensors.use_zupt = True
        cfg.sensors.zupt_vel_thresh = ZUPT_VEL_THRESH
    return cfg


def run_multisensor(dev, kind: str, coupled_async: bool) -> dict:
    """One 13a ("georef") or 13b ("zupt") run through DBAFusion's entry
    points.  The async run's steady-state frames run under sync-debug
    "error" (not the bias reinitialization's, nor the profiled last
    frames); counted: on the sync flow the keyframe steps and host reads
    from VI initialization on (phase 5's rate), on the async flow the async
    steps, blocking reads and host time of the guarded frames (phase 6's
    rate); LM passes, ZUPT fires (a wrapped Frontend._zupt_gate, as
    tests/test_zupt.py records them), the frame where init_gnss fired and
    the async steps before it; the last K1 and K2 launches' operands."""
    from dbaf_tpu_torch.ops import corr_cuda as cc
    from dbaf_tpu_torch.utils import device as devmod

    t_setup = time.perf_counter()
    n = MS_GEO_FRAMES if kind == "georef" else MS_ZUPT_FRAMES
    if kind == "georef":
        scene, sensors = georef_scene(n)
    else:
        scene, sensors = zupt_scene(n) + (ZUPT_FOCAL, ZUPT_Z0), None
    run = CoupledRun(dev, multisensor_config(kind, coupled_async), n, scene, sensors)
    system = run.system
    fe, g, coupled = system.frontend, system.graph, system.graph.coupled
    frames = [k for k in range(n) if kind == "georef" or zupt_admit(k)]
    fires, ops = [], {}
    gate = fe._zupt_gate

    def recording_gate(cur_t):
        fired = gate(cur_t)
        if fired:
            fires.append(float(cur_t))
        return fired

    k1, k2 = cc.corr_fused_xy, cc.corr_lookup

    def k1_kept(f1p, f2p, coords, H, W, *a, **kw):
        ops["k1"] = (f1p, f2p, coords, H, W)
        return k1(f1p, f2p, coords, H, W, *a, **kw)

    def k2_kept(vol, coords, *a, **kw):
        ops["k2"] = (vol, coords, *a)
        return k2(vol, coords, *a, **kw)

    fe._zupt_gate = recording_gate
    secs = dict(setup=time.perf_counter() - t_setup, frames=[])
    cc.reset_launch_counts()
    fg0 = fg_reset()
    cc.corr_fused_xy, cc.corr_lookup = k1_kept, k2_kept
    clock = dict(steps=0, reads=0, guarded=0, guarded_wall=0.0)  # the guarded async frames
    vi_frame = gnss_frame = steps_at_gnss = prof = None
    active_before_gnss = False
    lm_passes = 0
    try:
        for k in frames:
            ca = fe._casync
            active = ca is not None and ca.active
            reinit = coupled.vi_init_time > 0 and k / run.fps - coupled.vi_init_time > 5.0
            if k == frames[-MS_PROFILED]:
                if vi_frame is None:
                    raise SystemExit(f"multisensor {kind}: VI initialization did not trigger")
                torch.cuda.synchronize()
                clock.update(wall=time.perf_counter() - clock["t0"],
                             kf_steps=fe.keyframe_steps - clock["kf0"],
                             kf_reads=devmod.HOST_READS["count"] - clock["reads0"])
                prof = Profile()
            guard = coupled_async and active and not reinit and prof is None
            steps0, reads0 = (ca.total_steps if active else 0), devmod.HOST_READS["count"]
            megas0 = g.mega_count
            if guard:
                torch.cuda.set_sync_debug_mode("error")
            t_frame = time.perf_counter()
            try:
                run.track(k, devmod.upload)
            finally:
                if guard:
                    torch.cuda.set_sync_debug_mode(0)
            secs["frames"].append(time.perf_counter() - t_frame)
            if guard and ca.active:
                clock["guarded_wall"] += secs["frames"][-1]
                clock["steps"] += ca.total_steps - steps0
                clock["reads"] += devmod.HOST_READS["count"] - reads0
                clock["guarded"] += 1
            if not coupled_async and g.mega_count > megas0:
                lm_passes += int(torch.count_nonzero(g.lm_stats.cpu()))
            active_before_gnss |= (fe._casync is not None and fe._casync.active
                                   and coupled.gnss_init_t1 <= 0)
            if vi_frame is None and system.video.imu_enabled:
                vi_frame = k
                torch.cuda.synchronize()
                clock.update(t0=time.perf_counter(), kf0=fe.keyframe_steps,
                             reads0=devmod.HOST_READS["count"])
            if gnss_frame is None and coupled.gnss_init_t1 > 0:
                gnss_frame = k
                steps_at_gnss = fe._casync.total_steps if fe._casync is not None else 0
    finally:
        cc.corr_fused_xy, cc.corr_lookup = k1, k2
        fe._zupt_gate = gate
    torch.cuda.synchronize()
    t_prof = time.perf_counter()
    pr = prof.stop(f"multisensor_{kind}_{'async' if coupled_async else 'sync'}",
                   f"profile_multisensor_{kind}_{'async' if coupled_async else 'sync'}.txt",
                   MS_PROFILED)
    t_prof = time.perf_counter() - t_prof
    launches = {**cc.LAUNCHES, **fg_launches(fg0)}
    ca = fe._casync
    active_at_end = ca is not None and ca.active
    stats = ca.stats() if ca is not None else None
    traj = system.terminate()
    t1, lo = fe.t1, coupled.last_t0
    st = coupled.state
    stamps = np.asarray(system.video.tstamp[:t1])
    ids = np.round(stamps * run.fps).astype(int)
    res = dict(kind=kind, coupled_async=coupled_async, frames=len(frames), vi_frame=vi_frame,
               keyframe_steps=fe.keyframe_steps, update_rounds=fe.update_rounds,
               culls=fe.culls, rollups=fe.rollup_count, t1=t1, lo=lo,
               # phase 5's rate on the sync flow, phase 6's on the async one
               kf_per_s=(clock["steps"] / max(clock["guarded_wall"], 1e-9) if coupled_async
                         else clock["kf_steps"] / clock["wall"]),
               timed_steps=clock["steps"] if coupled_async else clock["kf_steps"],
               idle_share=pr["idle_share"], launches=launches, zupt_fires=fires,
               gnss_init_frame=gnss_frame, ecef_rows=len(system.trajectory_ecef),
               seconds=dict(setup=secs["setup"], profile_stop=t_prof,
                            to_vi_init=sum(secs["frames"][:frames.index(vi_frame) + 1]),
                            after_vi_init=sum(secs["frames"][frames.index(vi_frame) + 1:]),
                            slowest_frame=max(secs["frames"]),
                            slowest_at=frames[int(np.argmax(secs["frames"]))]))
    if coupled_async:
        res.update(async_steps=ca.total_steps if ca else 0, async_culls=ca.culls if ca else 0,
                   async_rollups=ca.rollups if ca else 0, active_at_end=active_at_end,
                   guarded_frames=clock["guarded"],
                   blocking_reads_per_step=clock["reads"] / max(clock["steps"], 1),
                   lm_passes_per_kf=stats["lm_passes"] / max(ca.total_steps, 1) if ca else 0.0,
                   steps_at_gnss_init=steps_at_gnss, active_before_gnss=active_before_gnss)
    else:
        res.update(host_reads_per_kf=clock["kf_reads"] / max(clock["kf_steps"], 1),
                   lm_passes_per_kf=lm_passes / max(g.mega_count, 1))
    # out of the printed line: what the checks compare
    res.update(traj=traj, stamps=stamps, poses_at=run.poses_at, ids=ids, ops=ops,
               pos=run.positions(), est=np.asarray([st.wTbs[i].t for i in range(lo, t1)]),
               ten0=None if coupled.ten0 is None else np.asarray(coupled.ten0),
               gnss_init_time=coupled.gnss_init_time, imu_enabled=system.video.imu_enabled)
    return res


def k2_path_check(operands) -> dict:
    """K2 on a path's gate operands (``(volume, coords[, whole])`` of a launch
    the run made) against its plain version, within K2_REL_TOL of its largest
    output (and phase 2's absolute K2_TOL), and its ms beside its bound."""
    from dbaf_tpu_torch.ops import corr_cuda as cc

    vol, coords, *whole = operands
    out = cc.corr_lookup(vol, coords, *whole)
    ref = cc.corr_lookup_plain(vol, coords, *whole)
    err = float((out - ref).abs().max())
    max_out = float(ref.abs().max())
    E, P, H2, W2 = vol.shape
    _, H, W, _ = coords.shape
    ms = graph_ms(lambda: cc.corr_lookup(vol, coords, *whole), 100)
    plain_ms = cuda_ms(lambda: cc.corr_lookup_plain(vol, coords, *whole), 3, warmup=1)
    peak = PEAK_BF16 if vol.dtype == torch.bfloat16 else PEAK_F32
    bms, by = bound(vol.numel() * vol.element_size() + E * P * 2 * 4 + E * P * 196 * 4,
                    lookup_flops(coords, H, W, False) / peak)
    return dict(E=E, grid=f"{H}x{W}", k2_err=err, k2_tol=max(K2_TOL, K2_REL_TOL * max_out),
                max_out=max_out, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)


def georef_check(r: dict) -> dict:
    """tests/test_georef.py:146-170 on a 13a run's live window: positions in
    the local frame at the system's ten0 against the truth there (max under
    0.08 x span, median under 0.05 x span) and the SE3-aligned ATE against
    the world truth under 0.05 x span."""
    from dbaf_tpu_torch.eval.ate import ate_rmse
    from dbaf_tpu_torch.utils import geodesy

    C0 = geodesy.Cen(r["ten0"])
    truth = [r["poses_at"][i][1] for i in r["ids"][r["lo"]:r["t1"]]]
    ref = np.asarray([C0.T @ (whu_ecef(p) - r["ten0"]) for p in truth])
    err = np.linalg.norm(r["est"] - ref, axis=1)
    span = float(np.linalg.norm(ref.max(0) - ref.min(0)))
    rmse = ate_rmse(r["est"], np.asarray(truth), align="se3")
    return dict(rows=len(ref), span=span, err_max=float(err.max()),
                err_median=float(np.median(err)), ate_se3=rmse,
                ok=bool(err.max() < 0.08 * span and np.median(err) < 0.05 * span
                        and rmse < 0.05 * span))


def window_ate(r: dict):
    """(SE3-aligned ATE of a run's live window, the window's span)."""
    from dbaf_tpu_torch.eval.ate import ate_rmse

    ref = np.stack([r["poses_at"][i][1] for i in r["ids"][r["lo"]:r["t1"]]])
    return ate_rmse(r["est"], ref, align="se3"), float(np.linalg.norm(ref.max(0) - ref.min(0)))


def plateau_rows(r: dict) -> dict:
    """13b's trajectory rows stamped on the plateau (ZUPT_T_STOP +
    ZUPT_TAU, ZUPT_T_RESUME) against the true stop point, the rows from VI
    initialization on SE3-aligned to the truth (the estimate's world frame
    is not the truth's): their number and largest distance."""
    from dbaf_tpu_torch.eval.ate import umeyama

    traj = r["traj"]
    t, pos = traj[:, 0], traj[:, 1:4].astype(np.float64)
    truth = np.stack([r["poses_at"][i][1] for i in np.round(t * COUPLED_FPS).astype(int)])
    vi = t >= r["vi_frame"] / COUPLED_FPS
    _, R, tw = umeyama(pos[vi], truth[vi], with_scale=False)
    on = (t > ZUPT_T_STOP + ZUPT_TAU) & (t < ZUPT_T_RESUME)
    stop_p = ms_body_state(zupt_warp(ZUPT_T_STOP + ZUPT_TAU)[0])[0]
    dev = np.linalg.norm(pos[on] @ R.T + tw - stop_p, axis=1)
    return dict(rows=int(on.sum()), max_dev=float(dev.max()) if on.any() else None)


def against_sync(a: dict, s: dict, tol: float) -> dict:
    """The async run against the sync run on the same frames: the keyframe
    stamps, the solved positions and the trajectory rows (phase 6's
    comparison with phase 5)."""
    same = a["traj"].shape == s["traj"].shape and np.array_equal(a["traj"][:, 0], s["traj"][:, 0])
    same &= np.array_equal(a["stamps"], s["stamps"])
    pos = (float(np.abs(a["pos"] - s["pos"]).max()) if a["pos"].shape == s["pos"].shape
           else float("inf"))
    rows = float(np.abs(a["traj"][:, 1:4] - s["traj"][:, 1:4]).max()) if same else float("inf")
    return dict(same_stamps=bool(same), max_pos_diff=pos, max_row_diff=rows,
                ok=bool(same and pos <= tol and rows <= tol))


def phase_multisensor(dev, card: str) -> dict:
    """Phase 13: the multi-sensor flagship on phase 6's configuration at
    full width.  13a: the georeferencing handoff with odometry
    (tests/test_georef.py:75), synchronous then asynchronous; 13b: ZUPT
    stop-and-go (tests/test_zupt.py:279,317), synchronous then asynchronous.
    Then K1 and K2 on a 13a run's last operands against their plain
    versions."""
    out = {}
    for kind in ("georef", "zupt"):
        for coupled_async in (False, True):
            t = time.perf_counter()
            r = run_multisensor(dev, kind, coupled_async)
            tag = f"{kind}_{'async' if coupled_async else 'sync'}"
            out[tag] = r
            log(f"[multisensor_{tag}] " + json.dumps(
                {k: v for k, v in r.items() if k not in ("traj", "stamps", "poses_at", "ids",
                                                         "ops", "pos", "est", "ten0")}))
            log(f"[time] 13 {tag} took {time.perf_counter() - t:.1f} s")
    gs, ga, zs, za = (out[k] for k in ("georef_sync", "georef_async", "zupt_sync", "zupt_async"))
    checks = []
    for r in (gs, ga, zs, za):
        tag = f"{r['kind']}_{'async' if r['coupled_async'] else 'sync'}"
        L = r["launches"]
        checks += [
            (r["imu_enabled"], f"{tag}: VI initialization did not trigger"),
            (np.all(np.isfinite(r["traj"])) and np.all(np.isfinite(r["est"])),
             f"{tag}: a pose is not finite"),
            (L["corr_fused_xy"] >= r["update_rounds"] > 0,
             f"{tag}: K1 launched {L['corr_fused_xy']} times for {r['update_rounds']} rounds"),
            (L["corr_lookup"] >= r["frames"] - 1,
             f"{tag}: K2 launched {L['corr_lookup']} times for {r['frames'] - 1} gated frames"),
            *fg_checks(tag, L),
        ]
    # 13a: tests/test_georef.py's assertions on both flows, async against sync
    geo = {k: georef_check(r) for k, r in (("sync", gs), ("async", ga))}
    geo_vs = against_sync(ga, gs, MS_ASYNC_TOL)
    checks += [
        (gs["gnss_init_frame"] is not None and ga["gnss_init_frame"] is not None,
         "13a: init_gnss did not fire"),
        (ga["steps_at_gnss_init"] == 0 and not ga["active_before_gnss"],
         "13a: the pipeline ran before georeferencing"),
        (ga["active_at_end"] and ga["async_steps"] >= 5,
         f"13a: the pipeline did not reactivate ({ga['async_steps']} async steps)"),
        (geo["sync"]["ok"] and geo["async"]["ok"], f"13a: georeferenced rows off: {geo}"),
        (gs["ecef_rows"] > 0 and ga["ecef_rows"] > 0, "13a: no ECEF trajectory row"),
        (geo_vs["ok"], f"13a: async against sync: {geo_vs}"),
        (ga["blocking_reads_per_step"] <= 3,
         f"13a: {ga['blocking_reads_per_step']} blocking reads per async step (bound 3)"),
    ]
    # 13b: tests/test_zupt.py:279's assertions on the sync flow, :317's on
    # async; the plateau bound on the trajectory rows, which cover the stop
    # (the live window, [lo, t1), holds only keyframes after the resume)
    n_feeds = sum(zupt_admit(k) for k in range(MS_ZUPT_FRAMES))
    plateau = {k: plateau_rows(r) for k, r in (("sync", zs), ("async", za))}
    (ate_s, span_s), (ate_a, _) = window_ate(zs), window_ate(za)
    fa, fs = set(np.round(za["zupt_fires"], 6)), set(np.round(zs["zupt_fires"], 6))
    zupt = dict(fires_sync=len(fs), fires_async=len(fa), fire_diff=len(fa ^ fs),
                first_fire=min(zs["zupt_fires"], default=None),
                last_fire=max(zs["zupt_fires"], default=None),
                first_fire_async=min(za["zupt_fires"], default=None), plateau=plateau,
                ate_share_sync=ate_s / span_s, ate_share_async=ate_a / span_s,
                ate_rule=max(1.3 * ate_s, ate_s + 0.005 * span_s) / span_s,
                max_pos_diff=(float(np.abs(za["est"] - zs["est"]).max())
                              if za["est"].shape == zs["est"].shape else float("inf")))
    first_gap = (abs(zupt["first_fire_async"] - zupt["first_fire"])
                 if zupt["first_fire"] is not None and zupt["first_fire_async"] is not None
                 else float("inf"))
    checks += [
        (zs["t1"] <= n_feeds - 8, f"13b: the plateau did not cull ({zs['t1']} of {n_feeds})"),
        (len(fs) >= 3 and len(fa) >= 3, f"13b: ZUPT fired {len(fs)} and {len(fa)} times"),
        (zupt["first_fire"] is not None and zupt["first_fire"] >= ZUPT_T_STOP + 3.0
         and zupt["last_fire"] <= ZUPT_T_RESUME + ZUPT_TAU, f"13b: ZUPT fired off the plateau "
         f"({zupt['first_fire']}, {zupt['last_fire']})"),
        (all(p["rows"] > 0 and p["max_dev"] < 0.10 for p in plateau.values()),
         f"13b: plateau rows off the stop point: {plateau}"),
        (ate_s < 0.08 * span_s and ate_a < 0.08 * span_s,
         f"13b: ATE {ate_s} m (sync), {ate_a} m (async) not under 0.08 x span ({span_s} m)"),
        (za["async_steps"] >= 10 and za["async_culls"] >= 6,
         f"13b: {za['async_steps']} async steps, {za['async_culls']} culls in the pipeline"),
        (za["t1"] == zs["t1"] and np.array_equal(za["stamps"], zs["stamps"]),
         "13b: the async run's keyframes differ from the sync run's"),
        (len(fa ^ fs) <= 2, f"13b: ZUPT fires differ: {sorted(fa ^ fs)}"),
        (first_gap <= 2.0 / COUPLED_FPS + 1e-9,
         f"13b: first ZUPT fires {zupt['first_fire_async']} (async) and {zupt['first_fire']} "
         "(sync) more than two frames apart"),
        # tests/test_zupt.py:345-347's async-against-sync bounds (positions
        # within 5e-2 m, the ATE rule) are not held at this BA window of 44:
        # there the JAX package's own async run misses both
        # (tests/test_torch_async_zupt_window44.py, ROADMAP Queue 3); printed
    ]
    for ok, msg in checks:
        if not ok:
            raise SystemExit("multisensor: " + msg)
    # K1 and K2 on the operands of 13a's async run's last launches
    k1c = k1_round_check(ga["ops"]["k1"])
    k2c = k2_path_check(ga["ops"]["k2"])
    log(f"[multisensor] K1 on a 13a round's operands: {json.dumps(k1c)}")
    log(f"[multisensor] K2 on a 13a gate's operands: {json.dumps(k2c)}")
    if not k1c["k1_err"] <= k1c["k1_tol"]:
        raise SystemExit(f"multisensor: K1 off its plain version on 13a's operands: {k1c}")
    if not k2c["k2_err"] <= k2c["k2_tol"]:
        raise SystemExit(f"multisensor: K2 off its plain version on 13a's operands: {k2c}")
    for r in (gs, ga, zs, za):
        tag = f"{r['kind']}_{'async' if r['coupled_async'] else 'sync'}"
        extra = (f"{r['blocking_reads_per_step']:.3f} blocking reads an async step"
                 if r["coupled_async"] else f"{r['host_reads_per_kf']:.3f} host reads a keyframe")
        log(f"[multisensor_{tag}] {r['kf_per_s']:.3f} kf/s after VI init ({r['timed_steps']} "
            f"steps), {extra}, {r['lm_passes_per_kf']:.3f} LM passes a keyframe, idle share "
            f"{r['idle_share']:.3f}, ZUPT fires {len(r['zupt_fires'])}, GNSS init frame "
            f"{r['gnss_init_frame']} on {card}")
    log(f"[multisensor] 13a georeferenced: {json.dumps(geo)}; async against sync "
        f"{json.dumps(geo_vs)}; ATE {geo['sync']['ate_se3'] / geo['sync']['span']:.4f} (sync) "
        f"and {geo['async']['ate_se3'] / geo['async']['span']:.4f} (async) of the span on {card}")
    log(f"[multisensor] 13b ZUPT: {json.dumps(zupt)} on {card}")
    return dict(runs=out, k1=k1c, k2=k2c, georef=geo, georef_vs_sync=geo_vs, zupt=zupt)


RANKS = 2
BA_ITERS_TIMED = 10
# 12a: tests/test_parallel.py:57-58's bounds, the ranks and one process
# both in f64 (in f32 the solve itself lies about 3e-4 from f64 at P = 44
# and 48 x 64, so two f32 summation orders cannot be held to 2e-5); the
# f32 iteration is timed
BA_TOL_POSES, BA_TOL_DISPS = 2e-5, 2e-4
SV_TOL_POSES, SV_TOL_DISPS = 1e-5, 1e-4   # tests/test_shard_video.py:85-86
N_SHARD_MAIN, N_SHARD_COUPLED = N_FRAMES, 36  # 12d: phase 3's frames; VI init and async steps
SHARD_TRAIN_TIMED = 3
WORLD1_BACKEND = "nccl"  # 12b: the production backend, a world of one
# 12c: a sharded step against the single-process one, each measure at most
# SPREAD_FACTOR times the spread of two single-process steps, the second on
# images moved by TRAIN_EPS intensity levels: a sharded step sums the edges'
# and tuples' terms in another order, a change at the rounding level, and
# the unroll amplifies such a change as it amplifies that one (phase 9a's
# train_spread).  Floors: f32 rounding of a sum in another order for the
# loss and the gradient, and 2 lr for a parameter (AdamW's first step moves
# an entry by about lr times the sign of its gradient, so an entry whose
# gradient is at the noise can move either way; that measure catches only
# a step of another size).  The bf16 spread is large (an image level moves
# the gradients by percents), so the dp 2 step, which runs each tuple
# through the single-process code, is also held by phase 9a's parity bounds
# (step_parity: each leaf's gradient within 1e-3 of its norm), and a step
# with its gradients not summed over dp (the planted fault) must fail them
SPREAD_FACTOR, LOSS_FLOOR, GRAD_FLOOR = 10.0, 1e-6, 1e-5
# TRAIN_EPS is phase 9a's (f32); the bf16 network rounds its normalized
# input to 8 bits, which swallows 1e-4, so its images move by one level
TRAIN_EPS, TRAIN_EPS_BF16 = 1e-4, 1.0


def sharded_ba_window(seed: int = 0) -> dict:
    """12a's window (numpy): bench.py's coupled window (P = 44 of phase 5's
    48 x 64 grid) on phase 5's synthetic scene, the 170 edges |i - j| in
    {1, 2}, targets the true reprojections plus 0.25 px noise, weights in
    [0.2, 1], poses perturbed by 0.01 (slot 0 fixed) and disparities by 2 %."""
    from dbaf_tpu_torch.eval.synthetic import scene_from_poses, simulate_imu_and_poses
    from dbaf_tpu_torch.ops import lie
    from dbaf_tpu_torch.ops import projective as pj

    cfg = coupled_config()
    P, (H8, W8) = cfg.ba.window, cfg.feat_size
    intr8 = np.asarray([2.0 * W8, 2.0 * W8, W8 / 2, H8 / 2], np.float32)
    _, poses_at = simulate_imu_and_poses(P / COUPLED_FPS + 0.5, fps=COUPLED_FPS)
    gt_cw, gt_disps = scene_from_poses(poses_at, P, intr8, H8, W8)
    gt_cw, gt_disps = torch.as_tensor(gt_cw[:P]), torch.as_tensor(gt_disps[:P])
    ai, aj = np.meshgrid(np.arange(P), np.arange(P), indexing="ij")
    keep = (np.abs(ai - aj) >= 1) & (np.abs(ai - aj) <= 2)
    ii, jj = torch.as_tensor(ai[keep]), torch.as_tensor(aj[keep])
    tgt, _ = pj.projective_transform(gt_cw, gt_disps, torch.as_tensor(intr8), ii, jj)
    rng = np.random.default_rng(seed)
    E = ii.shape[0]
    xi = rng.normal(size=(P, 6)).astype(np.float32) * 0.01
    xi[0] = 0.0
    return dict(
        poses=lie.se3_retr(gt_cw, torch.as_tensor(xi)).numpy(),
        disps=(gt_disps.numpy() * (1 + 0.02 * rng.standard_normal((P, H8, W8)))).astype(np.float32),
        intr=intr8, eta=np.full((P, H8 * W8), 1e-4, np.float32),
        targets=(tgt.numpy() + 0.25 * rng.standard_normal(tgt.shape)).astype(np.float32),
        weights=rng.uniform(0.2, 1.0, size=tgt.shape).astype(np.float32),
        ii=ii.numpy(), jj=jj.numpy(), mask=np.ones(E, bool))


def _ba_args(w: dict, dev, sl=slice(None), dtype=torch.float32):
    t = {k: torch.as_tensor(v).to(dev) for k, v in w.items()}
    t = {k: v.to(dtype) if v.dtype == torch.float32 else v for k, v in t.items()}
    return ((t["poses"], t["disps"], t["intr"]), (t["targets"][sl], t["weights"][sl]), t["eta"],
            (t["ii"][sl], t["jj"][sl], t["mask"][sl]))


def rank_sharded_ba(dev, w: dict, iters_timed: int) -> dict:
    """12a/12b on one rank: sharded_ba_step (two iterations) on this rank's
    edges in f64, then ms an f32 iteration of make_sharded_ba_iteration
    over ``iters_timed`` chained iterations (the host-staged collectives
    included)."""
    from dbaf_tpu_torch.parallel import dist, make_mesh, make_sharded_ba_iteration
    from dbaf_tpu_torch.parallel import sharded_ba_step

    mesh = make_mesh()
    sl = dist.process_edge_slice(w["ii"].shape[0])
    (p, d, intr), (tg, wg), eta, (ii, jj, m) = _ba_args(w, dev, sl, dtype=torch.float64)
    P = p.shape[0]
    out = sharded_ba_step(mesh)(p, d, intr, tg, wg, eta, ii, jj, m, 1, P)
    (p, d, intr), (tg, wg), eta, (ii, jj, m) = _ba_args(w, dev, sl)
    step = make_sharded_ba_iteration(mesh, P)
    for _ in range(2):
        step(p, d, intr, tg, wg, eta, ii, jj, m, 1, P)
    torch.cuda.synchronize(dev)
    t = time.perf_counter()
    tp, td = p, d
    for _ in range(iters_timed):
        tp, td = step(tp, td, intr, tg, wg, eta, ii, jj, m, 1, P)
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t) / iters_timed * 1e3
    return dict(poses=out.poses.cpu().numpy(), disps=out.disps.cpu().numpy(), iter_ms=ms,
                edges=int(ii.shape[0]), backend=torch.distributed.get_backend())


def feature_frames(n: int = 4) -> np.ndarray:
    """The first ``n`` of phase 3's 384 x 512 frames, (n, H, W, 3) uint8."""
    from dbaf_tpu_torch.utils.config import tumvi_config

    frame, _ = main_frames(tumvi_config())
    return np.stack([frame(k) for k in range(n)])


def _feature_model(dev):
    from dbaf_tpu_torch.models.net import DroidNet

    model = DroidNet(device=dev)
    model.load_state_dict(seeded_params(20260820))
    return model


def rank_features(dev, images: np.ndarray) -> list:
    """sharded_feature_step of the seeded network: this rank extracts its
    share of ``images``; returns every frame's (fmaps, net, inp) as f32."""
    from dbaf_tpu_torch.parallel import dist, make_mesh, sharded_feature_step

    sl = dist.process_edge_slice(images.shape[0])
    out = sharded_feature_step(make_mesh(), _feature_model(dev))(
        torch.as_tensor(images[sl]).to(dev))
    return [x.float().cpu().numpy() for x in out]


def _train_model(dev, tiny: bool):
    """12c's network: phase 9b's (bf16, the seeded checkpoint) or phase
    9a's (f32, drawn from seed 0, the delta head scaled by 0.01)."""
    from dbaf_tpu_torch.models.net import DroidNet

    if tiny:
        model = DroidNet(dtype=torch.float32, device="cpu").init_weights(
            torch.Generator().manual_seed(0))
        with torch.no_grad():
            model.update.delta_2.weight.mul_(0.01)
            model.update.delta_2.bias.mul_(0.01)
        return model.to(dev)
    model = DroidNet(device=dev)
    model.load_state_dict(seeded_params(20260820))
    return model


def train_run(dev, tiny: bool, mesh_shape=None, timed: int = 0, eps: float = 0.0) -> dict:
    """One make_train_step step from 12c's weights: phase 9b's batch of two
    tuples (full width, num_steps 12, bf16, make_optimizer() at its
    defaults) or, ``tiny``, phase 9a's tuple (f32, 96 x 128, num_steps 2,
    lr 1e-4); on a (dp, edge) mesh of the job's ranks when ``mesh_shape``
    is given, this rank's share of the batch; the images moved by ``eps``
    intensity levels.  Then ``timed`` more steps.
    Returns the step's loss, the gradients and the updated parameters (f32
    numpy), s/step over the timed steps and the peak memory."""
    from dbaf_tpu_torch.parallel import make_mesh_2d
    from dbaf_tpu_torch.train.trainer import make_optimizer, make_train_step, shard_batch

    model = _train_model(dev, tiny)
    if tiny:
        batch, opt = tiny_train_batch("cpu", 0, n=4, h8=12, w8=16), \
            make_optimizer(model.parameters(), lr=1e-4, total_steps=2)
        num_steps = 2
    else:
        batch, opt, num_steps = full_train_batch("cpu", 2), make_optimizer(model.parameters()), 12
    batch["images"] = batch["images"] + eps
    mesh = None if mesh_shape is None else make_mesh_2d(*mesh_shape)
    batch = ({k: v.to(dev) for k, v in batch.items()} if mesh is None
             else shard_batch(batch, mesh, device=dev))
    step = make_train_step(model, opt, num_steps=num_steps, fixedp=2, mesh=mesh)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    loss = float(step(batch)["loss"])
    res = dict(loss=loss,
               grads={k: p.grad.float().cpu().numpy().copy() for k, p in model.named_parameters()
                      if p.grad is not None},
               params={k: p.detach().float().cpu().numpy().copy()
                       for k, p in model.named_parameters()},
               tuples=int(batch["images"].shape[0]), edges=int(batch["ii"].shape[1]))
    if timed:
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        for _ in range(timed):
            step(batch)
        torch.cuda.synchronize(dev)
        res["s_per_step"] = (time.perf_counter() - t) / timed
    res["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    return res


def _feature_bytes(video) -> int:
    return sum(getattr(video, n).numel() * getattr(video, n).element_size()
               for n in ("fmaps", "nets", "inps"))


def video_main_run(dev, shard: bool, n_frames: int = N_SHARD_MAIN) -> dict:
    """Phase 3's path (DBAFusion at tumvi_config(), the seeded network,
    every frame admitted) with ``cfg.shard_video``: live poses and
    disparities, steady-state kf/s, the launch counts, this rank's bytes of
    fmaps + nets + inps."""
    from dbaf_tpu_torch.ops import corr_cuda as cc
    from dbaf_tpu_torch.slam.system import DBAFusion
    from dbaf_tpu_torch.utils.config import tumvi_config

    cfg = tumvi_config()
    cfg.frontend.filter_thresh = -1.0
    cfg.shard_video = shard
    system = DBAFusion(cfg, params=seeded_params(20260820), device=dev)
    frames = feature_frames(n_frames)
    _, intr = main_frames(cfg)
    fe = system.frontend
    cc.reset_launch_counts()
    t0 = None
    for k in range(n_frames):
        if fe.is_initialized and t0 is None:
            torch.cuda.synchronize(dev)
            t0, steps0 = time.perf_counter(), fe.keyframe_steps
        system.track(float(k), frames[k], intrinsics=intr)
    torch.cuda.synchronize(dev)
    kfs = (fe.keyframe_steps - steps0) / (time.perf_counter() - t0)
    launches = dict(cc.LAUNCHES)
    v = system.video
    n = v.counter
    traj = system.terminate()
    return dict(poses=v.poses[:n].cpu().numpy(), disps=v.disps[:n].cpu().numpy(), traj=traj,
                kf_per_s=kfs, launches=launches, feature_bytes=_feature_bytes(v),
                sharded=v.kf_group is not None, steps=fe.keyframe_steps)


def video_coupled_run(dev, shard: bool, n_frames: int = N_SHARD_COUPLED) -> dict:
    """Phase 6's configuration (the asynchronous coupled pipeline) for
    ``n_frames`` frames with ``cfg.shard_video``: the keyframes' solved
    body positions and disparities, kf/s over the frames the pipeline ran,
    the async steps, culls and rollups inside it, launch counts, this
    rank's feature bytes."""
    from dbaf_tpu_torch.ops import corr_cuda as cc
    from dbaf_tpu_torch.utils import device as devmod

    cfg = coupled_config(coupled_async=True)
    cfg.shard_video = shard
    run = CoupledRun(dev, cfg, n_frames)
    fe = run.system.frontend
    cc.reset_launch_counts()
    wall, steps = 0.0, 0
    for k in range(n_frames):
        ca = fe._casync
        active = ca is not None and ca.active
        steps0 = ca.total_steps if active else 0
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        run.track(k, devmod.upload)
        torch.cuda.synchronize(dev)
        if active and ca.active:
            wall += time.perf_counter() - t
            steps += ca.total_steps - steps0
    ca = fe._casync
    if ca is None:
        raise SystemExit("video_coupled: the asynchronous pipeline never activated")
    launches = dict(cc.LAUNCHES)
    v = run.system.video
    t1 = fe.t1
    disps = v.disps[:t1].cpu().numpy()
    traj = run.system.terminate()
    return dict(pos=run.positions(), disps=disps, traj=traj, launches=launches,
                kf_per_s=steps / wall if wall else 0.0, async_steps=ca.total_steps,
                culls=ca.culls, rollups=ca.rollups, feature_bytes=_feature_bytes(v),
                sharded=v.kf_group is not None)


def train_run_unsummed(dev) -> dict:
    """12c's planted fault: train_dp's step with the gradients left unsummed
    over the dp ranks (``trainer._sum_gradients`` a no-op), each rank
    stepping on its own tuple's half of the gradient."""
    from dbaf_tpu_torch.train import trainer

    summed = trainer._sum_gradients
    trainer._sum_gradients = lambda params, groups: None
    try:
        return train_run(dev, False, (RANKS, 1))
    finally:
        trainer._sum_gradients = summed


def rank_phase12(jobs, device: str) -> dict:
    """Phase 12's work on one rank, job by job (``(name, args)``), on
    ``device`` (the card).  The video jobs come last: ``cfg.shard_video``
    turns on deterministic algorithms in the process
    (``slam/video.py``)."""
    from dbaf_tpu_torch.parallel import dist

    dev = dist.rank_device(device)
    out = {}
    for name, args in jobs:
        t = time.perf_counter()
        if name == "ba":
            out[name] = rank_sharded_ba(dev, *args)
        elif name == "features":
            out[name] = dict(maps=rank_features(dev, *args))
        elif name == "train_dp":
            out[name] = train_run(dev, False, (RANKS, 1), *args)
        elif name == "train_dp_fault":
            out[name] = train_run_unsummed(dev)
        elif name == "train_edge":
            out[name] = train_run(dev, True, (1, RANKS))
        elif name in ("video_main", "video_coupled"):
            fn = video_main_run if name == "video_main" else video_coupled_run
            out[name] = fn(dev, True, *args)
        else:
            raise ValueError(name)
        out[name]["seconds"] = time.perf_counter() - t
    return out


def _rank_workdir(name: str) -> str:
    return os.path.join(ROOT, "dbaf_tpu_torch", "_build", "ranks", name)


def run_ranks(dev, world: int, jobs, backend: str, timeout: float) -> list:
    """rank_phase12(jobs) on ``world`` spawned ranks on ``dev`` (the card);
    a rank that fails (or the timeout) fails the phase, and every rank is
    stopped."""
    from dbaf_tpu_torch.parallel import launch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the ranks share the card with this process
    return launch.run(rank_phase12, world, (jobs, dev.type),
                      workdir=_rank_workdir(f"{backend}{world}"), backend=backend,
                      device=dev.type, timeout=timeout)


def _train_measures(a: dict, b: dict) -> dict:
    """Loss (relative), gradients (relative L2 over every leaf) and the
    updated parameters (worst absolute) of two training steps."""
    num = sum(float(np.sum((a["grads"][k] - g) ** 2)) for k, g in b["grads"].items())
    den = sum(float(np.sum(g ** 2)) for g in b["grads"].values())
    return dict(loss=abs(a["loss"] - b["loss"]) / abs(b["loss"]), grad=(num / den) ** 0.5,
                param=max(float(np.max(np.abs(a["params"][k] - p))) for k, p in b["params"].items()))


def _as_step(r: dict) -> tuple:
    return r["loss"], r["grads"], r["params"]


def _hold_dp(ranks: list, singles: list, card: str) -> dict:
    """12c's dp 2 step against one process's B = 2 step: within
    SPREAD_FACTOR times the spread of two single steps (_hold_train) and by
    phase 9a's parity bounds (step_parity), and the planted fault (the
    gradients not summed over dp) failing the parity bounds."""
    lr0 = 2.5e-4 / 25  # make_optimizer()'s first-step lr
    out = _hold_train("train_dp", [r["train_dp"] for r in ranks], singles, lr0, TRAIN_EPS_BF16,
                      card)
    ref = _as_step(singles[0])
    held = [step_parity(_as_step(r["train_dp"]), ref, lr0) for r in ranks]
    fault = [step_parity(_as_step(r["train_dp_fault"]), ref, lr0) for r in ranks]
    fault_grad = max(_train_measures(r["train_dp_fault"], singles[0])["grad"] for r in ranks)
    for k, m in enumerate(held):
        log(f"[train_dp] rank {k} against one process's B = 2 step: {parity_line(m)} on {card}")
    log(f"[train_dp] planted fault, the gradients not summed over dp: worst leaf gradient "
        f"{max(f['grad_rel'] for f in fault):.3e} of its norm (bound {TRAIN_GRAD_TOL:g}), "
        f"gradients {fault_grad:.3e} over every leaf (spread bound {out['tol']['grad']:.3e}); "
        f"{min(len(f['bad']) for f in fault)} measures past their parity bounds on a rank")
    if any(m["bad"] for m in held):
        raise SystemExit(f"train_dp: the sharded step differs from the single one "
                         f"({[m['bad'][:6] for m in held]})")
    if not all(f["bad"] for f in fault):
        raise SystemExit("train_dp: the planted fault passed the parity bounds")
    out.update(parity=[{k: v for k, v in m.items() if k != "bad"} for m in held],
               fault_grad_rel=[f["grad_rel"] for f in fault], fault_grad=fault_grad)
    return out


def _hold_train(tag: str, ranks: list, singles: list, lr0: float, eps: float, card: str) -> dict:
    spread = _train_measures(singles[1], singles[0])
    tol = dict(loss=max(SPREAD_FACTOR * spread["loss"], LOSS_FLOOR),
               grad=max(SPREAD_FACTOR * spread["grad"], GRAD_FLOOR),
               param=max(SPREAD_FACTOR * spread["param"], 2 * lr0))
    worst = {k: 0.0 for k in tol}
    for r in ranks:
        if r["grads"].keys() != singles[0]["grads"].keys():
            raise SystemExit(f"{tag}: a rank's gradient leaves differ from the single step's")
        m = _train_measures(r, singles[0])
        worst = {k: max(worst[k], m[k]) for k in m}
        if not np.isfinite(r["loss"]):
            raise SystemExit(f"{tag}: a rank's loss is not finite")
    log(f"[{tag}] sharded against single: loss {worst['loss']:.3e} (bound {tol['loss']:.3e}), "
        f"gradients {worst['grad']:.3e} (bound {tol['grad']:.3e}), parameters "
        f"{worst['param']:.3e} (bound {tol['param']:.3e}); spread of two single steps "
        f"(images moved by {eps:g}): loss "
        f"{spread['loss']:.3e}, gradients {spread['grad']:.3e}, parameters "
        f"{spread['param']:.3e} on {card}")
    bad = [k for k in tol if worst[k] > tol[k]]
    if bad:
        raise SystemExit(f"{tag}: the sharded step differs from the single one in {bad}")
    return dict(worst=worst, tol=tol, spread=spread)


def _hold_video(tag: str, ranks: list, singles: list, keys, card: str) -> dict:
    """The ranks' rows against the first single run (one process with the
    flag), within the larger of the two single runs' spread and the
    reference's bounds; the ranks' distance from each other is printed."""
    a, b = singles
    out = {}
    for key, ref_tol in zip(keys, (SV_TOL_POSES, SV_TOL_DISPS)):
        if a[key].shape != b[key].shape:
            raise SystemExit(f"{tag}: two single runs kept different keyframes")
        spread = float(np.max(np.abs(a[key] - b[key])))
        tol = max(spread, ref_tol)
        diff = 0.0
        for r in ranks:
            if r[key].shape != a[key].shape:
                raise SystemExit(f"{tag}: a rank kept {r[key].shape} {key}, one process "
                                 f"{a[key].shape}")
            diff = max(diff, float(np.max(np.abs(r[key] - a[key]))))
        apart = max(float(np.max(np.abs(r[key] - ranks[0][key]))) for r in ranks)
        log(f"[{tag}] {key}: ranks {diff:.3e} from one process (bound {tol:.3e}: the spread "
            f"of two single runs {spread:.3e} or the reference's {ref_tol:g}), {apart:.3e} from "
            f"each other on {card}")
        if not diff <= tol:
            raise SystemExit(f"{tag}: the sharded {key} are {diff} from one process's")
        out[key] = dict(diff=diff, spread=spread, tol=tol, apart=apart)
    if not all(np.all(np.isfinite(r["traj"])) for r in ranks):
        raise SystemExit(f"{tag}: a rank's trajectory is not finite")
    if not all(r["sharded"] for r in ranks) or any(s["sharded"] for s in singles):
        raise SystemExit(f"{tag}: the ranks did not shard the video, or one process did")
    for r in ranks:
        if 2 * r["feature_bytes"] != a["feature_bytes"]:
            raise SystemExit(f"{tag}: a rank holds {r['feature_bytes']} feature bytes of "
                             f"{a['feature_bytes']}")
    return out


def phase_multi_device(dev, train_peak: int, card: str) -> dict:
    """Phase 12: the parallel layer on the card (see the module docstring)."""
    from dbaf_tpu_torch.ops import dba

    res = {}
    # ---- single-process references first, then the ranks
    w = sharded_ba_window()
    (p, d, intr), (tg, wg), eta, (ii, jj, m) = _ba_args(w, dev)
    P = p.shape[0]
    single = dba.ba(p, d, intr, tg, wg, eta, ii, jj, m, 1, P, iterations=2)
    for _ in range(2):
        dba.ba(p, d, intr, tg, wg, eta, ii, jj, m, 1, P, iterations=1)
    torch.cuda.synchronize()
    t = time.perf_counter()
    tp, td = p, d
    for _ in range(BA_ITERS_TIMED):
        tp, td = dba.ba(tp, td, intr, tg, wg, eta, ii, jj, m, 1, P, iterations=1)
    torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t) / BA_ITERS_TIMED * 1e3
    (p64, d64, intr64), (tg64, wg64), eta64, _ = _ba_args(w, dev, dtype=torch.float64)
    s64 = dba.ba(p64, d64, intr64, tg64, wg64, eta64, ii, jj, m, 1, P, iterations=2)
    ba64 = (s64.poses.cpu().numpy(), s64.disps.cpu().numpy())
    own = [float(np.max(np.abs(a.double().cpu().numpy() - b)))
           for a, b in zip((single.poses, single.disps), ba64)]

    t = time.perf_counter()
    frames = feature_frames()
    with torch.no_grad():
        fmodel = _feature_model(dev)
        x = torch.as_tensor(frames).to(dev)
        per_rank = [fmodel.extract_features(x[k:k + 2]) for k in (0, 2)]
        single_feat = [torch.cat(a).float().cpu().numpy() for a in zip(*per_rank)]
        whole_feat = [a.float().cpu().numpy() for a in fmodel.extract_features(x)]
        del fmodel, x, per_rank
    train_single = [train_run(dev, False, eps=e) for e in (0.0, TRAIN_EPS_BF16)]
    tiny_single = [train_run(dev, True, eps=e) for e in (0.0, TRAIN_EPS)]
    # the flag in a world of one: no sharding, and the numerics the ranks
    # run (cfg.shard_video turns on deterministic algorithms, slam/video.py);
    # the rest of this process runs without them, as before
    try:
        main_single = [video_main_run(dev, True) for _ in range(2)]
        coupled_single = [video_coupled_run(dev, True) for _ in range(2)]
    finally:
        torch.use_deterministic_algorithms(False)
    log(f"[time] phase 12 single-process references took {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    ranks = run_ranks(dev, RANKS, [("ba", (w, BA_ITERS_TIMED)), ("features", (frames,)),
                                   ("train_dp", (SHARD_TRAIN_TIMED,)), ("train_dp_fault", ()),
                                   ("train_edge", ()), ("video_main", ()), ("video_coupled", ())],
                      "gloo", 900)
    jobs_s = ", ".join("%s %.1f s" % (k, v["seconds"]) for k, v in ranks[0].items())
    log(f"[time] phase 12 {RANKS} gloo ranks took {time.perf_counter() - t:.1f} s "
        f"(rank 0: {jobs_s})")

    # ---- 12a: edge-sharded BA, two gloo ranks
    def hold_ba(tag, outs):
        dp, dd = (max(float(np.max(np.abs(o[k] - ref))) for o in outs)
                  for k, ref in zip(("poses", "disps"), ba64))
        log(f"[{tag}] {len(outs)} {outs[0]['backend']} rank(s), {outs[0]['edges']} of "
            f"{w['ii'].shape[0]} edges each, P = {P}, f64: from one process's f64 dba.ba poses "
            f"{dp:.3e} (bound {BA_TOL_POSES:g}), disps {dd:.3e} (bound {BA_TOL_DISPS:g}); the "
            f"single-process f32 solve {own[0]:.3e}, {own[1]:.3e} from the f64 one (printed); "
            f"{outs[0]['iter_ms']:.3f} ms a sharded f32 iteration, {single_ms:.3f} ms a "
            f"single-process one on {card}")
        if not (dp <= BA_TOL_POSES and dd <= BA_TOL_DISPS):
            raise SystemExit(f"{tag}: the sharded BA is off (poses {dp}, disps {dd})")
        return dict(poses=dp, disps=dd, own_f32=own, iter_ms=outs[0]["iter_ms"],
                    single_ms=single_ms)

    res["ba"] = hold_ba("sharded_ba", [r["ba"] for r in ranks])

    # frame-parallel features: bit-equal to one process on the same batches
    feat_diff = max(float(np.max(np.abs(a - b))) for r in ranks
                    for a, b in zip(r["features"]["maps"], single_feat))
    whole_diff = max(float(np.max(np.abs(a - b) / max(float(np.max(np.abs(b))), 1e-30)))
                     for a, b in zip(ranks[0]["features"]["maps"], whole_feat))
    log(f"[sharded_features] {RANKS} ranks, 2 of 4 of phase 3's frames each (fmaps "
        f"{ranks[0]['features']['maps'][0].shape}): {feat_diff:.3e} from one process on the same "
        f"two-frame batches (bound 0: the same kernels on the same batches); "
        f"{whole_diff:.3e} of the largest output from one 4-frame batch (printed) on {card}")
    if feat_diff != 0.0:
        raise SystemExit(f"sharded_features: {feat_diff} from one process's features")
    res["features"] = dict(diff=feat_diff, whole_rel=whole_diff)

    # ---- 12b: a world of one over NCCL: the worker CLI and the sharded step
    t = time.perf_counter()
    nccl = run_ranks(dev, 1, [("ba", (w, BA_ITERS_TIMED))], WORLD1_BACKEND, 300)
    res["ba_nccl"] = hold_ba("sharded_ba_nccl", [nccl[0]["ba"]])
    out = os.path.join(_rank_workdir("worker"), "worker.npz")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    store = os.path.join(_rank_workdir("worker"), f"store-{time.time_ns()}")
    import dbaf_tpu_torch

    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(dbaf_tpu_torch.__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "dbaf_tpu_torch.parallel.dist_worker", "--process-id", "0",
         "--num-processes", "1", "--coordinator", f"file://{store}", "--device", dev.type,
         "--backend", WORLD1_BACKEND, "--time", str(BA_ITERS_TIMED), "--out", out],
        cwd=pkg_root, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=pkg_root))
    if proc.returncode != 0:
        raise SystemExit(f"dist_worker over NCCL failed ({proc.returncode}):\n{proc.stderr[-3000:]}")
    wk = np.load(out)
    metric = json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("{")][-1])
    if not (np.all(np.isfinite(wk["poses"])) and np.all(np.isfinite(wk["disps"]))
            and float(wk["iter_ms"]) > 0 and metric["backend"] == WORLD1_BACKEND):
        raise SystemExit(f"dist_worker over NCCL gave {metric}")
    res["worker_nccl_ms"] = float(wk["iter_ms"])
    log(f"[worker_nccl] dist_worker, world 1 over {metric['backend']} on {metric['device']}: "
        f"{float(wk['iter_ms']):.3f} ms an iteration (window 16, 128 edges at 24x32; "
        f"{time.perf_counter() - t:.1f} s with the world-1 step) on {card}")

    # ---- 12c: the sharded training step
    res["train_dp"] = _hold_dp(ranks, train_single, card)
    peaks = [r["train_dp"]["peak_bytes"] for r in ranks]
    s_step = [r["train_dp"]["s_per_step"] for r in ranks]
    log(f"[train_dp] dp {RANKS} x edge 1, {ranks[0]['train_dp']['tuples']} tuple a rank "
        f"(7 frames at 384x512, 22 edges, num_steps 12, bf16): "
        f"{', '.join(f'{s:.4f}' for s in s_step)} s/step, peak "
        f"{', '.join(f'{x / 2**30:.3f}' for x in peaks)} GiB per rank (phase 9b at B = 1 in "
        f"this run: {train_peak / 2**30:.3f} GiB) on {card}")
    if max(peaks) > 1.05 * train_peak:
        raise SystemExit(f"train_dp: a rank peaked at {max(peaks)} bytes, past 1.05 x phase "
                         f"9b's {train_peak}")
    res["train_dp"].update(s_per_step=s_step, peak_bytes=peaks)
    res["train_edge"] = _hold_train("train_edge", [r["train_edge"] for r in ranks], tiny_single,
                                    1e-4, TRAIN_EPS, card)
    log(f"[train_edge] dp 1 x edge {RANKS}: {ranks[0]['train_edge']['edges']} of "
        f"{tiny_single[0]['edges']} edges a rank (phase 9a's f32 tuple, num_steps 2)")

    # ---- 12d: keyframe-sharded video
    for name, keys in (("video_main", ("poses", "disps")), ("video_coupled", ("pos", "disps"))):
        rr = [r[name] for r in ranks]
        res[name] = _hold_video(name, rr, (main_single if name == "video_main"
                                           else coupled_single), keys, card)
        single = main_single if name == "video_main" else coupled_single
        res[name].update(kf_per_s=[r["kf_per_s"] for r in rr],
                         single_kf_per_s=[s["kf_per_s"] for s in single],
                         feature_bytes=[r["feature_bytes"] for r in rr],
                         single_feature_bytes=single[0]["feature_bytes"],
                         launches={k: sum(r["launches"][k] for r in rr) for k in rr[0]["launches"]})
        extra = ""
        if name == "video_coupled":
            extra = (f"; {rr[0]['async_steps']} async steps, {rr[0]['culls']} culls, "
                     f"{rr[0]['rollups']} rollups in the pipeline")
            if rr[0]["async_steps"] < 10:
                raise SystemExit(f"{name}: the sharded pipeline ran {rr[0]['async_steps']} "
                                 "async steps")
        log(f"[{name}] {RANKS} ranks with shard_video: "
            f"{', '.join('%.3f' % r['kf_per_s'] for r in rr)} kf/s (gloo staging through the "
            f"host included; one process {single[0]['kf_per_s']:.3f}, "
            f"{single[1]['kf_per_s']:.3f}); fmaps+nets+inps "
            f"{', '.join(str(r['feature_bytes']) for r in rr)} bytes a rank against "
            f"{single[0]['feature_bytes']}; launches (both ranks) {res[name]['launches']}{extra} "
            f"on {card}")
        la = res[name]["launches"]
        if la["corr_fused_xy"] == 0 or la["corr_lookup"] == 0:
            raise SystemExit(f"{name}: K1 or K2 did not run on the ranks: {la}")
    return res



def log_demos(demo_res: dict, card: str) -> None:
    """Phase 11's summary lines."""
    for kind, r in demo_res.items():
        log(f"[demo_{kind}] {r['image_size'][0]}x{r['image_size'][1]}, {r['kf_per_s']:.3f} kf/s "
            f"after VI init, ATE {r['ate_share']:.4f} of the span, {r['host_reads_per_kf']:.3f} "
            f"host reads and {r['lm_passes_per_kf']:.3f} LM passes a keyframe on {card}")
    k1d = demo_res["kitti360"]["k1_check"]
    log(f"[demo_kitti360] K1 at E={k1d['E']} {k1d['grid']} (whole blocks {k1d['whole']}): "
        f"{k1d['ms']:.4f} ms (bound {k1d['bound_ms']:.4f} ms by {k1d['bound_by']}, plain "
        f"{k1d['plain_ms']:.3f} ms), {k1d['k1_err']:.3e} from its plain version on {card}")


def main() -> int:
    ap = argparse.ArgumentParser(description="Chip smoke test of the PyTorch/CUDA port.")
    ap.add_argument("--root", default=ROOT,
                    help="directory holding the dbaf_tpu_torch package (default: this checkout)")
    ap.add_argument("--kernels-only", action="store_true", help="stop after phase 2")
    ap.add_argument("--demos-only", action="store_true",
                    help="run phase 11 (the dataset demos) only, after the build")
    ap.add_argument("--main-and-coupled", action="store_true",
                    help="run phases 3-5 only, with no kernel check (their rates, for an A/B "
                         "of two package trees through --root)")
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
    if args.demos_only:
        t = time.perf_counter()
        demo_res = phase_demos(dev)
        log(f"[time] phase 11 (dataset demos) took {time.perf_counter() - t:.1f} s")
        log_demos(demo_res, card)
        return 0

    rows = None if args.main_and_coupled else phase_kernels(dev)
    if args.kernels_only:
        return 0
    t = time.perf_counter()
    main_res = phase_main(dev, N_FRAMES)
    phase_check(dev)
    log(f"[time] phases 3-4 took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    coupled_res = phase_coupled(dev, N_COUPLED)
    log(f"[time] phase 5 (coupled) took {time.perf_counter() - t:.1f} s")
    if args.main_and_coupled:
        log(f"[main] {main_res['kf_per_s']:.3f} kf/s, [coupled] {coupled_res['kf_per_s']:.3f} "
            f"kf/s after VI init on {card}")
        return 0
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
    t = time.perf_counter()
    parity_res = train_parity(dev)
    log(f"[time] phase 9a (train parity) took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    train_res = phase_train(dev)
    log(f"[time] phase 9b (train) took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    up_res = phase_upsample(dev, main_res["kf_per_s"])
    log(f"[time] phase 9c (upsample) took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    stereo_res = phase_stereo(dev, main_res["kf_per_s"])
    log(f"[time] phase 10a (stereo) took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    oracle_res = phase_oracle_inputs(dev)
    log(f"[time] phase 10b (oracle stereo, RGB-D) took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    resume_res = phase_resume(dev)
    log(f"[time] phase 10c (save and resume) took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    demo_res = phase_demos(dev)
    log(f"[time] phase 11 (dataset demos) took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    multi_res = phase_multi_device(dev, train_res["peak_bytes"], card)
    log(f"[time] phase 12 (multi-device) took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    ms_res = phase_multisensor(dev, card)
    log(f"[time] phase 13 (multi-sensor flagship) took {time.perf_counter() - t:.1f} s")
    visual_launches = {name: sum(visual_res[m]["launches"][name]
                                 for m in ("visual", "cull", "gateonly"))
                       for name in int8_res["launches"]}
    paths = {"main": main_res["launches"], "coupled": coupled_res["launches"],
             "coupled_async": async_res["launches"], "visual_async": visual_launches,
             "int8": int8_res["launches"], "export": export_res["launches"],
             "upsample": up_res["launches"], "stereo": stereo_res["launches"],
             "oracle_stereo": oracle_res["stereo"]["launches"],
             "oracle_rgbd": oracle_res["rgbd"]["launches"], "resume": resume_res["launches"]}
    paths.update({f"demo_{kind}": r["launches"] for kind, r in demo_res.items()})
    paths.update(sharded_main=multi_res["video_main"]["launches"],
                 sharded_coupled_async=multi_res["video_coupled"]["launches"])
    msr = ms_res["runs"]
    paths.update({f"multisensor_{flow}": {name: msr[f"georef_{flow}"]["launches"][name]
                                          + msr[f"zupt_{flow}"]["launches"][name]
                                          for name in msr["georef_sync"]["launches"]}
                  for flow in ("sync", "async")})

    src = "dbaf_tpu_torch/csrc/"
    kernels = [
        dict(name="corr_fused_xy", route="cuda", source=src + "corr_fused_xy.cu",
             replaces="dbaf_tpu/ops/corr_pallas.py:206", row=rows["corr_fused_xy"]),
        dict(name="corr_fused_xy_int8", route="cuda", source=src + "corr_fused_xy.cu",
             replaces="dbaf_tpu/ops/corr_pallas.py:249", row=rows["corr_fused_xy_int8"]),
        dict(name="corr_fused_xy_raw", route="cuda", source=src + "corr_fused_xy.cu",
             replaces="dbaf_tpu/ops/corr_pallas.py:515", row=rows["corr_fused_xy_raw"]),
        dict(name="corr_lookup", route="cuda", source=src + "corr_lookup.cu",
             replaces="dbaf_tpu/ops/corr_pallas.py:58", row=rows["corr_lookup"]),
        # no Pallas kernel: the JAX package leaves linearize to XLA
        dict(name="fg_linearize", route="cuda", source=src + "fg_linearize.cu", replaces=None,
             row=rows["fg_linearize"]),
    ]
    out = []
    for k in kernels:
        r = k.pop("row")
        if r is None:  # a package without the kernel
            continue
        # fg_linearize is counted on the paths that run the factor graph's LM
        by_path = {p: n[k["name"]] for p, n in paths.items() if k["name"] in n}
        extra = {}
        if k["name"] == "fg_linearize":
            extra = dict(tol_ratio=r["tol_ratio"], eager_ms=r["eager_ms"],
                         plain_graph_ms=r["plain_graph_ms"],
                         lm_kernel_linearized_by_path={
                             p: f"{n['lm_kernel_linearized']} of {n['lm_launched']}"
                             for p, n in paths.items() if k["name"] in n})
        out.append(dict(k, launches=sum(by_path.values()), max_abs_err=r["max_abs_err"],
                        ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                        bound_by=r["bound_by"], library_ms=None, launches_by_path=by_path,
                        **extra))
    log(f"[main] {main_res['kf_per_s']:.3f} kf/s on {card}")
    log(f"[coupled] {coupled_res['kf_per_s']:.3f} kf/s after VI init on {card}")
    log(f"[coupled_async] {async_res['kf_per_s']:.3f} kf/s over the async steps on {card}")
    log(f"[visual_async] visual {visual_res['visual']['frames_per_s']:.3f} kf/s, cull "
        f"{visual_res['cull']['frames_per_s']:.3f} kf/s, gateonly "
        f"{visual_res['gateonly']['frames_per_s']:.3f} frames/s on {card}")
    log(f"[train_parity] loss rel {parity_res['loss_rel']:.2e}, worst gradient "
        f"{parity_res['grad_rel']:.2e}, parameters {parity_res['param_err']:.2e} on {card}")
    log(f"[train] {train_res['s_per_step']:.4f} s/step, peak "
        f"{train_res['peak_bytes'] / 2**30:.3f} GiB ({train_res['edges']} edges, 384x512, "
        f"num_steps 12, bf16) on {card}")
    log(f"[upsample] {up_res['kf_per_s']:.3f} kf/s ({up_res['kf_per_s_cold']:.3f} in the first "
        f"run; phase 3 {main_res['kf_per_s']:.3f}), run_upsample "
        f"{up_res['run_upsample_ms']:.3f} ms on {card}")
    log(f"[stereo] {stereo_res['kf_per_s']:.3f} kf/s (without stereo on the same frames "
        f"{stereo_res['mono_kf_per_s']:.3f}; phase 3 {main_res['kf_per_s']:.3f}), "
        f"K1 launches {stereo_res['launches']['corr_fused_xy']}, K2 launches "
        f"{stereo_res['launches']['corr_lookup']} on {card}")
    for mode in ("stereo", "rgbd"):
        r = oracle_res[mode]
        log(f"[oracle_{mode}] ATE se3 {r['ate_se3']:.4e} m, sim3 {r['ate_sim3']:.4e} m, scale "
            f"{r['scale']:.4f}, disparity ratio {r['ratio']:.4f} on {card}")
    log(f"[resume] {resume_res['resume_err']:.3e} after the resumed frames (spread of two runs "
        f"{resume_res['spread']:.3e}), file {resume_res['file_mib']:.1f} MiB on {card}")
    log_demos(demo_res, card)
    mb, mt = multi_res["ba"], multi_res["train_dp"]
    log(f"[multi_device] sharded BA {mb['iter_ms']:.3f} ms an iteration on {RANKS} gloo ranks "
        f"({mb['single_ms']:.3f} ms in one process); dp {RANKS} training "
        f"{max(mt['s_per_step']):.4f} s/step, peak {max(mt['peak_bytes']) / 2**30:.3f} GiB a "
        f"rank; shard_video {max(multi_res['video_main']['kf_per_s']):.3f} kf/s (phase 3's path) "
        f"and {max(multi_res['video_coupled']['kf_per_s']):.3f} kf/s (phase 6's) on {card}")
    print(card, flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
