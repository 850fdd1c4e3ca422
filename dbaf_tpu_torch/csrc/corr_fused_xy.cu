// K1: fused correlation build + 4-level windowed lookup, x first.
//
// Replaces the Pallas kernel _fused_xy_kernel (dbaf_tpu/ops/corr_pallas.py:206,
// driven by corr_fused_xy_prepared at :429).  For each edge e and source
// pixel p it computes the correlation row vol[p, h, w] = <f1[p], f2[h, w]>
// (inputs bf16 and pre-divided by 4, sums in f32, rounded to bf16 as the
// TPU kernel does at :239), never stores it in device memory, and contracts
// it with the per-level tent weights around coords[p], the average-pool
// pyramid folded into the weights (tent over floor(w / 2^l), scale 1/2^l):
//   P2[h, a]  = bf16( sum_w vol[h, w] * bf16(kx_{l,a}(w)) )
//   out[l,a,b] = bf16( sum_h bf16(ky_{l,b}(h)) * P2[h, a] )
// Output (E, H, W, 196) bf16, channel l*49 + a*7 + b (a = x tap, b = y tap),
// the reference order.
//
// Bound on the H100: the build's arithmetic, 2*P*P2*C flops per edge on
// the tensor cores (116 GFLOP per round at E=48, P=P2=3072, C=128).
//
// Design.  One block per (64 source pixels, edge), 21 warps.
//  * Build: warp 20 is the producer.  It loads the block's f1 tile once and
//    streams f2 in chunks of whole target rows (128 positions, RC = 128/W2
//    rows) through a 3-stage ring, both by TMA (3-D tensor maps, 128-byte
//    swizzle, 64 channels per box, out-of-range rows zero-filled) under
//    mbarriers.  Warps 0-15 form four warpgroups; each runs wgmma m64n32k16
//    (bf16 in, f32 in registers) on its quarter of the chunk, rounds to bf16
//    and stores it to the 64 x 128 volume chunk in shared memory.  A chunk's
//    wgmma is issued before the previous chunk's lookup and waited for after
//    it, so the tensor cores run under the lookup.  No volume reaches device
//    memory.
//  * Lookup, per chunk, separable and on whole rows.  Both tents depend on
//    the grid index only through floor(i / 2^l), so at level l the x
//    contraction of a row is two weights (wx0, wx1, the same for all taps)
//    times sums over blocks of 2^l columns: P2[a] = bf16(wx0*S[a] + wx1*S[a+1])
//    with S[j] the block sum at block floor(x/2^l) - 3 + j, j = 0..7.  A row in
//    block jy of the y union adds wy0*P2[a] to tap b = jy and wy1*P2[a] to
//    b = jy - 1.  The rounding points are the reference's; only the order of
//    the f32 sums differs.  Tents are computed once per (pixel, level).
//    The lookup is bound by the latency of its shared-memory chains, so the
//    work is cut fine and balanced by role: warps 0-7 take level 3 with four
//    lanes per pixel (two column blocks and two taps each, one shuffle),
//    warps 8-11, 12-15 and 16-19 levels 2, 1 and 0 with two lanes per pixel.
//    Each lane loads two rows at a time, and rows of a chunk in the same y
//    block are summed in registers first.  The 196 f32 sums of a pixel live
//    in shared memory, one owner per entry; a lane's update issues all its
//    loads before its stores.
//  * Epilogue: the sums are rounded to bf16 and written with 16-byte stores.
// Limits of this design: W2 <= 128 (a chunk holds whole rows, so images up
// to 1024 px wide) and C <= 128 (two channel boxes).  The wrapper raises
// beyond them, and DBAFusion checks its feature grid when it is built.
//
// K1-int8: the int8=True branch of the same Pallas kernel
// (corr_pallas.py:232-259).  The volume rows stay f32; per (edge, tile of
// `tile` source pixels) q = round(vol * 127 / vmax) with vmax the tile's
// max |vol| over every target position, and per level the x tents are
// quantized as qx = round(127 * kx); P2 = bf16(sum_w q * qx * vmax / 127^2).
// A tile (128 or 256 pixels) spans 2-4 blocks of 64 pixels, so its scale
// has to exist before any block quantizes: two launches.
//  * The max pass (kMode kMax): the build above with no lookup; each MMA
//    thread keeps max |acc| over its chunks, warps reduce, and lane 0
//    atomicMax-es the f32 bits (non-negative floats order as their bits)
//    into vmax[e, tile].  Bound: the build's flops, like K1.
//  * K1 under kMode kInt8: each chunk is quantized from the f32
//    accumulators straight into the shared volume chunk.  Integers up to
//    127 are exact in bf16, so the chunk keeps its bf16 layout and the
//    lookup its code: a block sum is an exact integer in f32, and the x
//    contraction of a tap is qx0 * S0 + qx1 * S1, exact (below 2^24) as
//    the int32 dot of the Pallas kernel, then scaled and rounded to bf16
//    once.  The rounding points are the Pallas kernel's; only the order of
//    the f32 build sums differs, which can flip a q by one quantum.
//    Int8 tensor cores are not used: the int8 branch costs the bf16
//    kernel's time plus the max pass.
//
// K1-raw: the raw=True branch (corr_pallas.py:515-516), the whole per-pixel
// 32 x 32 block with the diagonal-level extraction skipped.  Row i = l*7+dy
// is a y tap at level l, column j = l'*7+dx an x tap at level l', rows and
// columns 28-31 are 0; out (E, P, 1024) bf16, entry i*32 + j:
//   P2[h, j]  = bf16( sum_w vol[h, w] * bf16(kx_j(w)) )
//   out[i, j] = bf16( sum_h bf16(ky_i(h)) * P2[h, j] )
// The off-diagonal pairs (l != l') need the x stage of one level and the y
// stage of another, so kMode kRaw runs one block per (64 pixels, edge, y
// level l): the build above, then a lookup in which lane (pixel, x level
// l') forms the 7 taps of l' from its 8 block sums per row (P2) and adds
// them, weighted by the y tents of l, into 7 x 28 f32 sums per pixel (the
// same 196 entries as K1's, one owner each).  A simple design: the build
// runs once per y level (4 times K1's tensor-core work), and 4 of the 20
// lookup warps' worth of lanes are busy.  Bound on the H100: the build's
// flops once, against 302 MB of output at E=48, P=3072.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kM = 64;            // source pixels per block
constexpr int kN = 128;           // target positions per f2 chunk
constexpr int kBoxC = 64;         // channels per TMA box: 128-byte rows
constexpr int kMaxKB = 2;         // channel boxes: C <= 128
constexpr int kStages = 3;
constexpr int kConsumers = 640;   // warps 0-19: the lookup; warps 0-15 also the build
constexpr int kMmaWarps = 16;     // four wgmma warpgroups
constexpr int kWgN = kN / (kMmaWarps / 4);  // positions per warpgroup: 32
constexpr int kAcc = kWgN / 2;                 // f32 accumulators per thread: 16
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kRadius = 3;
constexpr int kTaps = 2 * kRadius + 1;     // 7
constexpr int kChannels = 4 * kTaps * kTaps;  // 196
constexpr int kVolStride = kN + 8;         // bf16 per pixel row of a volume chunk (272 B)
constexpr int kAccStride = kChannels + 1;  // f32 per pixel of the sums

// kernel variants: K1 (bf16 volume), K1-int8, and K1-int8's max pass
constexpr int kBf16 = 0, kInt8 = 1, kMax = 2, kRaw = 3;
constexpr int kRawCols = 4 * kTaps;  // 28 live columns (and rows) of a raw block
constexpr int kRawBlock = 32 * 32;   // raw outputs per pixel
constexpr float kQ = 127.f;                               // int8 steps per unit of the scale
constexpr float kInvQ2 = static_cast<float>(1.0 / (127.0 * 127.0));

constexpr int kF1Bytes = kMaxKB * kM * 128;          // 16 KB
constexpr int kStageBytes = kMaxKB * kN * 128;       // 32 KB
constexpr int kVolBytes = kM * kVolStride * 2;       // 17 KB
constexpr int kOffF2 = kF1Bytes;
constexpr int kOffVol = kOffF2 + kStages * kStageBytes;
constexpr int kOffAcc = kOffVol + 2 * kVolBytes;
constexpr int kOffBar = kOffAcc + kM * kAccStride * 4;
constexpr int kSmemBytes = kOffBar + 64 + 1024;      // + room to align the base to 1024

// ---------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte swizzle:
// rows of 128 bytes, 8-row atoms 1024 bytes apart
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  uint64_t d = (addr & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>(16 >> 4) << 16;
  d |= static_cast<uint64_t>(1024 >> 4) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving accumulator registers across an async wgmma
__device__ __forceinline__ void fence_acc(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// ---------------------------------------------------------------- lookup helpers

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float bf_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf_hi(uint32_t u) { return __uint_as_float(u & 0xFFFF0000u); }

// Per (pixel, level): the union of the 7 taps' supports is blocks
// g0 .. g0+7 of 2^l grid cells on each axis, and every tap uses two of them
// with the weights w0 (block k0 + off) and w1 (block k0 + off + 1), the
// reference's tent max(0, 1 - |(floor(i/2^l) - off) - c/2^l|) / 2^l.
struct Level {
  int gx0, gy0;          // first block of the union, x and y
  float wx0, wx1, wy0, wy1;
  bool valid;            // finite coordinate and a union that meets the image
};

// The x weights of level lx, the y weights of level ly (the same level but
// in K1-raw).  int8: the x weights are the Pallas kernel's
// qx = round(127 * kx) (kx in f32), the y weights stay bf16.
template <int kMode>
__device__ __forceinline__ Level make_level(float x, float y, int lx, int ly, int H2, int W2) {
  Level L;
  const float ix = 1.f / static_cast<float>(1 << lx), iy = 1.f / static_cast<float>(1 << ly);
  const float sx = static_cast<float>(1 << lx), sy = static_cast<float>(1 << ly);
  const float cx = x * ix, cy = y * iy;
  const float kx = floorf(cx), ky = floorf(cy);
  // union [(k0 - 3) s, (k0 + 5) s) against [0, size); false for NaN
  L.valid = (kx + 5.f) * sx > 0.f && (kx - 3.f) * sx < static_cast<float>(W2) &&
            (ky + 5.f) * sy > 0.f && (ky - 3.f) * sy < static_cast<float>(H2);
  L.gx0 = L.valid ? static_cast<int>(kx) - kRadius : 0;
  L.gy0 = L.valid ? static_cast<int>(ky) - kRadius : 0;
  if (kMode == kInt8) {
    L.wx0 = rintf((fmaxf(0.f, 1.f - fabsf(kx - cx)) * ix) * kQ);
    L.wx1 = rintf((fmaxf(0.f, 1.f - fabsf((kx + 1.f) - cx)) * ix) * kQ);
  } else {
    L.wx0 = round_bf16(fmaxf(0.f, 1.f - fabsf(kx - cx)) * ix);
    L.wx1 = round_bf16(fmaxf(0.f, 1.f - fabsf((kx + 1.f) - cx)) * ix);
  }
  L.wy0 = round_bf16(fmaxf(0.f, 1.f - fabsf(ky - cy)) * iy);
  L.wy1 = round_bf16(fmaxf(0.f, 1.f - fabsf((ky + 1.f) - cy)) * iy);
  return L;
}

// Sum of the bf16 values of block g (2^l columns) of one volume row, zero
// outside [0, W2).  kVec: rows are 16-byte aligned and W2 % 8 == 0, so a
// block of 2, 4 or 8 columns is one aligned vector load.
template <bool kVec>
__device__ __forceinline__ float block_sum(const __nv_bfloat16* row, int g, int l, int W2) {
  const int s = 1 << l;
  const int c0 = g * s;
  if (c0 + s <= 0 || c0 >= W2) return 0.f;
  if (kVec) {
    if (l == 3) {
      const uint4 v = *reinterpret_cast<const uint4*>(row + c0);
      return ((bf_lo(v.x) + bf_hi(v.x)) + (bf_lo(v.y) + bf_hi(v.y))) +
             ((bf_lo(v.z) + bf_hi(v.z)) + (bf_lo(v.w) + bf_hi(v.w)));
    }
    if (l == 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(row + c0);
      return (bf_lo(v.x) + bf_hi(v.x)) + (bf_lo(v.y) + bf_hi(v.y));
    }
    if (l == 1) {
      const uint32_t v = *reinterpret_cast<const uint32_t*>(row + c0);
      return bf_lo(v) + bf_hi(v);
    }
    return __bfloat162float(row[c0]);
  }
  const int lo = max(c0, 0), hi = min(c0 + s, W2);
  float acc = 0.f;
  for (int w = lo; w < hi; ++w) acc += __bfloat162float(row[w]);
  return acc;
}

// Adds the summed P2 of union row-block jy to this lane's taps in the
// pixel's shared sums acc[l*49 + a*7 + b]: wy0 * Q into y tap b = jy and
// wy1 * Q into b = jy - 1.  All loads are issued before any store, so the
// read-modify-writes overlap instead of queueing.
template <int L, int kNb>
__device__ __forceinline__ void flush_rows(float* acc, const Level& lv, int a0, int jy,
                                           const float (&Q)[kNb]) {
  float* base = acc + L * kTaps * kTaps + a0 * kTaps + jy;  // entry (a0, jy)
  const bool b_hi = jy <= kTaps - 1, b_lo = jy >= 1;
  float v0[kNb], v1[kNb];
#pragma unroll
  for (int t = 0; t < kNb; ++t) {
    const bool live = a0 + t < kTaps;
    v0[t] = live && b_hi ? base[t * kTaps] : 0.f;
    v1[t] = live && b_lo ? base[t * kTaps - 1] : 0.f;
  }
#pragma unroll
  for (int t = 0; t < kNb; ++t) {
    if (a0 + t >= kTaps) break;
    if (b_hi) base[t * kTaps] = v0[t] + lv.wy0 * Q[t];
    if (b_lo) base[t * kTaps - 1] = v1[t] + lv.wy1 * Q[t];
  }
}

// Level L of one chunk (rows h0 .. h0 + nrows - 1 of pixel `row0`'s volume),
// kLanes consecutive lanes per pixel; lane q owns union blocks
// q*nb .. q*nb + nb - 1 (nb = 8 / kLanes) and x taps a = q*nb .. q*nb + nb - 1,
// and takes block q*nb + nb from lane q + 1.  Rows that fall in the same
// y block are summed in registers before they reach the shared sums.
// int8: the values are quantized volume entries, the x weights int8 tents,
// so wx0 * S0 + wx1 * S1 is an exact integer; `sc` = vmax / 127^2 scales it.
template <int L, int kLanes, bool kVec, int kMode>
__device__ __forceinline__ void lookup_chunk(float* acc, const Level& lv, int q,
                                             const __nv_bfloat16* row0, int h0, int nrows,
                                             int W2, float sc) {
  constexpr int nb = 8 / kLanes;
  const int a0 = q * nb;
  float Q[nb];
#pragma unroll
  for (int t = 0; t < nb; ++t) Q[t] = 0.f;
  int jq = -1;
  // two rows at a time: both rows' loads are in flight together
  for (int r = 0; r < nrows; r += 2) {
    int jy[2];
    float S[2][nb + 1];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      jy[k] = (r + k < nrows && lv.valid) ? ((h0 + r + k) >> L) - lv.gy0 : -1;
      if (jy[k] > 7) jy[k] = -1;
      const __nv_bfloat16* row = row0 + (r + k) * W2;
#pragma unroll
      for (int t = 0; t < nb; ++t)
        S[k][t] = jy[k] >= 0 ? block_sum<kVec>(row, lv.gx0 + a0 + t, L, W2) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      // lanes of one pixel agree on jy; every lane of the warp takes part
      S[k][nb] = kLanes > 1 ? __shfl_down_sync(0xffffffffu, S[k][0], 1) : 0.f;
      if (jy[k] != jq) {
        if (jq >= 0) flush_rows<L, nb>(acc, lv, a0, jq, Q);
#pragma unroll
        for (int t = 0; t < nb; ++t) Q[t] = 0.f;
        jq = jy[k];
      }
      if (jy[k] >= 0) {
#pragma unroll
        for (int t = 0; t < nb; ++t)
          if (a0 + t < kTaps) {
            const float p = lv.wx0 * S[k][t] + lv.wx1 * S[k][t + 1];
            Q[t] += round_bf16(kMode == kInt8 ? p * sc : p);
          }
      }
    }
  }
  if (jq >= 0) flush_rows<L, nb>(acc, lv, a0, jq, Q);
}

// K1-raw: one lane per (pixel, x level L); y level ly.  Each row in the y
// union gives the 7 taps of L, P2 = bf16(wx0 * S[a] + wx1 * S[a + 1]);
// rows in the same y block are summed in registers, then added with wy0 to
// y tap dy = jy and with wy1 to dy = jy - 1 of columns L*7 .. L*7 + 6 of the
// pixel's 7 x 28 sums.
template <int L>
__device__ __forceinline__ void flush_raw(float* acc, const Level& lv, int jy,
                                          const float (&Q)[kTaps]) {
  float* col = acc + L * kTaps;
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    if (jy <= kTaps - 1) col[jy * kRawCols + t] += lv.wy0 * Q[t];
    if (jy >= 1) col[(jy - 1) * kRawCols + t] += lv.wy1 * Q[t];
  }
}

template <int L, bool kVec>
__device__ __forceinline__ void lookup_chunk_raw(float* acc, const Level& lv, int ly,
                                                 const __nv_bfloat16* row0, int h0, int nrows,
                                                 int W2) {
  float Q[kTaps];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) Q[t] = 0.f;
  int jq = -1;
  for (int r = 0; r < nrows; ++r) {
    int jy = lv.valid ? ((h0 + r) >> ly) - lv.gy0 : -1;
    if (jy > 7) jy = -1;
    if (jy != jq) {
      if (jq >= 0) flush_raw<L>(acc, lv, jq, Q);
#pragma unroll
      for (int t = 0; t < kTaps; ++t) Q[t] = 0.f;
      jq = jy;
    }
    if (jy >= 0) {
      const __nv_bfloat16* row = row0 + r * W2;
      float S[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) S[t] = block_sum<kVec>(row, lv.gx0 + t, L, W2);
#pragma unroll
      for (int t = 0; t < kTaps; ++t) Q[t] += round_bf16(lv.wx0 * S[t] + lv.wx1 * S[t + 1]);
    }
  }
  if (jq >= 0) flush_raw<L>(acc, lv, jq, Q);
}

// This thread's part of one chunk's lookup.  K1 and K1-int8: its level, with
// 4, 2, 2 or 2 lanes per pixel at levels 3, 2, 1, 0.  K1-raw: its x level
// (lvl, -1 for a thread with no lookup role) at the block's y level ly.
template <bool kVec, int kMode>
__device__ __forceinline__ void lookup_any(float* acc, const Level& lv, int lvl, int q, int ly,
                                           const __nv_bfloat16* row0, int h0, int nrows, int W2,
                                           float sc) {
  if constexpr (kMode == kRaw) {
    if (lvl == 3) lookup_chunk_raw<3, kVec>(acc, lv, ly, row0, h0, nrows, W2);
    else if (lvl == 2) lookup_chunk_raw<2, kVec>(acc, lv, ly, row0, h0, nrows, W2);
    else if (lvl == 1) lookup_chunk_raw<1, kVec>(acc, lv, ly, row0, h0, nrows, W2);
    else if (lvl == 0) lookup_chunk_raw<0, kVec>(acc, lv, ly, row0, h0, nrows, W2);
  } else {
    if (lvl == 3) lookup_chunk<3, 4, kVec, kMode>(acc, lv, q, row0, h0, nrows, W2, sc);
    else if (lvl == 2) lookup_chunk<2, 2, kVec, kMode>(acc, lv, q, row0, h0, nrows, W2, sc);
    else if (lvl == 1) lookup_chunk<1, 2, kVec, kMode>(acc, lv, q, row0, h0, nrows, W2, sc);
    else lookup_chunk<0, 2, kVec, kMode>(acc, lv, q, row0, h0, nrows, W2, sc);
  }
}

// ---------------------------------------------------------------- the kernel

// Waits for chunk c's f2 tile and issues this warpgroup's wgmma on its
// quarter of the positions (64 x 32, K = Cpad), without waiting for it.
__device__ __forceinline__ void issue_chunk(float (&d)[kAcc], int c, uint32_t bar_full,
                                            uint32_t s_f1, uint32_t s_f2, int wg, int nkb) {
  const int st = c % kStages;
  mbar_wait(bar_full + 8 * st, (c / kStages) & 1);
  wgmma_fence();
  const uint32_t b_base = s_f2 + st * kStageBytes + wg * kWgN * 128;
#pragma unroll
  for (int kb = 0; kb < kMaxKB; ++kb) {
    if (kb >= nkb) break;
    const uint64_t da = desc_sw128(s_f1 + kb * kM * 128);
    const uint64_t db = desc_sw128(b_base + kb * kN * 128);
#pragma unroll
    for (int k = 0; k < kBoxC / 16; ++k)
      wgmma_m64n32k16(d, da + 2 * k, db + 2 * k, (kb | k) != 0);
  }
  wgmma_commit();
}

// Waits for chunk c's wgmma, frees its ring slot and stores the bf16 volume
// chunk to buffer c & 1 (int8: round(vol * qs), exact in bf16).
// Accumulator fragment: row 16*warp + lane/4 (+8), column 8j + 2*(lane%4)
// (+1) of the warpgroup's 32 positions.
template <int kMode>
__device__ __forceinline__ void finish_chunk(float (&d)[kAcc], int c, uint32_t bar_empty,
                                             __nv_bfloat16* vol, int wg, int warp, int lane,
                                             float qs) {
  wgmma_wait0();
  fence_acc(d);
  if (lane == 0) mbar_arrive(bar_empty + 8 * (c % kStages));
  if (kMode == kInt8) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) d[i] = rintf(d[i] * qs);
  }
  __nv_bfloat16* vbuf = vol + (c & 1) * (kM * kVolStride);
  const int r0 = 16 * warp + lane / 4;
  const int n0 = wg * kWgN + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < kAcc / 4; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(vbuf + r0 * kVolStride + n0 + 8 * j) =
        __floats2bfloat162_rn(d[4 * j], d[4 * j + 1]);
    *reinterpret_cast<__nv_bfloat162*>(vbuf + (r0 + 8) * kVolStride + n0 + 8 * j) =
        __floats2bfloat162_rn(d[4 * j + 2], d[4 * j + 3]);
  }
}

// kMode kBf16: K1; kInt8: K1-int8 (reads vmax); kMax: the max pass
// (writes vmax, zeroed by the caller; coords and out are unused); kRaw:
// K1-raw (out (E, P, 1024), blockIdx.z the y level).
template <bool kVec, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
corr_fused_xy_kernel(const __grid_constant__ CUtensorMap map_f1,  // (E, P, Cpad) bf16
                     const __grid_constant__ CUtensorMap map_f2,  // (E, P2, Cpad) bf16
                     const float* __restrict__ coords,           // (E, P, 2)
                     __nv_bfloat16* __restrict__ out,            // (E, P, 196 or 1024)
                     float* __restrict__ vmax,                   // (E, P / tile) f32
                     int P, int H2, int W2, int nkb, int tile) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t s_f1 = smem_u32(smem);
  const uint32_t s_f2 = s_f1 + kOffF2;
  __nv_bfloat16* vol = reinterpret_cast<__nv_bfloat16*>(smem + kOffVol);
  float* acc = reinterpret_cast<float*>(smem + kOffAcc);
  const uint32_t bar_full = s_f1 + kOffBar;  // kStages barriers
  const uint32_t bar_empty = bar_full + 8 * kStages;
  const uint32_t bar_f1 = bar_empty + 8 * kStages;

  const int e = blockIdx.y;
  const int p0 = blockIdx.x * kM;
  const int tid = threadIdx.x;
  const int rc = kN / W2;                   // whole rows per chunk
  const int nchunks = (H2 + rc - 1) / rc;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(bar_full + 8 * i, 1);
      mbar_init(bar_empty + 8 * i, kMmaWarps);
    }
    mbar_init(bar_f1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warp: one lane issues every TMA load
    if (tid == kConsumers) {
      mbar_expect_tx(bar_f1, nkb * kM * 128);
      for (int kb = 0; kb < nkb; ++kb)
        tma_load_3d(s_f1 + kb * kM * 128, &map_f1, bar_f1, kb * kBoxC, p0, e);
      for (int c = 0; c < nchunks; ++c) {
        const int st = c % kStages;
        mbar_wait(bar_empty + 8 * st, ((c / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * st, nkb * kN * 128);
        for (int kb = 0; kb < nkb; ++kb)
          tma_load_3d(s_f2 + st * kStageBytes + kb * kN * 128, &map_f2, bar_full + 8 * st,
                      kb * kBoxC, c * rc * W2, e);
      }
    }
    return;
  }

  // ---- consumers
  const int wg = tid / 128;       // wgmma warpgroup (0-3): its quarter of the chunk's positions
  const int wtid = tid % 128;
  const int warp = wtid / 32, lane = tid % 32;

  // lookup role of this thread (see the header): level, pixel, lane of the
  // pixel; K1-raw: x level (threads 0-255) and pixel, at the block's y level
  const int ly = kMode == kRaw ? static_cast<int>(blockIdx.z) : 0;
  int lvl, pix, q;
  if (kMode == kRaw) {
    lvl = tid < 4 * kM ? tid / kM : -1;
    pix = tid % kM;
    q = 0;
  } else {
    lvl = tid < 256 ? 3 : tid < 384 ? 2 : tid < 512 ? 1 : 0;
    pix = lvl == 3 ? tid >> 2 : (tid - 256 - 128 * (2 - lvl)) >> 1;
    q = lvl == 3 ? tid & 3 : tid & 1;
  }
  const bool mma = tid < kMmaWarps * 32;
  // this block's tile of the int8 scale (a tile holds whole blocks)
  const size_t tile_idx = kMode == kBf16 ? 0 : static_cast<size_t>(e) * (P / tile) + p0 / tile;

  if constexpr (kMode == kMax) {
    // ---- the max pass: max |vol| of this block's rows over every chunk
    if (!mma) return;
    float d[kAcc];
    float m = 0.f;
    mbar_wait(bar_f1, 0);
    for (int c = 0; c < nchunks; ++c) {
      issue_chunk(d, c, bar_full, s_f1, s_f2, wg, nkb);
      wgmma_wait0();
      fence_acc(d);
      if (lane == 0) mbar_arrive(bar_empty + 8 * (c % kStages));
#pragma unroll
      for (int i = 0; i < kAcc; ++i) m = fmaxf(m, fabsf(d[i]));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) atomicMax(reinterpret_cast<int*>(vmax + tile_idx), __float_as_int(m));
    return;
  }

  // int8: the tile's quantization step and the scale of the integer x sums
  float qs = 0.f, sc = 0.f;
  if (kMode == kInt8) {
    const float vm = vmax[tile_idx];
    qs = kQ / vm;
    sc = vm * kInvQ2;
  }
  for (int i = tid; i < kM * kAccStride; i += kConsumers) acc[i] = 0.f;
  const bool live = p0 + pix < P;
  float2 xy = make_float2(__int_as_float(0x7fc00000), 0.f);  // NaN: no support
  if (live) xy = reinterpret_cast<const float2*>(coords)[static_cast<size_t>(e) * P + p0 + pix];
  const Level lv = make_level<kMode>(xy.x, xy.y, max(lvl, 0), kMode == kRaw ? ly : max(lvl, 0),
                                     H2, W2);
  float* my_acc = acc + pix * kAccStride;

  float d[kAcc];
  if (mma) {
    mbar_wait(bar_f1, 0);
    issue_chunk(d, 0, bar_full, s_f1, s_f2, wg, nkb);
    finish_chunk<kMode>(d, 0, bar_empty, vol, wg, warp, lane, qs);
  }
  consumer_sync();

  // chunk c + 1 runs on the tensor cores under chunk c's lookup; the last
  // chunk's lookup runs alone
  for (int c = 0; c + 1 < nchunks; ++c) {
    if (mma) issue_chunk(d, c + 1, bar_full, s_f1, s_f2, wg, nkb);
    lookup_any<kVec, kMode>(my_acc, lv, lvl, q, ly,
                            vol + (c & 1) * (kM * kVolStride) + pix * kVolStride, c * rc,
                            min(rc, H2 - c * rc), W2, sc);
    if (mma) finish_chunk<kMode>(d, c + 1, bar_empty, vol, wg, warp, lane, qs);
    consumer_sync();
  }
  {
    const int c = nchunks - 1;
    lookup_any<kVec, kMode>(my_acc, lv, lvl, q, ly,
                            vol + (c & 1) * (kM * kVolStride) + pix * kVolStride, c * rc,
                            min(rc, H2 - c * rc), W2, sc);
  }

  consumer_sync();

  const int np = min(kM, P - p0);
  if constexpr (kMode == kRaw) {
    // ---- K1-raw epilogue: this y level's 7 rows of each pixel's block (the
    // last level also the zero rows 28-31), 16-byte stores: a segment starts
    // at a multiple of 7 * 32 bf16 (448 bytes) and holds whole 8-value runs
    const int nrow = ly == 3 ? 32 - 3 * kTaps : kTaps;
    const int seg = nrow * 32;
    for (int i = tid * 8; i < np * seg; i += kConsumers * 8) {
      const int p = i / seg, o = i % seg;
      __align__(16) __nv_bfloat16 v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int r = (o + k) / 32, j = (o + k) % 32;
        v[k] = __float2bfloat16(r < kTaps && j < kRawCols ? acc[p * kAccStride + r * kRawCols + j]
                                                          : 0.f);
      }
      *reinterpret_cast<uint4*>(out + (static_cast<size_t>(e) * P + p0 + p) * kRawBlock +
                                ly * kTaps * 32 + o) = *reinterpret_cast<const uint4*>(v);
    }
    return;
  }

  // ---- epilogue: bf16, 16-byte stores where the block's output is aligned
  const int n = np * kChannels;
  __nv_bfloat16* dst = out + (static_cast<size_t>(e) * P + p0) * kChannels;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    for (int i = tid * 8; i < n; i += kConsumers * 8) {
      __align__(16) __nv_bfloat16 v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int idx = min(i + k, n - 1);
        v[k] = __float2bfloat16(acc[(idx / kChannels) * kAccStride + idx % kChannels]);
      }
      if (i + 8 <= n) {
        *reinterpret_cast<uint4*>(dst + i) = *reinterpret_cast<const uint4*>(v);
      } else {
        for (int k = 0; i + k < n; ++k) dst[i + k] = v[k];
      }
    }
  } else {
    for (int i = tid; i < n; i += kConsumers)
      dst[i] = __float2bfloat16(acc[(i / kChannels) * kAccStride + i % kChannels]);
  }
}

// ---------------------------------------------------------------- host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call: reached through the runtime's
// entry-point query, so the library needs no -lcuda
EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn) return fn;
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                       &q) != cudaSuccess)
    return nullptr;
#else
  if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) != cudaSuccess)
    return nullptr;
#endif
  if (q != cudaDriverEntryPointSuccess) return nullptr;
  fn = reinterpret_cast<EncodeTiledFn>(p);
  return fn;
}

// (E, rows, Cpad) bf16 with boxes of 64 channels x box_rows rows, 128-byte swizzle
bool make_map(CUtensorMap* map, const void* base, int E, int rows, int Cpad, int box_rows) {
  EncodeTiledFn enc = encode_fn();
  if (!enc) return false;
  cuuint64_t dims[3] = {static_cast<cuuint64_t>(Cpad), static_cast<cuuint64_t>(rows),
                        static_cast<cuuint64_t>(E)};
  cuuint64_t strides[2] = {static_cast<cuuint64_t>(Cpad) * 2,
                           static_cast<cuuint64_t>(rows) * Cpad * 2};
  cuuint32_t box[3] = {static_cast<cuuint32_t>(kBoxC), static_cast<cuuint32_t>(box_rows), 1};
  cuuint32_t estr[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
             box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kVec, int kMode>
int launch(const CUtensorMap& m1, const CUtensorMap& m2, const float* coords, __nv_bfloat16* out,
           float* vmax, int E, int P, int H2, int W2, int nkb, int tile, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(corr_fused_xy_kernel<kVec, kMode>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((P + kM - 1) / kM, E, kMode == kRaw ? 4 : 1);
  corr_fused_xy_kernel<kVec, kMode><<<grid, kThreads, kSmemBytes, stream>>>(
      m1, m2, coords, out, vmax, P, H2, W2, nkb, tile);
  return static_cast<int>(cudaGetLastError());
}

bool make_maps(CUtensorMap* m1, CUtensorMap* m2, const void* f1, const void* f2, int E, int P,
               int H2, int W2, int Cpad) {
  return make_map(m1, f1, E, P, Cpad, kM) && make_map(m2, f2, E, H2 * W2, Cpad, kN);
}

}  // namespace

// f1 (E, P, Cpad) and f2 (E, H2*W2, Cpad) bf16, 16-byte aligned, Cpad in
// {64, 128}; W2 <= 128.  Launch on `stream`; returns cudaGetLastError() of
// the launch (0 = ok), or -1 if a tensor map could not be encoded.
extern "C" int corr_fused_xy_launch(const void* f1, const void* f2, const void* coords, void* out,
                                    int E, int P, int H2, int W2, int Cpad, void* stream) {
  if (E == 0 || P == 0) return 0;
  CUtensorMap m1, m2;
  if (!make_maps(&m1, &m2, f1, f2, E, P, H2, W2, Cpad)) return -1;
  const int nkb = Cpad / kBoxC;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(coords);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (W2 % 8 == 0) return launch<true, kBf16>(m1, m2, c, o, nullptr, E, P, H2, W2, nkb, 1, s);
  return launch<false, kBf16>(m1, m2, c, o, nullptr, E, P, H2, W2, nkb, 1, s);
}

// K1-int8's max pass: vmax (E, P / tile) f32, zeroed by the caller, gets
// max |vol| of each tile; tile a multiple of 64 that divides P.
extern "C" int corr_int8_vmax_launch(const void* f1, const void* f2, void* vmax, int E, int P,
                                     int H2, int W2, int Cpad, int tile, void* stream) {
  if (E == 0 || P == 0) return 0;
  CUtensorMap m1, m2;
  if (!make_maps(&m1, &m2, f1, f2, E, P, H2, W2, Cpad)) return -1;
  return launch<false, kMax>(m1, m2, nullptr, nullptr, static_cast<float*>(vmax), E, P, H2, W2,
                             Cpad / kBoxC, tile, static_cast<cudaStream_t>(stream));
}

// K1-int8: as corr_fused_xy_launch, with each tile's scale from the max
// pass (vmax, clamped to >= 1e-20 by the caller).
extern "C" int corr_fused_xy_int8_launch(const void* f1, const void* f2, const void* coords,
                                         void* vmax, void* out, int E, int P, int H2, int W2,
                                         int Cpad, int tile, void* stream) {
  if (E == 0 || P == 0) return 0;
  CUtensorMap m1, m2;
  if (!make_maps(&m1, &m2, f1, f2, E, P, H2, W2, Cpad)) return -1;
  const int nkb = Cpad / kBoxC;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(coords);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  float* v = static_cast<float*>(vmax);
  if (W2 % 8 == 0) return launch<true, kInt8>(m1, m2, c, o, v, E, P, H2, W2, nkb, tile, s);
  return launch<false, kInt8>(m1, m2, c, o, v, E, P, H2, W2, nkb, tile, s);
}

// K1-raw: as corr_fused_xy_launch, out (E, P, 1024) bf16 (16-byte aligned).
extern "C" int corr_fused_xy_raw_launch(const void* f1, const void* f2, const void* coords,
                                        void* out, int E, int P, int H2, int W2, int Cpad,
                                        void* stream) {
  if (E == 0 || P == 0) return 0;
  CUtensorMap m1, m2;
  if (!make_maps(&m1, &m2, f1, f2, E, P, H2, W2, Cpad)) return -1;
  const int nkb = Cpad / kBoxC;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(coords);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (W2 % 8 == 0) return launch<true, kRaw>(m1, m2, c, o, nullptr, E, P, H2, W2, nkb, 1, s);
  return launch<false, kRaw>(m1, m2, c, o, nullptr, E, P, H2, W2, nkb, 1, s);
}
