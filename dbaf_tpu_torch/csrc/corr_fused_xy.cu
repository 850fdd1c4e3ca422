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
// to 1024 px wide) and C <= 128 (two channel boxes).  K1's wide path
// (corr_fused_xy_kernel<false, true, *>, "K1's wide path" further down)
// takes 128 < W2 <= 256: the same kernel and build over chunks of flat
// positions, each lane carrying its partial row sums from chunk to chunk.
// The wrapper raises beyond these limits, and DBAFusion checks its feature
// grid when it is built; K1-int8 and K1-raw keep W2 <= 128.
// Ragged grids: the tents above pool a level's partial block at the grid's
// end (as the Pallas kernel does); with kWhole a level pools the whole 2^l
// blocks only, level-0 columns [0, (W2 >> l) << l) and rows
// [0, (H2 >> l) << l), and reads zero past them, as DROID-SLAM's
// avg_pool2d pyramid does.  The two agree wherever 2^l divides H2 and W2;
// kWhole = false compiles to the partial-block code as it was.
//
// K1-int8: the int8=True branch of the same Pallas kernel
// (corr_pallas.py:232-259).  The volume rows stay f32; per (edge, tile of
// `tile` source pixels) q = round(vol * 127 / vmax) with vmax the tile's
// max |vol| over every target position, and per level the x tents are
// quantized as qx = round(127 * kx); P2 = bf16(sum_w q * qx * vmax / 127^2).
// It replaces a design of two launches (a max pass that built the volume
// and atomicMax-ed into a zeroed vmax, then K1 in int8 mode that built it
// again).  The scale has to exist before any block quantizes, and a tile
// (a multiple of 64 pixels) spans several of K1's 64-pixel blocks, which run
// in no order.  So one launch, a block per 64 pixels (corr_int8_kernel),
// whose blocks take their work in ticket order:
//  * Ticket: a block's first thread takes the next ticket from a counter
//    (atomicAdd); ticket k is block k % (P / 64) of edge k / (P / 64), so
//    the blocks of a tile hold consecutive tickets, and a block with a
//    lower ticket has started.
//  * Pass 1: each block builds its rows of the volume and keeps max |vol|
//    of the f32 accumulators.  Each warpgroup takes whole chunks of f2 in
//    two 64 x 64 wgmma halves (K1's build quarters a chunk among the
//    warpgroups, which reads f1 from shared memory twice as often; there,
//    under the lookup, that costs nothing, here it set the pace), so four
//    chunks are in work at once, each in its warpgroup's slot of a 4-slot
//    ring (the fourth where pass 2 keeps its volume chunks and sums).
//  * Exchange: warps reduce; the block publishes its maximum with this
//    launch's tag (st.release.gpu of one 64-bit word) and reads its tile's
//    other blocks' words (ld.acquire.gpu) until each carries the tag.  The
//    scale is max(vmax, 1e-20); the tile's first block writes it to
//    vmax[e, tile].  A block waits only on tickets of its own tile, and
//    every block publishes before it waits, so the blocks run to the end
//    whenever a tile's blocks fit on the card at once (the launch checks
//    that).  The last block to pass the exchange resets the counters and
//    moves the tag on, so a CUDA graph replays the launch as it is.  No
//    memset, no atomicMax, no second launch, no cluster.
//  * Pass 2: K1 with each chunk quantized from the f32 accumulators
//    straight into the shared volume chunk.  Integers up to 127 are exact
//    in bf16, so the chunk keeps its bf16 layout and the lookup its code: a
//    block sum is an exact integer in f32, and the x contraction of a tap is
//    qx0 * S0 + qx1 * S1, exact (below 2^24) as the int32 dot of the Pallas
//    kernel, then scaled and rounded to bf16 once.  The rounding points are
//    the Pallas kernel's; only the order of the f32 build sums differs,
//    which can flip a q by one quantum.
//  Pass 2's ring of three starts once pass 1 is done.  Bound on the H100:
//  the build's flops twice (the f32 volume of a block, 786 KB, cannot wait
//  between the passes); pass 2 is held by K1's lookup.  Int8 tensor cores
//  are not used: the port's x stage is two block sums per tap, not a
//  product, and the quantization needs the f32 build.  Measured on the card
//  and left out (PERF.md; NVIDIA H100 80GB HBM3, 700.00 W): a cluster per
//  (tile, edge) that exchanged the maxima through distributed shared memory
//  (1.19-1.22 ms at tile 256, with or without an f2 multicast, against
//  1.07-1.08 for the same kernel with clusters of one block: the clusters'
//  co-scheduling), a persistent grid of clusters and one block per tile
//  that walks its 64-pixel blocks (both slower: their loops pushed the
//  lookup's registers to the stack), and the exchange moved after pass 2's
//  first wgmma (1.139 against 1.111-1.113 ms).
//
// K1-raw: the raw=True branch (corr_pallas.py:515-516), the whole per-pixel
// 32 x 32 block with the diagonal-level extraction skipped.  Row i = l*7+dy
// is a y tap at level l, column j = l'*7+dx an x tap at level l', rows and
// columns 28-31 are 0; out (E, P, 1024) bf16, entry i*32 + j:
//   P2[h, j]  = bf16( sum_w vol[h, w] * bf16(kx_j(w)) )
//   out[i, j] = bf16( sum_h bf16(ky_i(h)) * P2[h, j] )
// It replaces a first design (one block per (64 pixels, edge, y level): the
// build four times, 256 of 640 lookup lanes busy, the x stage formed once
// per y level).  What bounds it: 784 sums a pixel (K1 has 196), 200 KB of
// f32 for 64 pixels, which do not fit in shared memory beside the ring.  So
// one block per (32 source pixels, edge), built once
// (corr_fused_xy_raw_kernel):
//  * Build with the wgmma operands swapped: A is the f2 chunk from the ring
//    (64 target positions a warpgroup), B the block's f1 tile (16 pixels a
//    warpgroup), so four warpgroups cover 128 x 32; each stores its tile
//    transposed into the [pixel][position] volume chunk.  No producer warp
//    (16 warps keep 128 registers each): thread 0 refills a slot of the
//    4-deep ring after the block's barrier past it.
//  * Lookup: every one of the 512 lanes works.  Lane (x level l', pixel, q)
//    (a warp holds one l' and 8 pixels) owns x taps 2q and 2q + 1 of l'
//    (q = 3: tap 6): per row it forms their P2 once from two block sums and
//    one shuffle, and adds them to each y level's sum of the current y
//    block in registers.  When a y block ends, the y tap before it is
//    complete: it is rounded and written to the block's staged output in
//    shared memory (66 KB, zeroed first: taps off the image and rows and
//    columns 28-31 stay 0).
//  * Epilogue: the staged output, 64 KB of contiguous output a block, with
//    16-byte stores.
// Bound on the H100: the build's flops once and the raw lookup's, against
// 302 MB of output at E=48, P=3072 (0.090 ms at 3.35 TB/s).

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

// kernel variants: K1 (bf16 volume) and K1-int8
constexpr int kBf16 = 0, kInt8 = 1;
constexpr float kQ = 127.f;                               // int8 steps per unit of the scale
constexpr float kInvQ2 = static_cast<float>(1.0 / (127.0 * 127.0));

constexpr int kF1Bytes = kMaxKB * kM * 128;          // 16 KB
constexpr int kStageBytes = kMaxKB * kN * 128;       // 32 KB
constexpr int kVolBytes = kM * kVolStride * 2;       // 17 KB
constexpr int kOffF2 = kF1Bytes;
constexpr int kOffVol = kOffF2 + kStages * kStageBytes;
constexpr int kOffAcc = kOffVol + 2 * kVolBytes;
constexpr int kOffBar = kOffAcc + kM * kAccStride * 4;
constexpr int kOffRed = kOffBar + 192;               // K1-int8: 16 warp maxima, scale, ticket
constexpr int kSmemBytes = kOffRed + 96 + 1024;      // + room to align the base to 1024
// K1-int8's first pass: a slot per warpgroup (chunk c goes to slot c % 4,
// the slot of warpgroup c % 4), the ring's three and one where pass 2 keeps
// its volume chunks and sums.  A warpgroup waits on its own slot's barrier
// only for the phase after the one it has consumed, so a phase parity can
// never be mistaken for one two phases on.
constexpr int kStages1 = kMmaWarps / 4;
static_assert(kStages1 == kStages + 1 && kStageBytes <= kOffBar - kOffVol,
              "K1-int8's pass-1 slots fit");

// K1-raw
constexpr int kRawM = 32;                  // source pixels per block
constexpr int kRawThreads = 512;           // 16 warps: the build and the lookup
constexpr int kRawStages = 4;              // f2 ring depth
constexpr int kRawBlock = 32 * 32;         // raw outputs per pixel
constexpr int kRawOutStride = kRawBlock + 8;  // bf16 per pixel of the staged output (16-byte rows)
constexpr int kRawOffF2 = kMaxKB * kRawM * 128;  // after the 8 KB f1 tile
constexpr int kRawOffVol = kRawOffF2 + kRawStages * kStageBytes;
constexpr int kRawOffStage = kRawOffVol + 2 * kRawM * kVolStride * 2;
constexpr int kRawOffBar = kRawOffStage + kRawM * kRawOutStride * 2;
constexpr int kRawSmemBytes = kRawOffBar + 64 + 1024;
static_assert(kRawSmemBytes <= 232448, "K1-raw's shared memory fits a block");

constexpr int kNoBlock = -(1 << 20);       // first block of an axis with no support

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

// K1-int8's exchange: a 64-bit word published to and read from the other
// blocks of the launch
__device__ __forceinline__ void st_release_gpu(uint64_t* p, uint64_t v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ uint64_t ld_acquire_gpu(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
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
template <int kR>
__device__ __forceinline__ void fence_acc(float (&d)[kR]) {
#pragma unroll
  for (int i = 0; i < kR; ++i) asm volatile("" : "+f"(d[i])::"memory");
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

__device__ __forceinline__ void wgmma_m64n16k16(float (&d)[8], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int kCount>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kCount) : "memory");
}

// The producer lane: the block's f1 tile (64 pixels from p0 of edge e) ...
__device__ __forceinline__ void produce_f1(const CUtensorMap* map_f1, uint32_t s_f1,
                                           uint32_t bar_f1, int p0, int e, int nkb) {
  mbar_expect_tx(bar_f1, nkb * kM * 128);
  for (int kb = 0; kb < nkb; ++kb)
    tma_load_3d(s_f1 + kb * kM * 128, map_f1, bar_f1, kb * kBoxC, p0, e);
}

// ... and the edge's f2 in nchunks chunks of kN positions (`span` = whole
// rows of them) through the ring.
__device__ __forceinline__ void produce_f2(const CUtensorMap* map_f2, uint32_t s_f2,
                                           uint32_t bar_full, uint32_t bar_empty, int nchunks,
                                           int span, int e, int nkb) {
  for (int c = 0; c < nchunks; ++c) {
    const int st = c % kStages;
    mbar_wait(bar_empty + 8 * st, ((c / kStages) & 1) ^ 1);
    mbar_expect_tx(bar_full + 8 * st, nkb * kN * 128);
    for (int kb = 0; kb < nkb; ++kb)
      tma_load_3d(s_f2 + st * kStageBytes + kb * kN * 128, map_f2, bar_full + 8 * st, kb * kBoxC,
                  c * span, e);
  }
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

// The x and y weights of level l.  int8: the x weights are the Pallas
// kernel's qx = round(127 * kx) (kx in f32), the y weights stay bf16.
template <int kMode>
__device__ __forceinline__ Level make_level(float x, float y, int l, int H2, int W2) {
  Level L;
  const float inv = 1.f / static_cast<float>(1 << l);
  const float s = static_cast<float>(1 << l);
  const float cx = x * inv, cy = y * inv;
  const float kx = floorf(cx), ky = floorf(cy);
  // union [(k0 - 3) s, (k0 + 5) s) against [0, size); false for NaN
  L.valid = (kx + 5.f) * s > 0.f && (kx - 3.f) * s < static_cast<float>(W2) &&
            (ky + 5.f) * s > 0.f && (ky - 3.f) * s < static_cast<float>(H2);
  L.gx0 = L.valid ? static_cast<int>(kx) - kRadius : 0;
  L.gy0 = L.valid ? static_cast<int>(ky) - kRadius : 0;
  if (kMode == kInt8) {
    L.wx0 = rintf((fmaxf(0.f, 1.f - fabsf(kx - cx)) * inv) * kQ);
    L.wx1 = rintf((fmaxf(0.f, 1.f - fabsf((kx + 1.f) - cx)) * inv) * kQ);
  } else {
    L.wx0 = round_bf16(fmaxf(0.f, 1.f - fabsf(kx - cx)) * inv);
    L.wx1 = round_bf16(fmaxf(0.f, 1.f - fabsf((kx + 1.f) - cx)) * inv);
  }
  L.wy0 = round_bf16(fmaxf(0.f, 1.f - fabsf(ky - cy)) * inv);
  L.wy1 = round_bf16(fmaxf(0.f, 1.f - fabsf((ky + 1.f) - cy)) * inv);
  return L;
}

// Sum of the bf16 values of block g (2^l columns) of one volume row, zero
// outside [0, W2) (the columns the level pools).  kVec: rows are 16-byte
// aligned and W2 % 8 == 0, so a block of 2, 4 or 8 columns is one aligned
// vector load.
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
template <int L, int kLanes, bool kVec, int kMode, bool kWhole>
__device__ __forceinline__ void lookup_chunk(float* acc, const Level& lv, int q,
                                             const __nv_bfloat16* row0, int h0, int nrows,
                                             int H2, int W2, float sc) {
  constexpr int nb = 8 / kLanes;
  const int a0 = q * nb;
  const int wl = kWhole ? (W2 >> L) << L : W2;  // the columns and rows level L pools
  const int hl = kWhole ? (H2 >> L) << L : H2;
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
      jy[k] = (r + k < nrows && lv.valid && (!kWhole || h0 + r + k < hl))
                  ? ((h0 + r + k) >> L) - lv.gy0 : -1;
      if (jy[k] > 7) jy[k] = -1;
      const __nv_bfloat16* row = row0 + (r + k) * W2;
#pragma unroll
      for (int t = 0; t < nb; ++t)
        S[k][t] = jy[k] >= 0 ? block_sum<kVec>(row, lv.gx0 + a0 + t, L, wl) : 0.f;
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

// This thread's part of one chunk's lookup: its level, with 4, 2, 2 or 2
// lanes per pixel at levels 3, 2, 1, 0.
template <bool kVec, int kMode, bool kWhole>
__device__ __forceinline__ void lookup_any(float* acc, const Level& lv, int lvl, int q,
                                           const __nv_bfloat16* row0, int h0, int nrows, int H2,
                                           int W2, float sc) {
  if (lvl == 3)
    lookup_chunk<3, 4, kVec, kMode, kWhole>(acc, lv, q, row0, h0, nrows, H2, W2, sc);
  else if (lvl == 2)
    lookup_chunk<2, 2, kVec, kMode, kWhole>(acc, lv, q, row0, h0, nrows, H2, W2, sc);
  else if (lvl == 1)
    lookup_chunk<1, 2, kVec, kMode, kWhole>(acc, lv, q, row0, h0, nrows, H2, W2, sc);
  else
    lookup_chunk<0, 2, kVec, kMode, kWhole>(acc, lv, q, row0, h0, nrows, H2, W2, sc);
}

// ---------------------------------------------------------------- K1's wide path

// K1 for 128 < W2 <= 256 (images up to 2048 px wide), bf16 only.  A chunk
// can no longer hold a whole row, so the chunks are the flat positions
// c*128 .. c*128 + 127 of f2, and a row spans two or three of them.  A
// chunk then holds the end of one row and the start of the next at most
// (W2 > 128), and only one row is open at a time: each lane carries the f32
// partial x sums of its taps for the open row (`carry`, wx0*S0 + wx1*S1 over
// the columns seen so far) from chunk to chunk, and rounds them to bf16 when
// the row ends, as the whole-row path rounds P2.  The y stage's row sums
// (`Q`, y block `jq`) live in registers across chunks and reach the shared
// sums when the y block changes and after the last chunk.  A block sum
// takes the block's columns that lie in the chunk (block_sum_span): a block
// split between two chunks is summed in two parts (the order of its f32
// sum changes, no rounding point does).

// Sum of the bf16 values of block g (2^L columns) of one volume row, over
// its columns in [lo, hi); column w sits at chunk position rs + w of
// `vrow`.  Levels 0 and 1: one or two loads.  Levels 2 and 3: the block's
// positions, wherever a row starts, lie in the two aligned 16-byte vectors
// from (first position) & ~7 on (a chunk row has 8 positions of padding
// past its 128), summed under a mask.
template <int L>
__device__ __forceinline__ float block_sum_span(const __nv_bfloat16* vrow, int rs, int g, int lo,
                                                int hi) {
  constexpr int s = 1 << L;
  const int pa = rs + max(g * s, lo), pb = rs + min(g * s + s, hi);
  if (pa >= pb) return 0.f;
  if (L < 2) {
    float acc = __bfloat162float(vrow[pa]);
    if (L == 1 && pb > pa + 1) acc += __bfloat162float(vrow[pa + 1]);
    return acc;
  }
  const int base = pa & ~7;
  const uint4 v0 = *reinterpret_cast<const uint4*>(vrow + base);
  const uint32_t u0[4] = {v0.x, v0.y, v0.z, v0.w};
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int p = base + 2 * j;
    acc += (p >= pa && p < pb ? bf_lo(u0[j]) : 0.f) + (p + 1 >= pa && p + 1 < pb ? bf_hi(u0[j]) : 0.f);
  }
  if (pb > base + 8) {
    const uint4 v1 = *reinterpret_cast<const uint4*>(vrow + base + 8);
    const uint32_t u1[4] = {v1.x, v1.y, v1.z, v1.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = base + 8 + 2 * j;
      acc += (p < pb ? bf_lo(u1[j]) : 0.f) + (p + 1 < pb ? bf_hi(u1[j]) : 0.f);
    }
  }
  return acc;
}

// Level L of one wide chunk: positions c0 .. c0 + n - 1 of the pixel's
// volume (`vrow`, chunk position 0), two row segments at most.  Lanes as in
// lookup_chunk.
template <int L, int kLanes, bool kWhole>
__device__ __forceinline__ void lookup_chunk_wide(float* acc, const Level& lv, int q,
                                                  const __nv_bfloat16* vrow, int c0, int n,
                                                  int H2, int W2, float (&carry)[4],
                                                  float (&Q)[4], int& jq) {
  constexpr int nb = 8 / kLanes;
  const int a0 = q * nb;
  const int wl = kWhole ? (W2 >> L) << L : W2;  // the columns and rows level L pools
  const int hl = kWhole ? (H2 >> L) << L : H2;
  const int r0 = c0 / W2;
  int jy[2], rs[2];
  bool ends[2];
  float S[2][nb + 1];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    rs[k] = (r0 + k) * W2 - c0;  // chunk position of the row's column 0
    const int lo = max(0, -rs[k]), hi = min(W2, n - rs[k]);
    ends[k] = hi > lo && hi == W2;
    jy[k] = (hi > lo && lv.valid && (!kWhole || r0 + k < hl)) ? ((r0 + k) >> L) - lv.gy0 : -1;
    if (jy[k] > 7) jy[k] = -1;
    const int hp = min(hi, wl);  // the segment's pooled columns
#pragma unroll
    for (int t = 0; t < nb; ++t)
      S[k][t] = jy[k] >= 0 ? block_sum_span<L>(vrow, rs[k], lv.gx0 + a0 + t, lo, hp) : 0.f;
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    // lanes of one pixel agree on jy; every lane of the warp takes part
    S[k][nb] = kLanes > 1 ? __shfl_down_sync(0xffffffffu, S[k][0], 1) : 0.f;
    if (jy[k] >= 0) {
#pragma unroll
      for (int t = 0; t < nb; ++t)
        if (a0 + t < kTaps) carry[t] += lv.wx0 * S[k][t] + lv.wx1 * S[k][t + 1];
    }
    if (ends[k]) {
      if (jy[k] >= 0) {
        if (jy[k] != jq) {
          if (jq >= 0) flush_rows<L, nb>(acc, lv, a0, jq, reinterpret_cast<float(&)[nb]>(Q));
#pragma unroll
          for (int t = 0; t < nb; ++t) Q[t] = 0.f;
          jq = jy[k];
        }
#pragma unroll
        for (int t = 0; t < nb; ++t) Q[t] += round_bf16(carry[t]);
      }
#pragma unroll
      for (int t = 0; t < nb; ++t) carry[t] = 0.f;
    }
  }
}

template <bool kWhole>
__device__ __forceinline__ void lookup_any_wide(float* acc, const Level& lv, int lvl, int q,
                                                const __nv_bfloat16* vrow, int c0, int n, int H2,
                                                int W2, float (&carry)[4], float (&Q)[4], int& jq) {
  if (lvl == 3) lookup_chunk_wide<3, 4, kWhole>(acc, lv, q, vrow, c0, n, H2, W2, carry, Q, jq);
  else if (lvl == 2) lookup_chunk_wide<2, 2, kWhole>(acc, lv, q, vrow, c0, n, H2, W2, carry, Q, jq);
  else if (lvl == 1) lookup_chunk_wide<1, 2, kWhole>(acc, lv, q, vrow, c0, n, H2, W2, carry, Q, jq);
  else lookup_chunk_wide<0, 2, kWhole>(acc, lv, q, vrow, c0, n, H2, W2, carry, Q, jq);
}

// After the last chunk: the open y block's row sums into the shared sums.
__device__ __forceinline__ void close_wide(float* acc, const Level& lv, int lvl, int q,
                                           float (&Q)[4], int jq) {
  if (jq < 0) return;
  if (lvl == 3) flush_rows<3, 2>(acc, lv, q * 2, jq, reinterpret_cast<float(&)[2]>(Q));
  else if (lvl == 2) flush_rows<2, 4>(acc, lv, q * 4, jq, Q);
  else if (lvl == 1) flush_rows<1, 4>(acc, lv, q * 4, jq, Q);
  else flush_rows<0, 4>(acc, lv, q * 4, jq, Q);
}

// ---------------------------------------------------------------- the kernel

// Issues this warpgroup's wgmma on its quarter of the positions of the f2
// tile at `tile` (64 x 32, K = Cpad), without waiting for it; issue_chunk
// first waits for ring chunk c to land.
__device__ __forceinline__ void issue_tile(float (&d)[kAcc], uint32_t tile, uint32_t s_f1, int wg,
                                           int nkb) {
  wgmma_fence();
  const uint32_t b_base = tile + wg * kWgN * 128;
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

__device__ __forceinline__ void issue_chunk(float (&d)[kAcc], int c, uint32_t bar_full,
                                            uint32_t s_f1, uint32_t s_f2, int wg, int nkb) {
  const int st = c % kStages;
  mbar_wait(bar_full + 8 * st, (c / kStages) & 1);
  issue_tile(d, s_f2 + st * kStageBytes, s_f1, wg, nkb);
}

// Waits for ring chunk c's wgmma, frees its ring slot and stores the bf16
// volume chunk to buffer `buf` (int8: round(vol * qs), exact in bf16).
// Accumulator fragment: row 16*warp + lane/4 (+8), column 8j + 2*(lane%4)
// (+1) of the warpgroup's 32 positions.
template <int kMode>
__device__ __forceinline__ void finish_chunk(float (&d)[kAcc], int c, int buf,
                                             uint32_t bar_empty, __nv_bfloat16* vol, int wg,
                                             int warp, int lane, float qs) {
  wgmma_wait0();
  fence_acc(d);
  if (lane == 0) mbar_arrive(bar_empty + 8 * (c % kStages));
  if (kMode == kInt8) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) d[i] = rintf(d[i] * qs);
  }
  __nv_bfloat16* vbuf = vol + buf * (kM * kVolStride);
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

// Shared memory of K1 and K1-int8 (base aligned to 1024 for the swizzle).
struct K1Smem {
  uint32_t s_f1, s_f2;           // f1 tile, f2 ring
  __nv_bfloat16* vol;            // two volume chunks
  float* acc;                    // the sums, kAccStride per pixel
  float* red;                    // K1-int8: 16 warp maxima, the tile's scale, ticket and tag
  uint32_t bar_full, bar_empty;  // kStages each
  uint32_t bar_f1;               // the f1 tile landed
  uint32_t bar_full1, bar_empty1;  // K1-int8's pass-1 ring, kStages1 each
  uint32_t bar_pass1;            // K1-int8: the MMA warps are past pass 1
};

__device__ __forceinline__ K1Smem k1_smem(unsigned char* smem_raw) {
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  K1Smem m;
  m.s_f1 = smem_u32(smem);
  m.s_f2 = m.s_f1 + kOffF2;
  m.vol = reinterpret_cast<__nv_bfloat16*>(smem + kOffVol);
  m.acc = reinterpret_cast<float*>(smem + kOffAcc);
  m.red = reinterpret_cast<float*>(smem + kOffRed);
  m.bar_full = m.s_f1 + kOffBar;
  m.bar_empty = m.bar_full + 8 * kStages;
  m.bar_f1 = m.bar_empty + 8 * kStages;
  m.bar_full1 = m.bar_f1 + 8;
  m.bar_empty1 = m.bar_full1 + 8 * kStages1;
  m.bar_pass1 = m.bar_empty1 + 8 * kStages1;
  return m;
}

// Slot st of K1-int8's pass-1 ring: the ring's kStages, then one in the
// volume chunks' and sums' place.
__device__ __forceinline__ uint32_t pass1_slot(const K1Smem& m, int st) {
  return st < kStages ? m.s_f2 + st * kStageBytes : m.s_f1 + kOffVol;
}

// The epilogue of a K1 block: its 64 pixels' sums rounded to bf16, with
// 16-byte stores where the block's output is aligned.
__device__ __forceinline__ void k1_store(const K1Smem& m, __nv_bfloat16* __restrict__ out,
                                         int tid, int e, int p0, int P) {
  const int np = min(kM, P - p0);
  const int n = np * kChannels;
  __nv_bfloat16* dst = out + (static_cast<size_t>(e) * P + p0) * kChannels;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    for (int i = tid * 8; i < n; i += kConsumers * 8) {
      __align__(16) __nv_bfloat16 v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int idx = min(i + k, n - 1);
        v[k] = __float2bfloat16(m.acc[(idx / kChannels) * kAccStride + idx % kChannels]);
      }
      if (i + 8 <= n) {
        *reinterpret_cast<uint4*>(dst + i) = *reinterpret_cast<const uint4*>(v);
      } else {
        for (int k = 0; i + k < n; ++k) dst[i + k] = v[k];
      }
    }
  } else {
    for (int i = tid; i < n; i += kConsumers)
      dst[i] = __float2bfloat16(m.acc[(i / kChannels) * kAccStride + i % kChannels]);
  }
}

// The consumers' build + lookup of one block (64 pixels from p0, edge e);
// int8 (kMode kInt8): the tile's step qs and scale sc.  kWhole: the levels
// pool whole blocks only.
template <bool kVec, int kMode, bool kWhole>
__device__ __forceinline__ void k1_block(const K1Smem& m, const float* __restrict__ coords,
                                         __nv_bfloat16* __restrict__ out, int tid, int e, int p0,
                                         int P, int H2, int W2, int nkb, float qs, float sc) {
  const int rc = kN / W2;                   // whole rows per chunk
  const int nchunks = (H2 + rc - 1) / rc;
  const int wg = tid / 128;       // wgmma warpgroup (0-3): its quarter of the chunk's positions
  const int wtid = tid % 128;
  const int warp = wtid / 32, lane = tid % 32;
  const bool mma = tid < kMmaWarps * 32;

  // lookup role of this thread (see the header): level, pixel, lane of the pixel
  const int lvl = tid < 256 ? 3 : tid < 384 ? 2 : tid < 512 ? 1 : 0;
  const int pix = lvl == 3 ? tid >> 2 : (tid - 256 - 128 * (2 - lvl)) >> 1;
  const int q = lvl == 3 ? tid & 3 : tid & 1;

  for (int i = tid; i < kM * kAccStride; i += kConsumers) m.acc[i] = 0.f;
  const bool live = p0 + pix < P;
  float2 xy = make_float2(__int_as_float(0x7fc00000), 0.f);  // NaN: no support
  if (live) xy = reinterpret_cast<const float2*>(coords)[static_cast<size_t>(e) * P + p0 + pix];
  const Level lv = make_level<kMode>(xy.x, xy.y, lvl, H2, W2);
  float* my_acc = m.acc + pix * kAccStride;

  float d[kAcc];
  if (mma) {
    mbar_wait(m.bar_f1, 0);
    issue_chunk(d, 0, m.bar_full, m.s_f1, m.s_f2, wg, nkb);
    finish_chunk<kMode>(d, 0, 0, m.bar_empty, m.vol, wg, warp, lane, qs);
  }
  consumer_sync<kConsumers>();

  // chunk c + 1 runs on the tensor cores under chunk c's lookup; the last
  // chunk's lookup runs alone
  for (int c = 0; c + 1 < nchunks; ++c) {
    if (mma) issue_chunk(d, c + 1, m.bar_full, m.s_f1, m.s_f2, wg, nkb);
    lookup_any<kVec, kMode, kWhole>(my_acc, lv, lvl, q,
                                    m.vol + (c & 1) * (kM * kVolStride) + pix * kVolStride,
                                    c * rc, min(rc, H2 - c * rc), H2, W2, sc);
    if (mma)
      finish_chunk<kMode>(d, c + 1, (c + 1) & 1, m.bar_empty, m.vol, wg, warp, lane, qs);
    consumer_sync<kConsumers>();
  }
  {
    const int c = nchunks - 1;
    lookup_any<kVec, kMode, kWhole>(my_acc, lv, lvl, q,
                                    m.vol + (c & 1) * (kM * kVolStride) + pix * kVolStride,
                                    c * rc, min(rc, H2 - c * rc), H2, W2, sc);
  }

  consumer_sync<kConsumers>();

  // ---- epilogue
  k1_store(m, out, tid, e, p0, P);
}

// K1's wide path (W2 > 128): k1_block with the chunks of flat positions and
// the lookup's carried row sums (see lookup_chunk_wide).
template <bool kWhole>
__device__ __forceinline__ void k1_block_wide(const K1Smem& m, const float* __restrict__ coords,
                                              __nv_bfloat16* __restrict__ out, int tid, int e,
                                              int p0, int P, int H2, int W2, int nkb) {
  const int P2 = H2 * W2;
  const int nchunks = (P2 + kN - 1) / kN;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const bool mma = tid < kMmaWarps * 32;
  const int lvl = tid < 256 ? 3 : tid < 384 ? 2 : tid < 512 ? 1 : 0;
  const int pix = lvl == 3 ? tid >> 2 : (tid - 256 - 128 * (2 - lvl)) >> 1;
  const int q = lvl == 3 ? tid & 3 : tid & 1;

  for (int i = tid; i < kM * kAccStride; i += kConsumers) m.acc[i] = 0.f;
  float2 xy = make_float2(__int_as_float(0x7fc00000), 0.f);  // NaN: no support
  if (p0 + pix < P) xy = reinterpret_cast<const float2*>(coords)[static_cast<size_t>(e) * P + p0 + pix];
  const Level lv = make_level<kBf16>(xy.x, xy.y, lvl, H2, W2);
  float* my_acc = m.acc + pix * kAccStride;
  float carry[4] = {0.f, 0.f, 0.f, 0.f}, Q[4] = {0.f, 0.f, 0.f, 0.f};
  int jq = -1;

  float d[kAcc];
  if (mma) {
    mbar_wait(m.bar_f1, 0);
    issue_chunk(d, 0, m.bar_full, m.s_f1, m.s_f2, wg, nkb);
    finish_chunk<kBf16>(d, 0, 0, m.bar_empty, m.vol, wg, warp, lane, 0.f);
  }
  consumer_sync<kConsumers>();
  for (int c = 0; c + 1 < nchunks; ++c) {
    if (mma) issue_chunk(d, c + 1, m.bar_full, m.s_f1, m.s_f2, wg, nkb);
    lookup_any_wide<kWhole>(my_acc, lv, lvl, q,
                            m.vol + (c & 1) * (kM * kVolStride) + pix * kVolStride, c * kN, kN,
                            H2, W2, carry, Q, jq);
    if (mma)
      finish_chunk<kBf16>(d, c + 1, (c + 1) & 1, m.bar_empty, m.vol, wg, warp, lane, 0.f);
    consumer_sync<kConsumers>();
  }
  {
    const int c = nchunks - 1;
    lookup_any_wide<kWhole>(my_acc, lv, lvl, q,
                            m.vol + (c & 1) * (kM * kVolStride) + pix * kVolStride, c * kN,
                            P2 - c * kN, H2, W2, carry, Q, jq);
  }
  close_wide(my_acc, lv, lvl, q, Q, jq);
  consumer_sync<kConsumers>();
  k1_store(m, out, tid, e, p0, P);
}

// K1: one block per (64 source pixels, edge).  kWide (W2 > 128): f2 in
// chunks of 128 flat positions, looked up by k1_block_wide; else chunks of
// RC = 128 / W2 whole rows, by k1_block.  kWhole: whole-block pooling.
template <bool kVec, bool kWide, bool kWhole>
__global__ void __launch_bounds__(kThreads, 1)
corr_fused_xy_kernel(const __grid_constant__ CUtensorMap map_f1,  // (E, P, Cpad) bf16
                     const __grid_constant__ CUtensorMap map_f2,  // (E, P2, Cpad) bf16
                     const float* __restrict__ coords,           // (E, P, 2)
                     __nv_bfloat16* __restrict__ out,            // (E, P, 196)
                     int P, int H2, int W2, int nkb) {
  extern __shared__ unsigned char smem_raw[];
  const K1Smem m = k1_smem(smem_raw);
  const int e = blockIdx.y;
  const int p0 = blockIdx.x * kM;
  const int tid = threadIdx.x;
  const int rc = kN / W2;
  const int span = kWide ? kN : rc * W2;  // f2 positions per chunk
  const int nchunks = kWide ? (H2 * W2 + kN - 1) / kN : (H2 + rc - 1) / rc;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(m.bar_full + 8 * i, 1);
      mbar_init(m.bar_empty + 8 * i, kMmaWarps);
    }
    mbar_init(m.bar_f1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warp: one lane issues every TMA load
    if (tid == kConsumers) {
      produce_f1(&map_f1, m.s_f1, m.bar_f1, p0, e, nkb);
      produce_f2(&map_f2, m.s_f2, m.bar_full, m.bar_empty, nchunks, span, e, nkb);
    }
    return;
  }
  if constexpr (kWide)
    k1_block_wide<kWhole>(m, coords, out, tid, e, p0, P, H2, W2, nkb);
  else
    k1_block<kVec, kBf16, kWhole>(m, coords, out, tid, e, p0, P, H2, W2, nkb, 0.f, 0.f);
}

// K1-int8: a block per 64 pixels of an edge, in ticket order (the
// header).  Each block builds its rows for max |vol| (pass 1), publishes
// its maximum and takes the tile's from its tile's blocks (the exchange),
// and runs K1 on its rows with the volume quantized at that scale (pass
// 2).  Pass 1 needs no volume chunks or sums, so its ring has a fourth
// slot in their place; pass 2's ring starts when pass 1 is done, and
// fills while the block waits in the exchange.  `sync`: the ticket
// counter, the count of blocks past the exchange, the last launch's tag,
// a word of padding, then a 64-bit word per block ((tag << 32) | bits of
// its maximum); zeroed once by the caller.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
corr_int8_kernel(const __grid_constant__ CUtensorMap map_f1,  // (E, P, Cpad) bf16
                 const __grid_constant__ CUtensorMap map_f2,  // (E, P2, Cpad) bf16
                 const float* __restrict__ coords,           // (E, P, 2)
                 __nv_bfloat16* __restrict__ out,            // (E, P, 196)
                 float* __restrict__ vmax,                   // (E, P / tile) f32
                 uint32_t* __restrict__ sync,                // 4 + 2 * E * P / 64 words
                 int P, int H2, int W2, int nkb, int tile) {
  extern __shared__ unsigned char smem_raw[];
  const K1Smem m = k1_smem(smem_raw);
  const int tid = threadIdx.x;
  uint32_t* item = reinterpret_cast<uint32_t*>(m.red + kMmaWarps + 1);  // ticket, tag
  const int rc = kN / W2;
  const int nchunks = (H2 + rc - 1) / rc;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(m.bar_full + 8 * i, 1);
      mbar_init(m.bar_empty + 8 * i, kMmaWarps);
    }
    mbar_init(m.bar_f1, 1);
    for (int i = 0; i < kStages1; ++i) {
      mbar_init(m.bar_full1 + 8 * i, 1);
      mbar_init(m.bar_empty1 + 8 * i, 4);  // one warpgroup takes a chunk
    }
    mbar_init(m.bar_pass1, kMmaWarps);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    item[0] = atomicAdd(sync, 1u);
    // the tag moves on only after every block of this launch has read it
    // (the last block past the exchange moves it)
    item[1] = *reinterpret_cast<volatile uint32_t*>(sync + 2) + 1u;
  }
  __syncthreads();
  const int nb = P / kM;  // blocks an edge
  const int k = static_cast<int>(item[0]);
  const uint32_t tag = item[1];
  const int e = k / nb, blk = k % nb;
  const int p0 = blk * kM;

  if (tid >= kConsumers) {
    if (tid == kConsumers) {
      produce_f1(&map_f1, m.s_f1, m.bar_f1, p0, e, nkb);
      for (int c = 0; c < nchunks; ++c) {
        const int st = c % kStages1;
        mbar_wait(m.bar_empty1 + 8 * st, ((c / kStages1) & 1) ^ 1);
        mbar_expect_tx(m.bar_full1 + 8 * st, nkb * kN * 128);
        for (int kb = 0; kb < nkb; ++kb)
          tma_load_3d(pass1_slot(m, st) + kb * kN * 128, &map_f2, m.bar_full1 + 8 * st,
                      kb * kBoxC, c * rc * W2, e);
      }
      // pass 2's ring overlaps pass 1's: it starts once pass 1 is done
      mbar_wait(m.bar_pass1, 0);
      produce_f2(&map_f2, m.s_f2, m.bar_full, m.bar_empty, nchunks, rc * W2, e, nkb);
    }
    return;
  }

  // ---- pass 1: max |vol| of this block's rows over every chunk.  Each
  // warpgroup takes whole chunks (wg, wg + 4, ...), in two 64 x 64 halves:
  // quartering a chunk among the warpgroups, as the lookup pass does, reads
  // f1 from shared memory twice as often, and shared memory, not the
  // tensor cores, would set the pace.
  const int wg = tid / 128, lane = tid % 32;
  if (tid < kMmaWarps * 32) {
    float d[32];
    float mx = 0.f;
    mbar_wait(m.bar_f1, 0);
    for (int c = wg; c < nchunks; c += kMmaWarps / 4) {
      const int st = c % kStages1;
      mbar_wait(m.bar_full1 + 8 * st, (c / kStages1) & 1);
      for (int half = 0; half < 2; ++half) {
        wgmma_fence();
#pragma unroll
        for (int kb = 0; kb < kMaxKB; ++kb) {
          if (kb >= nkb) break;
          const uint64_t da = desc_sw128(m.s_f1 + kb * kM * 128);
          const uint64_t db = desc_sw128(pass1_slot(m, st) + kb * kN * 128 + half * 64 * 128);
#pragma unroll
          for (int j = 0; j < kBoxC / 16; ++j)
            wgmma_m64n64k16(d, da + 2 * j, db + 2 * j, (kb | j) != 0);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_acc(d);
#pragma unroll
        for (int i = 0; i < 32; ++i) mx = fmaxf(mx, fabsf(d[i]));
      }
      if (lane == 0) mbar_arrive(m.bar_empty1 + 8 * st);
    }
    if (lane == 0) mbar_arrive(m.bar_pass1);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) m.red[tid / 32] = mx;
  }
  consumer_sync<kConsumers>();
  // ---- the exchange: publish, then read the words of the tile's blocks
  // (tickets k0 .. k0 + tile / 64 - 1) until each carries this launch's tag
  if (tid == 0) {
    float b = 0.f;
    for (int w = 0; w < kMmaWarps; ++w) b = fmaxf(b, m.red[w]);
    uint64_t* words = reinterpret_cast<uint64_t*>(sync + 4);
    st_release_gpu(words + k, (static_cast<uint64_t>(tag) << 32) | __float_as_uint(b));
    const int cs = tile / kM, k0 = k - blk % cs;
    float vm = 0.f;
    for (int j = 0; j < cs; ++j) {
      uint64_t w = ld_acquire_gpu(words + k0 + j);
      while (static_cast<uint32_t>(w >> 32) != tag) {
        __nanosleep(64);
        w = ld_acquire_gpu(words + k0 + j);
      }
      vm = fmaxf(vm, __uint_as_float(static_cast<uint32_t>(w)));
    }
    vm = fmaxf(vm, 1e-20f);
    m.red[kMmaWarps] = vm;
    if (blk % cs == 0) vmax[static_cast<size_t>(e) * (nb / cs) + blk / cs] = vm;
    // the last block past the exchange: every block has its ticket and its
    // tile's scale, so the counters start over and the tag moves on
    if (atomicAdd(sync + 1, 1u) == gridDim.x - 1) {
      sync[0] = 0u;
      sync[1] = 0u;
      sync[2] = tag;
    }
  }
  consumer_sync<kConsumers>();
  const float vm = m.red[kMmaWarps];
  k1_block<kVec, kInt8, false>(m, coords, out, tid, e, p0, P, H2, W2, nkb, kQ / vm, vm * kInvQ2);
}

// ---------------------------------------------------------------- K1-raw

// One axis of one level for K1-raw: the union's first block and the two
// bf16 tent weights; an axis whose union misses the image (or a NaN
// coordinate) gets no block in range and zero weights.
struct Axis {
  int g0;
  float w0, w1;
};

__device__ __forceinline__ Axis make_axis(float c, int l, int size) {
  const float inv = 1.f / static_cast<float>(1 << l);
  const float s = static_cast<float>(1 << l);
  const float cm = c * inv, k = floorf(cm);
  const bool ok = (k + 5.f) * s > 0.f && (k - 3.f) * s < static_cast<float>(size);
  Axis a;
  a.g0 = ok ? static_cast<int>(k) - kRadius : kNoBlock;
  a.w0 = ok ? round_bf16(fmaxf(0.f, 1.f - fabsf(k - cm)) * inv) : 0.f;
  a.w1 = ok ? round_bf16(fmaxf(0.f, 1.f - fabsf((k + 1.f) - cm)) * inv) : 0.f;
  return a;
}

// A lookup lane's state across chunks, per y level ly: Q[ly][t] the P2 of
// the rows of the current y block at its x tap t, pend[ly][t] the w0 part
// of the y tap that block starts (its w1 part comes from the next block);
// h the last row added.  A y tap is complete once the block after its own
// is summed: it is rounded to bf16 then and written to the block's staged
// output, `out` (this lane's first entry: the pixel's row, column
// L*7 + 2q; `two`: the lane has a second x tap).
struct RawSums {
  float Q[4][2];
  float pend[4][2];
  int h;
};

// Ends level ly's current y block jq (that of row s.h): y tap jq - 1 is
// complete, tap jq gets its w0 part, and a new block starts.
template <int ly>
__device__ __forceinline__ void raw_flush(RawSums& s, const Axis& ay, __nv_bfloat16* out,
                                          bool two) {
  const int jq = (s.h >> ly) - ay.g0;
  if (jq >= 0 && jq <= 7) {
    if (jq >= 1) {
      __nv_bfloat16* o = out + (ly * kTaps + jq - 1) * 32;
      o[0] = __float2bfloat16(s.pend[ly][0] + ay.w1 * s.Q[ly][0]);
      if (two) o[1] = __float2bfloat16(s.pend[ly][1] + ay.w1 * s.Q[ly][1]);
    }
    s.pend[ly][0] = ay.w0 * s.Q[ly][0];
    s.pend[ly][1] = ay.w0 * s.Q[ly][1];
  }
  s.Q[ly][0] = 0.f;
  s.Q[ly][1] = 0.f;
}

// After the last row: the last block's flush, and its own y tap (whose next
// block lies past the image) is complete with its w0 part alone.
template <int ly>
__device__ __forceinline__ void raw_close(RawSums& s, const Axis& ay, __nv_bfloat16* out,
                                          bool two) {
  raw_flush<ly>(s, ay, out, two);
  const int jq = (s.h >> ly) - ay.g0;
  if (jq >= 0 && jq <= kTaps - 1) {
    __nv_bfloat16* o = out + (ly * kTaps + jq) * 32;
    o[0] = __float2bfloat16(s.pend[ly][0]);
    if (two) o[1] = __float2bfloat16(s.pend[ly][1]);
  }
}

// Row h into level ly: a row that starts a y block (rows come in order, one
// after the other) ends the previous one.
template <int ly>
__device__ __forceinline__ void raw_add(RawSums& s, const Axis& ay, int h, float P0, float P1,
                                        __nv_bfloat16* out, bool two) {
  if ((h & ((1 << ly) - 1)) == 0) raw_flush<ly>(s, ay, out, two);
  const int jy = (h >> ly) - ay.g0;
  if (jy >= 0 && jy <= 7) {
    s.Q[ly][0] += P0;
    s.Q[ly][1] += P1;
  }
}

// Rows h0 .. h0 + nrows - 1 of the pixel's volume at x level L: this lane's
// taps 2q and 2q + 1 from block sums 2q, 2q + 1 and lane q + 1's 2q + 2, two
// rows at a time so that both rows' loads are in flight together.
template <int L, bool kVec>
__device__ __forceinline__ void raw_rows(RawSums& s, const Axis& ax, const Axis (&ay)[4], int q,
                                         const __nv_bfloat16* row0, int h0, int nrows, int W2,
                                         __nv_bfloat16* out) {
  for (int r = 0; r < nrows; r += 2) {
    float S[2][3];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const __nv_bfloat16* row = row0 + (r + k) * W2;
      const bool in = r + k < nrows;
      S[k][0] = in ? block_sum<kVec>(row, ax.g0 + 2 * q, L, W2) : 0.f;
      S[k][1] = in ? block_sum<kVec>(row, ax.g0 + 2 * q + 1, L, W2) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) S[k][2] = __shfl_down_sync(0xffffffffu, S[k][0], 1);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (r + k >= nrows) break;
      const int h = h0 + r + k;
      const float P0 = round_bf16(ax.w0 * S[k][0] + ax.w1 * S[k][1]);
      const float P1 = round_bf16(ax.w0 * S[k][1] + ax.w1 * S[k][2]);
      raw_add<0>(s, ay[0], h, P0, P1, out, q < 3);
      raw_add<1>(s, ay[1], h, P0, P1, out, q < 3);
      raw_add<2>(s, ay[2], h, P0, P1, out, q < 3);
      raw_add<3>(s, ay[3], h, P0, P1, out, q < 3);
      s.h = h;
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void raw_lookup(RawSums& s, int L, const Axis& ax, const Axis (&ay)[4],
                                           int q, const __nv_bfloat16* row0, int h0, int nrows,
                                           int W2, __nv_bfloat16* out) {
  if (L == 0) raw_rows<0, kVec>(s, ax, ay, q, row0, h0, nrows, W2, out);
  else if (L == 1) raw_rows<1, kVec>(s, ax, ay, q, row0, h0, nrows, W2, out);
  else if (L == 2) raw_rows<2, kVec>(s, ax, ay, q, row0, h0, nrows, W2, out);
  else raw_rows<3, kVec>(s, ax, ay, q, row0, h0, nrows, W2, out);
}

// Thread 0: chunk c of the edge's f2 into ring slot c % kRawStages.
__device__ __forceinline__ void raw_load(const CUtensorMap* map_f2, uint32_t s_f2,
                                         uint32_t bar_full, int c, int span, int e, int nkb) {
  const int st = c % kRawStages;
  mbar_expect_tx(bar_full + 8 * st, nkb * kN * 128);
  for (int kb = 0; kb < nkb; ++kb)
    tma_load_3d(s_f2 + st * kStageBytes + kb * kN * 128, map_f2, bar_full + 8 * st, kb * kBoxC,
                c * span, e);
}

// Waits for chunk c's f2 tile and issues this warpgroup's wgmma: A the
// chunk's positions 64 * (wg & 1) .. + 63, B the block's pixels
// 16 * (wg >> 1) .. + 15, K = Cpad.
__device__ __forceinline__ void raw_issue(float (&d)[8], int c, uint32_t bar_full, uint32_t s_f1,
                                          uint32_t s_f2, int wg, int nkb) {
  const int st = c % kRawStages;
  mbar_wait(bar_full + 8 * st, (c / kRawStages) & 1);
  wgmma_fence();
  const uint32_t a_base = s_f2 + st * kStageBytes + (wg & 1) * 64 * 128;
  const uint32_t b_base = s_f1 + (wg >> 1) * 16 * 128;
#pragma unroll
  for (int kb = 0; kb < kMaxKB; ++kb) {
    if (kb >= nkb) break;
    const uint64_t da = desc_sw128(a_base + kb * kN * 128);
    const uint64_t db = desc_sw128(b_base + kb * kRawM * 128);
#pragma unroll
    for (int k = 0; k < kBoxC / 16; ++k)
      wgmma_m64n16k16(d, da + 2 * k, db + 2 * k, (kb | k) != 0);
  }
  wgmma_commit();
}

// Waits for the wgmma and stores the tile transposed, bf16, to volume
// buffer `buf` ([pixel][position]).  Fragment: position 16*warp + lane/4
// (+8), pixel 8j + 2*(lane%4) (+1) of the warpgroup's 64 x 16.
__device__ __forceinline__ void raw_finish(float (&d)[8], int buf, __nv_bfloat16* vol, int wg,
                                           int warp, int lane) {
  wgmma_wait0();
  fence_acc(d);
  __nv_bfloat16* vbuf = vol + buf * (kRawM * kVolStride);
  const int n = 64 * (wg & 1) + 16 * warp + lane / 4;
  const int p = 16 * (wg >> 1) + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    __nv_bfloat16* col = vbuf + (p + 8 * j) * kVolStride + n;
    col[0] = __float2bfloat16(d[4 * j]);
    col[kVolStride] = __float2bfloat16(d[4 * j + 1]);
    col[8] = __float2bfloat16(d[4 * j + 2]);
    col[kVolStride + 8] = __float2bfloat16(d[4 * j + 3]);
  }
}

// K1-raw: one block per (32 source pixels, edge), 16 warps that build and
// look up; thread 0 refills a ring slot once the block is past it.
template <bool kVec>
__global__ void __launch_bounds__(kRawThreads, 1)
corr_fused_xy_raw_kernel(const __grid_constant__ CUtensorMap map_f1,  // (E, P, Cpad), 32-row boxes
                         const __grid_constant__ CUtensorMap map_f2,  // (E, P2, Cpad)
                         const float* __restrict__ coords,           // (E, P, 2)
                         __nv_bfloat16* __restrict__ out,            // (E, P, 1024)
                         int P, int H2, int W2, int nkb) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t s_f1 = smem_u32(smem);
  const uint32_t s_f2 = s_f1 + kRawOffF2;
  __nv_bfloat16* vol = reinterpret_cast<__nv_bfloat16*>(smem + kRawOffVol);
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(smem + kRawOffStage);
  const uint32_t bar_full = s_f1 + kRawOffBar;  // kRawStages barriers
  const uint32_t bar_f1 = bar_full + 8 * kRawStages;

  const int e = blockIdx.y;
  const int p0 = blockIdx.x * kRawM;
  const int tid = threadIdx.x;
  const int rc = kN / W2;
  const int nchunks = (H2 + rc - 1) / rc;

  if (tid == 0) {
    for (int i = 0; i < kRawStages; ++i) mbar_init(bar_full + 8 * i, 1);
    mbar_init(bar_f1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(bar_f1, nkb * kRawM * 128);
    for (int kb = 0; kb < nkb; ++kb)
      tma_load_3d(s_f1 + kb * kRawM * 128, &map_f1, bar_f1, kb * kBoxC, p0, e);
    for (int c = 0; c < min(kRawStages, nchunks); ++c)
      raw_load(&map_f2, s_f2, bar_full, c, rc * W2, e, nkb);
  }
  // the staged output starts at 0: taps whose blocks miss the image, and
  // rows and columns 28-31
  for (int i = tid; i < kRawM * kRawOutStride / 8; i += kRawThreads)
    reinterpret_cast<uint4*>(stage)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  // lookup role: x level L (warps 4L .. 4L + 3), pixel, q (taps 2q, 2q + 1)
  const int L = tid / 128;
  const int pix = ((tid / 32) & 3) * 8 + lane / 4;
  const int q = lane & 3;
  float2 xy = make_float2(__int_as_float(0x7fc00000), __int_as_float(0x7fc00000));
  if (p0 + pix < P) xy = reinterpret_cast<const float2*>(coords)[static_cast<size_t>(e) * P + p0 + pix];
  const Axis ax = make_axis(xy.x, L, W2);
  Axis ay[4];
#pragma unroll
  for (int l = 0; l < 4; ++l) ay[l] = make_axis(xy.y, l, H2);

  RawSums s;
#pragma unroll
  for (int l = 0; l < 4; ++l) s.Q[l][0] = s.Q[l][1] = s.pend[l][0] = s.pend[l][1] = 0.f;
  s.h = -(1 << 24);  // before every row: no y block of any level in range
  __nv_bfloat16* my_out = stage + pix * kRawOutStride + L * kTaps + 2 * q;

  // chunk c + 1 runs on the tensor cores under chunk c's lookup; after the
  // block's barrier every warpgroup is past chunk c + 1's slot, which takes
  // chunk c + 1 + kRawStages
  float d[8];
  mbar_wait(bar_f1, 0);
  raw_issue(d, 0, bar_full, s_f1, s_f2, wg, nkb);
  raw_finish(d, 0, vol, wg, warp, lane);
  __syncthreads();
  if (tid == 0 && kRawStages < nchunks) raw_load(&map_f2, s_f2, bar_full, kRawStages, rc * W2, e, nkb);
  for (int c = 0; c + 1 < nchunks; ++c) {
    raw_issue(d, c + 1, bar_full, s_f1, s_f2, wg, nkb);
    raw_lookup<kVec>(s, L, ax, ay, q, vol + (c & 1) * (kRawM * kVolStride) + pix * kVolStride,
                     c * rc, min(rc, H2 - c * rc), W2, my_out);
    raw_finish(d, (c + 1) & 1, vol, wg, warp, lane);
    __syncthreads();
    if (tid == 0 && c + 1 + kRawStages < nchunks)
      raw_load(&map_f2, s_f2, bar_full, c + 1 + kRawStages, rc * W2, e, nkb);
  }
  {
    const int c = nchunks - 1;
    raw_lookup<kVec>(s, L, ax, ay, q, vol + (c & 1) * (kRawM * kVolStride) + pix * kVolStride,
                     c * rc, min(rc, H2 - c * rc), W2, my_out);
  }
  raw_close<0>(s, ay[0], my_out, q < 3);
  raw_close<1>(s, ay[1], my_out, q < 3);
  raw_close<2>(s, ay[2], my_out, q < 3);
  raw_close<3>(s, ay[3], my_out, q < 3);
  __syncthreads();

  // ---- epilogue: the staged output with 16-byte stores
  const int np = min(kRawM, P - p0);
  for (int i = tid; i < np * (kRawBlock / 8); i += kRawThreads) {
    const int p = i / (kRawBlock / 8), o = (i % (kRawBlock / 8)) * 8;
    *reinterpret_cast<uint4*>(out + (static_cast<size_t>(e) * P + p0 + p) * kRawBlock + o) =
        *reinterpret_cast<const uint4*>(stage + p * kRawOutStride + o);
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

// f1 in boxes of f1_rows pixels, f2 in boxes of a chunk's kN positions
bool make_maps(CUtensorMap* m1, CUtensorMap* m2, const void* f1, const void* f2, int E, int P,
               int H2, int W2, int Cpad, int f1_rows) {
  return make_map(m1, f1, E, P, Cpad, f1_rows) && make_map(m2, f2, E, H2 * W2, Cpad, kN);
}

constexpr int kTooWide = -2;  // returned when a tile's blocks do not fit on the card at once

template <bool kVec, bool kWide, bool kWhole>
int launch_k1(const CUtensorMap& m1, const CUtensorMap& m2, const float* coords,
              __nv_bfloat16* out, int E, int P, int H2, int W2, int nkb, cudaStream_t stream) {
  const auto kernel = corr_fused_xy_kernel<kVec, kWide, kWhole>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((P + kM - 1) / kM, E);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(m1, m2, coords, out, P, H2, W2, nkb);
  return static_cast<int>(cudaGetLastError());
}

// K1-int8: E * P / 64 blocks in one dimension, taken by ticket; refused
// unless the card holds a tile's tile / 64 blocks at once (asked once),
// which the exchange needs to run to the end.
template <bool kVec>
int launch_int8(const CUtensorMap& m1, const CUtensorMap& m2, const float* coords,
                __nv_bfloat16* out, float* vmax, uint32_t* sync, int E, int P, int H2, int W2,
                int nkb, int tile, cudaStream_t stream) {
  static int resident = -1;
  const auto kernel = corr_int8_kernel<kVec>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (resident < 0) {
    int per_sm = 0, dev = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, kSmemBytes);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident = per_sm * sms;
  }
  if (tile <= 0 || tile % kM != 0 || P % tile != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (tile / kM > resident) return kTooWide;
  kernel<<<E * (P / kM), kThreads, kSmemBytes, stream>>>(m1, m2, coords, out, vmax, sync, P, H2,
                                                          W2, nkb, tile);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec>
int launch_raw(const CUtensorMap& m1, const CUtensorMap& m2, const float* coords,
               __nv_bfloat16* out, int E, int P, int H2, int W2, int nkb, cudaStream_t stream) {
  const auto kernel = corr_fused_xy_raw_kernel<kVec>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kRawSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((P + kRawM - 1) / kRawM, E);
  kernel<<<grid, kRawThreads, kRawSmemBytes, stream>>>(m1, m2, coords, out, P, H2, W2, nkb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f1 (E, P, Cpad) and f2 (E, H2*W2, Cpad) bf16, 16-byte aligned, Cpad in
// {64, 128}; W2 <= 256 (above 128 the wide path).  whole != 0: each level
// pools whole 2^l blocks only (DROID-SLAM's pyramid).  Launch on `stream`;
// returns cudaGetLastError() of the launch (0 = ok), -1 if a tensor map
// could not be encoded.
extern "C" int corr_fused_xy_launch(const void* f1, const void* f2, const void* coords, void* out,
                                    int E, int P, int H2, int W2, int Cpad, int whole,
                                    void* stream) {
  if (E == 0 || P == 0) return 0;
  CUtensorMap m1, m2;
  if (!make_maps(&m1, &m2, f1, f2, E, P, H2, W2, Cpad, kM)) return -1;
  const int nkb = Cpad / kBoxC;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(coords);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (W2 > 2 * kN) return static_cast<int>(cudaErrorInvalidValue);
  if (W2 > kN)
    return whole ? launch_k1<false, true, true>(m1, m2, c, o, E, P, H2, W2, nkb, s)
                 : launch_k1<false, true, false>(m1, m2, c, o, E, P, H2, W2, nkb, s);
  if (W2 % 8 == 0)
    return whole ? launch_k1<true, false, true>(m1, m2, c, o, E, P, H2, W2, nkb, s)
                 : launch_k1<true, false, false>(m1, m2, c, o, E, P, H2, W2, nkb, s);
  return whole ? launch_k1<false, false, true>(m1, m2, c, o, E, P, H2, W2, nkb, s)
               : launch_k1<false, false, false>(m1, m2, c, o, E, P, H2, W2, nkb, s);
}

// K1-int8 in one launch: as corr_fused_xy_launch, and vmax (E, P / tile)
// f32 gets each tile's scale, max(max |vol|, 1e-20); tile a multiple of 64
// that divides P.  `sync` (4 + 2 * E * P / 64 words, zeroed once) is kept
// by the caller between launches on one stream; -2 if a tile's blocks do
// not fit on the card at once.
extern "C" int corr_fused_xy_int8_launch(const void* f1, const void* f2, const void* coords,
                                         void* vmax, void* out, void* sync, int E, int P, int H2,
                                         int W2, int Cpad, int tile, void* stream) {
  if (E == 0 || P == 0) return 0;
  if (W2 > kN) return static_cast<int>(cudaErrorInvalidValue);  // whole rows in a chunk
  CUtensorMap m1, m2;
  if (!make_maps(&m1, &m2, f1, f2, E, P, H2, W2, Cpad, kM)) return -1;
  const int nkb = Cpad / kBoxC;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(coords);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  float* v = static_cast<float*>(vmax);
  uint32_t* y = static_cast<uint32_t*>(sync);
  if (W2 % 8 == 0) return launch_int8<true>(m1, m2, c, o, v, y, E, P, H2, W2, nkb, tile, s);
  return launch_int8<false>(m1, m2, c, o, v, y, E, P, H2, W2, nkb, tile, s);
}

// K1-raw: as corr_fused_xy_launch, out (E, P, 1024) bf16 (16-byte aligned).
extern "C" int corr_fused_xy_raw_launch(const void* f1, const void* f2, const void* coords,
                                        void* out, int E, int P, int H2, int W2, int Cpad,
                                        void* stream) {
  if (E == 0 || P == 0) return 0;
  if (W2 > kN) return static_cast<int>(cudaErrorInvalidValue);  // whole rows in a chunk
  CUtensorMap m1, m2;
  if (!make_maps(&m1, &m2, f1, f2, E, P, H2, W2, Cpad, kRawM)) return -1;
  const int nkb = Cpad / kBoxC;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(coords);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (W2 % 8 == 0) return launch_raw<true>(m1, m2, c, o, E, P, H2, W2, nkb, s);
  return launch_raw<false>(m1, m2, c, o, E, P, H2, W2, nkb, s);
}
