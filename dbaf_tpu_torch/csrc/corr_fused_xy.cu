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
// the tensor cores (116 GFLOP per round at E=48, P=P2=3072, C=128).  Design:
// one block per (16 source pixels, edge).  Its eight warps build the
// 16 x P2 correlation tile with bf16 wmma (16x16x16, f32 accumulation) into
// shared memory as bf16, so the volume never touches device memory.  Then
// every thread owns one (pixel, channel) output and visits only its tent's
// support: 2*2^l columns and 2*2^l rows at level l.  No TMA or wgmma yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int kTile = 16;      // source pixels per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRadius = 3;
constexpr int kTaps = 2 * kRadius + 1;       // 7
constexpr int kLevels = 4;
constexpr int kChannels = kLevels * kTaps * kTaps;  // 196

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// tent weight of the fused kernel's tables: max(0, 1 - |(floor(i*inv) - off) - cm|) * inv
__device__ __forceinline__ float tent(int i, float inv, float off, float cm) {
  float g = floorf(static_cast<float>(i) * inv) - off;
  return fmaxf(0.f, 1.f - fabsf(g - cm)) * inv;
}

// support [lo, hi) of the taps of one offset: floor(i / s) in {k0, k0 + 1}
__device__ __forceinline__ void support(float cm, float off, int s, int size, int* lo, int* hi) {
  float k0 = floorf(cm) + off;
  float flo = fmaxf(k0 * s, 0.f);
  float fhi = fminf((k0 + 2.f) * s, static_cast<float>(size));
  if (!(flo < fhi)) {  // empty, or a non-finite coordinate
    *lo = 0;
    *hi = 0;
    return;
  }
  *lo = static_cast<int>(flo);
  *hi = static_cast<int>(fhi);
}

__global__ void __launch_bounds__(kThreads)
corr_fused_xy_kernel(const __nv_bfloat16* __restrict__ f1,  // (E, P1pad, C)
                     const __nv_bfloat16* __restrict__ f2,  // (E, P2pad, C)
                     const float* __restrict__ coords,      // (E, P, 2)
                     __nv_bfloat16* __restrict__ out,       // (E, P, 196)
                     int P, int P1pad, int P2pad, int H2, int W2, int C) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* vol = reinterpret_cast<__nv_bfloat16*>(smem);               // [kTile][P2pad]
  float* stage = reinterpret_cast<float*>(smem + sizeof(__nv_bfloat16) * kTile * P2pad);

  const int e = blockIdx.y;
  const int p0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // ---- phase 1: the 16 x P2 correlation tile, bf16 wmma, f32 sums
  const __nv_bfloat16* a_base = f1 + (static_cast<size_t>(e) * P1pad + p0) * C;
  const __nv_bfloat16* b_base = f2 + static_cast<size_t>(e) * P2pad * C;
  float* my_stage = stage + warp * 256;
  for (int nt = warp; nt < P2pad / 16; nt += kWarps) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    const __nv_bfloat16* b_tile = b_base + static_cast<size_t>(nt) * 16 * C;
    for (int k = 0; k < C; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, a_base + k, C);
      wmma::load_matrix_sync(fb, b_tile + k, C);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(my_stage, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 256; i += 32) {
      int m = i / 16, n = i % 16;
      vol[m * P2pad + nt * 16 + n] = __float2bfloat16(my_stage[i]);
    }
    __syncwarp();
  }
  __syncthreads();

  // ---- phase 2: one (pixel, channel) output per thread, tent support only
  for (int item = threadIdx.x; item < kTile * kChannels; item += kThreads) {
    const int pl = item / kChannels;
    const int c = item % kChannels;
    const int p = p0 + pl;
    if (p >= P) continue;
    const int l = c / (kTaps * kTaps);
    const int a = (c / kTaps) % kTaps;  // x tap
    const int b = c % kTaps;            // y tap
    const int s = 1 << l;
    const float inv = 1.f / static_cast<float>(s);
    const float2 xy = reinterpret_cast<const float2*>(coords)[static_cast<size_t>(e) * P + p];
    const float xm = xy.x * inv;
    const float ym = xy.y * inv;
    const float offa = static_cast<float>(a - kRadius);
    const float offb = static_cast<float>(b - kRadius);
    int wlo, whi, hlo, hhi;
    support(xm, offa, s, W2, &wlo, &whi);
    support(ym, offb, s, H2, &hlo, &hhi);
    const __nv_bfloat16* row = vol + pl * P2pad;
    float acc = 0.f;
    for (int h = hlo; h < hhi; ++h) {
      float p2 = 0.f;
      for (int w = wlo; w < whi; ++w) {
        p2 += __bfloat162float(row[h * W2 + w]) * round_bf16(tent(w, inv, offa, xm));
      }
      acc += round_bf16(tent(h, inv, offb, ym)) * round_bf16(p2);
    }
    out[(static_cast<size_t>(e) * P + p) * kChannels + c] = __float2bfloat16(acc);
  }
}

int smem_bytes(int P2pad) {
  return static_cast<int>(sizeof(__nv_bfloat16) * kTile * P2pad + sizeof(float) * kWarps * 256);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() of the launch (0 = ok).
extern "C" int corr_fused_xy_launch(const void* f1, const void* f2, const void* coords, void* out,
                                    int E, int P, int P1pad, int P2pad, int H2, int W2, int C,
                                    void* stream) {
  if (E == 0 || P == 0) return 0;
  const int smem = smem_bytes(P2pad);
  cudaError_t err = cudaFuncSetAttribute(corr_fused_xy_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((P + kTile - 1) / kTile, E);
  corr_fused_xy_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(f1), static_cast<const __nv_bfloat16*>(f2),
      static_cast<const float*>(coords), static_cast<__nv_bfloat16*>(out), P, P1pad, P2pad, H2, W2, C);
  return static_cast<int>(cudaGetLastError());
}
