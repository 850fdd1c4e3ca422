// K2: 4-level windowed lookup on a prebuilt correlation volume, y first.
//
// Replaces the Pallas kernel _lookup_kernel (dbaf_tpu/ops/corr_pallas.py:58,
// driven by lookup_pallas at :85, tents from _tri_kernels at :37).  For each
// edge e, source pixel p and output channel (l, a, b):
//   tmp[w]     = T( sum_h T(ky_{l,b}(h)) * vol[p, h, w] )
//   out[l,a,b] = sum_w T(kx_{l,a}(w)) * tmp[w]
// with T the volume's type (bf16 or f32), f32 sums, and the level-l tent
// tri(floor(i / 2^l) - (c / 2^l + off)) / 2^l.  Output (E, 196, H, W) f32,
// channel l*49 + a*7 + b (a = x tap), the reference order.
//
// Bound on the H100: memory.  Each volume row is read once (18.9 MB in bf16
// for E=1 at 48x64), against a few hundred flops per output.  Design: one
// block per (4 source pixels, edge) copies the pixels' volume rows into
// shared memory with coalesced loads, then every thread owns one
// (pixel, channel) output and visits only its tent's support, 2*2^l rows
// and columns at level l.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kPix = 4;        // source pixels per block
constexpr int kThreads = 256;
constexpr int kRadius = 3;
constexpr int kTaps = 2 * kRadius + 1;
constexpr int kLevels = 4;
constexpr int kChannels = kLevels * kTaps * kTaps;  // 196

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ float round_t(float v);
template <>
__device__ __forceinline__ float round_t<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_t<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// tent of _tri_kernels: max(0, 1 - |floor(i / s) - (c / s + off)|) / s
__device__ __forceinline__ float tent(int i, float inv, float taps) {
  float g = floorf(static_cast<float>(i) * inv);
  return fmaxf(0.f, 1.f - fabsf(g - taps)) * inv;
}

__device__ __forceinline__ void support(float cm, float off, int s, int size, int* lo, int* hi) {
  float k0 = floorf(cm) + off;
  float flo = fmaxf(k0 * s, 0.f);
  float fhi = fminf((k0 + 2.f) * s, static_cast<float>(size));
  if (!(flo < fhi)) {
    *lo = 0;
    *hi = 0;
    return;
  }
  *lo = static_cast<int>(flo);
  *hi = static_cast<int>(fhi);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
corr_lookup_kernel(const T* __restrict__ volume,     // (E, P, H2, W2)
                   const float* __restrict__ coords,  // (E, P, 2)
                   float* __restrict__ out,           // (E, 196, P)
                   int P, int H2, int W2) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* rows = reinterpret_cast<T*>(smem);  // [kPix][H2*W2]

  const int e = blockIdx.y;
  const int p0 = blockIdx.x * kPix;
  const int P2 = H2 * W2;
  const int npix = min(kPix, P - p0);

  const T* src = volume + (static_cast<size_t>(e) * P + p0) * P2;
  for (int i = threadIdx.x; i < npix * P2; i += kThreads) rows[i] = src[i];
  __syncthreads();

  for (int item = threadIdx.x; item < kPix * kChannels; item += kThreads) {
    const int c = item / kPix;   // consecutive threads: consecutive pixels
    const int pl = item % kPix;
    if (pl >= npix) continue;
    const int p = p0 + pl;
    const int l = c / (kTaps * kTaps);
    const int a = (c / kTaps) % kTaps;  // x tap
    const int b = c % kTaps;            // y tap
    const int s = 1 << l;
    const float inv = 1.f / static_cast<float>(s);
    const float2 xy = reinterpret_cast<const float2*>(coords)[static_cast<size_t>(e) * P + p];
    const float offa = static_cast<float>(a - kRadius);
    const float offb = static_cast<float>(b - kRadius);
    const float xm = xy.x * inv;
    const float ym = xy.y * inv;
    const float tx = xm + offa;
    const float ty = ym + offb;
    int wlo, whi, hlo, hhi;
    support(xm, offa, s, W2, &wlo, &whi);
    support(ym, offb, s, H2, &hlo, &hhi);
    const T* row = rows + pl * P2;
    float acc = 0.f;
    for (int w = wlo; w < whi; ++w) {
      float tmp = 0.f;
      for (int h = hlo; h < hhi; ++h) {
        tmp += round_t<T>(tent(h, inv, ty)) * to_f32(row[h * W2 + w]);
      }
      acc += round_t<T>(tent(w, inv, tx)) * round_t<T>(tmp);
    }
    out[(static_cast<size_t>(e) * kChannels + c) * P + p] = acc;
  }
}

template <typename T>
int launch(const void* volume, const void* coords, void* out, int E, int P, int H2, int W2,
           cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(T) * kPix * H2 * W2);
  cudaError_t err = cudaFuncSetAttribute(corr_lookup_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((P + kPix - 1) / kPix, E);
  corr_lookup_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(volume), static_cast<const float*>(coords), static_cast<float*>(out),
      P, H2, W2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() of the launch (0 = ok).
extern "C" int corr_lookup_launch(const void* volume, const void* coords, void* out, int E, int P,
                                  int H2, int W2, int is_bf16, void* stream) {
  if (E == 0 || P == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(volume, coords, out, E, P, H2, W2, s);
  return launch<float>(volume, coords, out, E, P, H2, W2, s);
}
