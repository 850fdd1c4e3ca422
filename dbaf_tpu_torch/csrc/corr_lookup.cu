// K2: 4-level windowed lookup on a prebuilt correlation volume, y first.
//
// Replaces the Pallas kernel _lookup_kernel (dbaf_tpu/ops/corr_pallas.py:58,
// driven by lookup_pallas at :85, tents from _tri_kernels at :37).  For each
// edge e, source pixel p and output channel (l, a, b):
//   tmp[w]     = T( sum_h T(ky_{l,b}(h)) * vol[p, h, w] )
//   out[l,a,b] = sum_w T(kx_{l,a}(w)) * tmp[w]
// with T the volume's type (bf16 or f32), f32 sums, and the level-l tent
// tri(floor(i / 2^l) - (c / 2^l + off)) / 2^l.  Output (E, 196, H, W) f32,
// channel l*49 + a*7 + b (a = x tap), the reference order.  At a ragged
// grid the tent pools a level's partial block at the end, as the Pallas
// kernel does; with `whole` a level pools the whole 2^l blocks only, cells
// [0, (size >> l) << l) of each axis, and reads zero past them, as
// DROID-SLAM's avg_pool2d pyramid does.
//
// Bound on the H100: memory.  Each volume row is read once (18.9 MB in bf16
// for E=1 at 48x64), against about 10k multiply-adds per pixel.
//
// Design.  Persistent blocks of 4 warps, as many as fit on the SMs; every
// warp walks its own list of pixels.  Where four warps' buffers do not fit
// in a block's shared memory (a bf16 volume above P2 = 13.8k, f32 above 6.7k),
// blocks have 2 or 1 warps, so K2 takes any P2 whose two rows fit one block
// (57k bf16, 28k f32 on the H100's 227 KB).  A pixel's volume row comes into a
// warp-private double buffer with 16-byte cp.async, issued one pixel ahead,
// so the next row streams in while this one is looked up.  Per pixel the
// lanes first tabulate both axes' tents (each tap touches two blocks of 2^l
// cells: two weights and a support), then run the lookup separably:
//   stage 1: tmp[l, b, w] for every tap b and every column w of level l's
//            union x-support, each a sum over the tap's 2*2^l rows, shared by
//            all 7 x-taps.  A lane takes a column and walks the union's rows
//            once, feeding the 7 tap sums in registers (each row belongs to
//            two taps), so each volume value is read once per level;
//   stage 2: the 196 outputs, each a sum over its x-tap's 2*2^l columns.
// Stage-1 columns are dealt to lanes so that every lane reads about the same
// number of rows (consecutive lanes, consecutive columns); lanes stride over
// the outputs in stage 2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;      // most warps per block
constexpr int kRadius = 3;
constexpr int kTaps = 2 * kRadius + 1;
constexpr int kLevels = 4;
constexpr int kEntries = kLevels * kTaps;            // 28 taps per axis
constexpr int kChannels = kLevels * kTaps * kTaps;   // 196
constexpr int kTmp = kTaps * 8 * (1 + 2 + 4 + 8);    // 840: 7 taps x 8*2^l columns per level
constexpr int kItems = 8 * (8 + 4 + 2 + 1);           // 120 union columns over the levels

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__device__ __forceinline__ float round_t(float v) { return to_f32(from_f32<T>(v)); }

// One tap of one axis: support [lo, hi), cells below mid weigh w0, the rest w1.
struct Tap {
  int lo, mid, hi;
  float w0, w1;
};

// Per-warp shared memory: two volume rows, the stage-1 sums, the tent tables.
template <typename T>
struct WarpSmem {
  __host__ __device__ static size_t row_bytes(int P2) {
    return (static_cast<size_t>(P2) * sizeof(T) + 15) / 16 * 16;
  }
  __host__ __device__ static size_t tmp_bytes() { return (kTmp * sizeof(T) + 15) / 16 * 16; }
  __host__ __device__ static size_t tab_bytes() {
    return (2 * kEntries * sizeof(Tap) + 2 * kLevels * 4 + 15) / 16 * 16;
  }
  __host__ __device__ static size_t bytes(int P2) {
    return 2 * row_bytes(P2) + tmp_bytes() + tab_bytes();
  }
};

// size: the level's pooled cells on the axis (the axis's, or its whole
// 2^l blocks').
template <typename T>
__device__ __forceinline__ Tap make_tap(float c, int l, int t, int size) {
  const int s = 1 << l;
  const float inv = 1.f / static_cast<float>(s);
  const float cm = c * inv;
  const float off = static_cast<float>(t - kRadius);
  const float taps = cm + off;
  const float g0 = floorf(cm) + off;
  // reference tent: tri(floor(i / s) - taps) / s, on blocks g0 and g0 + 1
  Tap tp;
  tp.w0 = round_t<T>(fmaxf(0.f, 1.f - fabsf(g0 - taps)) * inv);
  tp.w1 = round_t<T>(fmaxf(0.f, 1.f - fabsf((g0 + 1.f) - taps)) * inv);
  const float flo = fmaxf(g0 * s, 0.f);
  const float fhi = fminf((g0 + 2.f) * s, static_cast<float>(size));
  if (flo < fhi) {  // false when empty or non-finite
    tp.lo = static_cast<int>(flo);
    tp.hi = static_cast<int>(fhi);
    tp.mid = static_cast<int>(fminf(fmaxf((g0 + 1.f) * s, flo), fhi));
  } else {
    tp.lo = tp.mid = tp.hi = 0;
  }
  return tp;
}

// First cell of level l's union of tap supports, (floor(c / 2^l) - 3) * 2^l;
// far below any index when the union misses [0, size) or c is not finite.
__device__ __forceinline__ int union_start(float c, int l, int size) {
  const float s = static_cast<float>(1 << l);
  const float k0 = floorf(c / s);
  const bool meets = (k0 + 5.f) * s > 0.f && (k0 - 3.f) * s < static_cast<float>(size);
  return meets ? static_cast<int>((k0 - 3.f) * s) : -(1 << 24);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// Brings pixel q's volume row into buf: 16-byte cp.async when kAsync, else
// element loads.
template <typename T, bool kAsync>
__device__ __forceinline__ void fetch_row(T* buf, const T* __restrict__ volume, long long q,
                                          int P2, int lane) {
  const T* src = volume + q * P2;
  if (kAsync) {
    const int nv = P2 * static_cast<int>(sizeof(T)) / 16;
    for (int i = lane; i < nv; i += 32)
      cp_async16(reinterpret_cast<uint4*>(buf) + i, reinterpret_cast<const uint4*>(src) + i);
  } else {
    for (int i = lane; i < P2; i += 32) buf[i] = src[i];
  }
}

template <typename T, bool kAsync>
__global__ void __launch_bounds__(kWarps * 32)
corr_lookup_kernel(const T* __restrict__ volume,     // (E, P, H2, W2)
                   const float* __restrict__ coords,  // (E, P, 2)
                   float* __restrict__ out,           // (E, 196, P)
                   int E, int P, int H2, int W2, int whole) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int P2 = H2 * W2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned char* mine = smem + warp * WarpSmem<T>::bytes(P2);
  T* bufs[2] = {reinterpret_cast<T*>(mine),
                reinterpret_cast<T*>(mine + WarpSmem<T>::row_bytes(P2))};
  T* tmp = reinterpret_cast<T*>(mine + 2 * WarpSmem<T>::row_bytes(P2));
  Tap* tab = reinterpret_cast<Tap*>(mine + 2 * WarpSmem<T>::row_bytes(P2) +
                                    WarpSmem<T>::tmp_bytes());  // [x: 28][y: 28]
  int* ustart = reinterpret_cast<int*>(tab + 2 * kEntries);  // union start per level: [x: 4][y: 4]

  const int nwarps = blockDim.x / 32;
  const long long npix = static_cast<long long>(E) * P;
  const long long stride = static_cast<long long>(gridDim.x) * nwarps;
  long long q = static_cast<long long>(blockIdx.x) * nwarps + warp;
  if (q >= npix) return;

  int cur = 0;
  fetch_row<T, kAsync>(bufs[0], volume, q, P2, lane);
  if (kAsync) cp_async_commit();
  for (; q < npix; q += stride) {
    const long long qn = q + stride;
    if (qn < npix) fetch_row<T, kAsync>(bufs[cur ^ 1], volume, qn, P2, lane);
    if (kAsync) {
      cp_async_commit();
      cp_async_wait1();  // this pixel's row has landed; the next one may still fly
    }

    // ---- tent tables of this pixel
    const float2 xy = reinterpret_cast<const float2*>(coords)[q];
    if (lane < kEntries) {
      const int l = lane / kTaps, t = lane % kTaps;
      tab[lane] = make_tap<T>(xy.x, l, t, whole ? (W2 >> l) << l : W2);
      tab[kEntries + lane] = make_tap<T>(xy.y, l, t, whole ? (H2 >> l) << l : H2);
    } else if (lane < kEntries + kLevels) {
      const int l = lane - kEntries;
      ustart[l] = union_start(xy.x, l, W2);
      ustart[kLevels + l] = union_start(xy.y, l, H2);
    }
    __syncwarp();

    // ---- stage 1: tmp[l][b][w - ustart], y contracted over each tap's rows.
    // Items are (level, column of the union): lane i takes level-3 columns i
    // and 32 + i, level-2 column i, and level-1 column i (i < 16) or level-0
    // column i - 16 (16 <= i < 24).  One pass down the union's 8 row blocks
    // feeds all 7 taps: block j is tap j's first block and tap j-1's second.
    const T* row = bufs[cur];
    for (int it = lane; it < kItems; it += 32) {
      const int l = it < 64 ? 3 : it < 96 ? 2 : it < 112 ? 1 : 0;
      const int wr = it < 64 ? it : it < 96 ? it - 64 : it < 112 ? it - 96 : it - 112;
      const int s = 1 << l;
      const int w = ustart[l] + wr;
      if (w < 0 || w >= W2) continue;
      const Tap* ty = tab + kEntries + l * kTaps;
      float w0[kTaps], w1[kTaps], acc[kTaps];
#pragma unroll
      for (int b = 0; b < kTaps; ++b) {
        w0[b] = ty[b].w0;
        w1[b] = ty[b].w1;
        acc[b] = 0.f;
      }
      const int v0 = ustart[kLevels + l];
      const int hl = whole ? (H2 >> l) << l : H2;  // the level's pooled rows
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int hlo = max(v0 + j * s, 0), hhi = min(v0 + (j + 1) * s, hl);
        for (int h = hlo; h < hhi; ++h) {
          const float v = to_f32(row[h * W2 + w]);
          if (j < kTaps) acc[j] += w0[j] * v;
          if (j >= 1) acc[j - 1] += w1[j - 1] * v;
        }
      }
      T* trow = tmp + kTaps * 8 * (s - 1) + wr;
#pragma unroll
      for (int b = 0; b < kTaps; ++b) trow[b * 8 * s] = from_f32<T>(acc[b]);
    }
    __syncwarp();

    // ---- stage 2: the 196 outputs, x contracted over each tap's columns
    const long long e = q / P, p = q - e * P;
    for (int c = lane; c < kChannels; c += 32) {
      const int l = c / (kTaps * kTaps);
      const int a = (c / kTaps) % kTaps;
      const int b = c % kTaps;
      const Tap tx = tab[l * kTaps + a];
      const int width = 8 << l;
      const T* trow = tmp + kTaps * 8 * ((1 << l) - 1) + b * width - ustart[l];
      float acc = 0.f;
      for (int w = tx.lo; w < tx.hi; ++w) acc += (w < tx.mid ? tx.w0 : tx.w1) * to_f32(trow[w]);
      out[(e * kChannels + c) * P + p] = acc;
    }
    __syncwarp();  // buffer `cur` and the tables are free for the next pixel
    cur ^= 1;
  }
}

template <typename T>
int launch(const void* volume, const void* coords, void* out, int E, int P, int H2, int W2,
           int whole, cudaStream_t stream) {
  const int P2 = H2 * W2;
  const bool async = reinterpret_cast<uintptr_t>(volume) % 16 == 0 &&
                     (static_cast<size_t>(P2) * sizeof(T)) % 16 == 0;
  auto kernel = async ? corr_lookup_kernel<T, true> : corr_lookup_kernel<T, false>;
  int dev = 0, sms = 0, per_sm = 0, max_smem = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return static_cast<int>(err);
  // as many warps a block (4, 2, 1) as the shared memory holds
  int warps = kWarps;
  while (warps > 1 && warps * WarpSmem<T>::bytes(P2) > static_cast<size_t>(max_smem)) warps /= 2;
  const size_t smem = warps * WarpSmem<T>::bytes(P2);
  if (smem > static_cast<size_t>(max_smem)) return static_cast<int>(cudaErrorInvalidValue);
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem))) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, warps * 32, smem)) !=
      cudaSuccess)
    return static_cast<int>(err);
  const long long need = (static_cast<long long>(E) * P + warps - 1) / warps;
  const int grid = static_cast<int>(need < static_cast<long long>(per_sm) * sms
                                        ? need : static_cast<long long>(per_sm) * sms);
  kernel<<<grid > 0 ? grid : 1, warps * 32, smem, stream>>>(
      static_cast<const T*>(volume), static_cast<const float*>(coords), static_cast<float*>(out),
      E, P, H2, W2, whole);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// whole != 0: each level pools whole 2^l blocks only.  Launch on `stream`;
// returns cudaGetLastError() of the launch (0 = ok).
extern "C" int corr_lookup_launch(const void* volume, const void* coords, void* out, int E, int P,
                                  int H2, int W2, int is_bf16, int whole, void* stream) {
  if (E == 0 || P == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(volume, coords, out, E, P, H2, W2, whole, s);
  return launch<float>(volume, coords, out, E, P, H2, W2, whole, s);
}
