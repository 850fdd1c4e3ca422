// fg_linearize: the factor graph's dense normal equations (H, b, err) over
// the padded window, in one launch, and a one-thread launch that sums the
// error in frame order.
//
// Replaces no Pallas kernel: the JAX package leaves `linearize`
// (dbaf_tpu/fusion/device_graph.py) to XLA.  The port ran it as several
// hundred small PyTorch launches, 1.244 of the 1.601 ms of card time of one
// LM iteration at a 20-frame window on the H100, and the card's LM is what
// the multi-sensor cells' frames wait for (PERF.md section 7, item 3).
//
// It computes the contract of `linearize_plain`
// (dbaf_tpu_torch/fusion/device_graph.py), in f32, for every term: the IMU
// chain (CombinedImuFactor's residual, its 15x30 Jacobian, J^T L J), the pose
// and bias priors, the Cauchy-robust GNSS term, the odometry term, the dense
// marginal prior (its H and v, and the H @ dvec product), the visual reduced
// camera system at the pose rows (its 6x6 blocks placed by index at rows
// 15f..15f+6, as the plain version places them), and with `hold_empty` a
// unit diagonal wherever the diagonal is zero.
//
// Bound: latency.  At NW = 20 (N = 300) it reads the marginal's H (360 KB),
// the visual system (58 KB) and about 25 KB of factors and writes H
// (360 KB): 0.8 MB, 0.25 us at 3.35 TB/s, and about 1e6 flops.  What is
// left is two launches and, in each block, the serial chain of one IMU
// factor's residual and Jacobian.
//
// Design: one block per 15-row frame band f, and no atomics.  A block builds
// whatever touches its rows: IMU factors f-1 and f (each factor is computed
// by both bands it spans, which is cheap), the priors, GNSS and odometry of
// frame f, the band's rows of the marginal and of the visual system, and the
// displacement of every frame from the marginal's and the visual system's
// linearization points (for the H @ dvec rows).  Then each thread writes its
// elements of rows [15f, 15f + 15) of H: every element of H is written by
// exactly one thread, with its terms added in the plain version's order.
// Fifteen threads write the band's b, one its share of the error into a
// scratch slot, and the second launch sums the slots in frame order.  So two
// runs on the same inputs give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFrameThreads = kThreads - 5 * 32;  // warps 5.. take the frames' displacements
constexpr int kMaxFrames = 256;  // 21 floats a frame of dynamic shared memory
constexpr int kMaxPriors = 64;

// The operands, in the order of the wrapper's list
// (device_graph.KERNEL_OPERANDS): the state, the PackedGraph fields, the
// visual system, the marginal (null where there is none), the outputs.
// Masks are torch.bool (a byte each), prior frames int64.
struct FgLinearizeArgs {
  const float* R;
  const float* t;
  const float* vel;
  const float* bias;
  const uint8_t* valid;
  const uint8_t* imu_mask;
  const float* imu_dR;
  const float* imu_dv;
  const float* imu_dp;
  const float* imu_dt;
  const float* imu_dRg;
  const float* imu_dvg;
  const float* imu_dva;
  const float* imu_dpg;
  const float* imu_dpa;
  const float* imu_bias0;
  const float* imu_info;
  const float* g_vec;
  const uint8_t* pp_mask;
  const int64_t* pp_frame;
  const float* pp_R;
  const float* pp_t;
  const float* pp_info;
  const uint8_t* pb_mask;
  const int64_t* pb_frame;
  const float* pb_prior;
  const float* pb_info;
  const uint8_t* gnss_mask;
  const float* gnss_pos;
  const float* gnss_info;
  const float* gnss_k2;
  const uint8_t* odo_mask;
  const float* odo_vel;
  const float* odo_info;
  const float* vis_H;
  const float* vis_v;
  const float* vis_linR;
  const float* vis_lint;
  const uint8_t* mgd_mask;
  const float* mgd_lin;
  const float* mgd_H;
  const float* mgd_v;
  float* H;
  float* b;
  float* err;
  float* partial;
};
constexpr int kNumOperands = sizeof(FgLinearizeArgs) / sizeof(void*);
static_assert(sizeof(FgLinearizeArgs) == kNumOperands * sizeof(void*), "pointers only");

constexpr int kBadOperands = -3;  // the wrapper's list and this struct disagree
constexpr int kBadShape = -4;     // a window or prior count the kernel does not take

// ---------------------------------------------------------------------------
// small dense algebra on one thread (row-major)
// ---------------------------------------------------------------------------

// C (M x N) = A (M x K) B (K x N); At: A is given as its transpose (K x M)
template <int M, int K, int N, bool At = false>
__device__ __forceinline__ void mm(const float* A, const float* B, float* C) {
#pragma unroll
  for (int r = 0; r < M; ++r)
#pragma unroll
    for (int c = 0; c < N; ++c) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) s += (At ? A[k * M + r] : A[r * K + k]) * B[k * N + c];
      C[r * N + c] = s;
    }
}

template <int M, int K, bool At = false>
__device__ __forceinline__ void mv(const float* A, const float* x, float* y) {
  mm<M, K, 1, At>(A, x, y);
}

__device__ __forceinline__ void transpose3(const float* A, float* T) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) T[r * 3 + c] = A[c * 3 + r];
}

__device__ __forceinline__ void hat(const float* w, float* W) {
  W[0] = 0.f;   W[1] = -w[2]; W[2] = w[1];
  W[3] = w[2];  W[4] = 0.f;   W[5] = -w[0];
  W[6] = -w[1]; W[7] = w[0];  W[8] = 0.f;
}

// I + a W + c W W with W = hat(w): the shape of every SO(3) series below
__device__ __forceinline__ void so3_series(const float* w, float a, float c, float* out) {
  float W[9], WW[9];
  hat(w, W);
  mm<3, 3, 3>(W, W, WW);
#pragma unroll
  for (int q = 0; q < 9; ++q) out[q] = ((q % 4 == 0) ? 1.f : 0.f) + a * W[q] + c * WW[q];
}

__device__ __forceinline__ void theta(const float* w, float& th2, float& th) {
  th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  th = sqrtf(th2 + 1e-30f);
}

__device__ void so3_exp(const float* w, float* R) {
  float th2, th;
  theta(w, th2, th);
  const bool small = th < 1e-4f;
  const float A = small ? 1.f - th2 / 6.f : sinf(th) / th;
  const float B = small ? 0.5f - th2 / 24.f : (1.f - cosf(th)) / th2;
  so3_series(w, A, B, R);
}

__device__ void so3_log(const float* R, float* w) {
  float tr = (R[0] + R[4] + R[8] - 1.f) / 2.f;
  tr = tr < -1.f ? -1.f : (tr > 1.f ? 1.f : tr);  // NaN stays NaN, as torch.clamp
  const float th = acosf(tr);
  const bool small = th < 1e-4f;
  // residual rotations in the coupled window stay far from pi
  const float scale = small ? 0.5f + th * th / 12.f : 0.5f * th / sinf(th);
  w[0] = scale * (R[7] - R[5]);
  w[1] = scale * (R[2] - R[6]);
  w[2] = scale * (R[3] - R[1]);
}

__device__ float cot_term(const float* w) {
  float th2, th;
  theta(w, th2, th);
  if (th < 1e-4f) return static_cast<float>(1.0 / 12.0) + th2 / 720.f;
  return 1.f / th2 - (1.f + cosf(th)) / (2.f * th * sinf(th));
}

__device__ void so3_V_inv(const float* w, float* V) { so3_series(w, -0.5f, cot_term(w), V); }

__device__ void jr_inv(const float* w, float* J) { so3_series(w, 0.5f, cot_term(w), J); }

// Log(Ta^-1 Tb) -> [omega, v]
__device__ void se3_local(const float* Ra, const float* ta, const float* Rb, const float* tb,
                          float* out) {
  float M[9];
  mm<3, 3, 3, true>(Ra, Rb, M);
  so3_log(M, out);
  float d[3], u[3], V[9];
#pragma unroll
  for (int q = 0; q < 3; ++q) d[q] = tb[q] - ta[q];
  mv<3, 3, true>(Ra, d, u);
  so3_V_inv(out, V);
  mv<3, 3>(V, u, out + 3);
}

// writes a 3x3 block, times s, at (r0, c0) of a row-major matrix `ld` wide
__device__ __forceinline__ void put3(float* J, int ld, int r0, int c0, const float* B,
                                     float s = 1.f) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) J[(r0 + r) * ld + c0 + c] = s * B[r * 3 + c];
}

// CombinedImuFactor k, frames (k, k+1): the residual r (15) and the
// Jacobian J (15 x 30, zeroed by the caller) over
// [Xi(6) Vi(3) Bi(6) Xj(6) Vj(3) Bj(6)] (device_graph._imu_residual_jac)
__device__ void imu_factor(const FgLinearizeArgs& a, int k, float* J, float* r) {
  const float* Ri = a.R + 9 * k;
  const float* Rj = a.R + 9 * (k + 1);
  const float* ti = a.t + 3 * k;
  const float* tj = a.t + 3 * (k + 1);
  const float* vi = a.vel + 3 * k;
  const float* vj = a.vel + 3 * (k + 1);
  const float* bi = a.bias + 6 * k;
  const float* bj = a.bias + 6 * (k + 1);
  const float* dRg = a.imu_dRg + 9 * k;
  const float* dva = a.imu_dva + 9 * k;
  const float* dvg = a.imu_dvg + 9 * k;
  const float* dpa = a.imu_dpa + 9 * k;
  const float* dpg = a.imu_dpg + 9 * k;
  const float dt = a.imu_dt[k];
  const float* g = a.g_vec;

  float db[6];
#pragma unroll
  for (int q = 0; q < 6; ++q) db[q] = bi[q] - a.imu_bias0[6 * k + q];
  float wg[3], Eg[9], dR[9], x[3], y[3], dv[3], dp[3];
  mv<3, 3>(dRg, db + 3, wg);
  so3_exp(wg, Eg);
  mm<3, 3, 3>(a.imu_dR + 9 * k, Eg, dR);
  mv<3, 3>(dva, db, x);
  mv<3, 3>(dvg, db + 3, y);
#pragma unroll
  for (int q = 0; q < 3; ++q) dv[q] = a.imu_dv[3 * k + q] + x[q] + y[q];
  mv<3, 3>(dpa, db, x);
  mv<3, 3>(dpg, db + 3, y);
#pragma unroll
  for (int q = 0; q < 3; ++q) dp[q] = a.imu_dp[3 * k + q] + x[q] + y[q];

  float RiT[9], T[9], Erot[9], T2[9];
  transpose3(Ri, RiT);
  mm<3, 3, 3, true>(dR, RiT, T);  // dR^T Ri^T
  mm<3, 3, 3>(T, Rj, Erot);
  so3_log(Erot, r);
  float dvw[3], dpw[3], uv[3], up[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    dvw[q] = vj[q] - vi[q] - g[q] * dt;
    dpw[q] = tj[q] - ti[q] - vi[q] * dt - 0.5f * g[q] * dt * dt;
  }
  mv<3, 3>(RiT, dvw, uv);
  mv<3, 3>(RiT, dpw, up);
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    r[3 + q] = uv[q] - dv[q];
    r[6 + q] = up[q] - dp[q];
  }
#pragma unroll
  for (int q = 0; q < 6; ++q) r[9 + q] = bj[q] - bi[q];

  float Jri[9], nJri[9], Hm[9];
  jr_inv(r, Jri);
#pragma unroll
  for (int q = 0; q < 9; ++q) nJri[q] = -Jri[q];
  // Xi
  {
    float RjT[9];
    transpose3(Rj, RjT);
    mm<3, 3, 3>(nJri, RjT, T);
  }
  mm<3, 3, 3>(T, Ri, T2);
  put3(J, 30, 0, 0, T2);
  hat(uv, Hm);
  put3(J, 30, 3, 0, Hm);
  hat(up, Hm);
  put3(J, 30, 6, 0, Hm);
#pragma unroll
  for (int q = 0; q < 3; ++q) J[(6 + q) * 30 + 3 + q] = -1.f;
  // Vi
  put3(J, 30, 3, 6, RiT, -1.f);
#pragma unroll
  for (int q = 0; q < 9; ++q) T[q] = -RiT[q] * dt;
  put3(J, 30, 6, 6, T);
  // Bi
  {
    float ErT[9];
    transpose3(Erot, ErT);
    mm<3, 3, 3>(nJri, ErT, T);
  }
  mm<3, 3, 3>(T, dRg, T2);
  put3(J, 30, 0, 12, T2);
  put3(J, 30, 3, 9, dva, -1.f);
  put3(J, 30, 3, 12, dvg, -1.f);
  put3(J, 30, 6, 9, dpa, -1.f);
  put3(J, 30, 6, 12, dpg, -1.f);
#pragma unroll
  for (int q = 0; q < 6; ++q) J[(9 + q) * 30 + 9 + q] = -1.f;
  // Xj
  put3(J, 30, 0, 15, Jri);
  mm<3, 3, 3>(RiT, Rj, T);
  put3(J, 30, 6, 18, T);
  // Vj
  put3(J, 30, 3, 21, RiT);
  // Bj
#pragma unroll
  for (int q = 0; q < 6; ++q) J[(9 + q) * 30 + 24 + q] = 1.f;
}

// PriorPose p on frame f: A = J^T L J (6x6), rhs = -J^T L r, e = r.L r / 2,
// with J the block inverse right Jacobian (device_graph._prior_pose_jac)
__device__ void pose_prior(const FgLinearizeArgs& a, int p, int f, float* A, float* rhs,
                           float* e) {
  float r[6], J[36], JtL[36], Lr[6], B[9];
  se3_local(a.pp_R + 9 * p, a.pp_t + 3 * p, a.R + 9 * f, a.t + 3 * f, r);
#pragma unroll
  for (int q = 0; q < 36; ++q) J[q] = 0.f;
  jr_inv(r, B);
  put3(J, 6, 0, 0, B);
  so3_V_inv(r, B);
  put3(J, 6, 3, 3, B);
  const float* L = a.pp_info + 36 * p;
  mm<6, 6, 6, true>(J, L, JtL);
  mm<6, 6, 6>(JtL, J, A);
  mv<6, 6>(JtL, r, Lr);
#pragma unroll
  for (int q = 0; q < 6; ++q) rhs[q] = -Lr[q];
  mv<6, 6>(L, r, Lr);
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < 6; ++q) s += r[q] * Lr[q];
  *e = 0.5f * s;
}

// PriorVec p on frame f's bias: A = L (read where it is added), rhs, e
__device__ void bias_prior(const FgLinearizeArgs& a, int p, int f, float* rhs, float* e) {
  float r[6], Lr[6];
#pragma unroll
  for (int q = 0; q < 6; ++q) r[q] = a.bias[6 * f + q] - a.pb_prior[6 * p + q];
  mv<6, 6>(a.pb_info + 36 * p, r, Lr);
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    rhs[q] = -Lr[q];
    s += r[q] * Lr[q];
  }
  *e = 0.5f * s;
}

// GNSS on frame f (Cauchy robust, J = [0 | R] over the position rows)
__device__ void gnss_term(const FgLinearizeArgs& a, int f, float* A, float* rhs, float* rho) {
  const float* R = a.R + 9 * f;
  const float* info = a.gnss_info;
  float r[3], ir[3], Lam[9], JtL[9], x[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) r[q] = a.t[3 * f + q] - a.gnss_pos[3 * f + q];
  mv<3, 3>(info, r, ir);
  const float e2 = r[0] * ir[0] + r[1] * ir[1] + r[2] * ir[2];
  const float k2 = *a.gnss_k2;
  const float w = k2 / (k2 + e2);
  *rho = 0.5f * k2 * log1pf(e2 / k2);
#pragma unroll
  for (int q = 0; q < 9; ++q) Lam[q] = w * info[q];
  mm<3, 3, 3, true>(R, Lam, JtL);
  mm<3, 3, 3>(JtL, R, A);
  mv<3, 3>(JtL, r, x);
#pragma unroll
  for (int q = 0; q < 3; ++q) rhs[q] = -x[q];
}

// wheel odometry on frame f: body velocity, J = [hat(vb) | R^T] (3 x 6) over
// rows [15f, 15f+3) and [15f+6, 15f+9)
__device__ void odo_term(const FgLinearizeArgs& a, int f, float* A, float* rhs, float* e) {
  const float* R = a.R + 9 * f;
  const float* L = a.odo_info;
  float RT[9], vb[3], r[3], J[18], Hm[9], JtL[18], x[6], Lr[3];
  transpose3(R, RT);
  mv<3, 3>(RT, a.vel + 3 * f, vb);
#pragma unroll
  for (int q = 0; q < 3; ++q) r[q] = vb[q] - a.odo_vel[3 * f + q];
  hat(vb, Hm);
#pragma unroll
  for (int rr = 0; rr < 3; ++rr)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      J[rr * 6 + c] = Hm[rr * 3 + c];
      J[rr * 6 + 3 + c] = RT[rr * 3 + c];
    }
  mm<6, 3, 3, true>(J, L, JtL);
  mm<6, 3, 6>(JtL, J, A);
  mv<6, 3>(JtL, r, x);
#pragma unroll
  for (int q = 0; q < 6; ++q) rhs[q] = -x[q];
  mv<3, 3>(L, r, Lr);
  *e = 0.5f * (r[0] * Lr[0] + r[1] * Lr[1] + r[2] * Lr[2]);
}

// the odometry term's slot of band row q: 0-2 (pose w), 3-5 (vel), else -1
__device__ __forceinline__ int odo_slot(int q) {
  return q < 3 ? q : (q >= 6 && q < 9 ? q - 3 : -1);
}

__device__ __forceinline__ bool prior_on(const uint8_t* mask, const int64_t* frame, int p,
                                         int f) {
  return mask[p] && frame[p] == f;
}

__global__ void __launch_bounds__(kThreads)
    fg_linearize_kernel(const FgLinearizeArgs a, int NW, int PP, int PB, int has_mgd,
                        int hold_empty) {
  __shared__ float sJ[2][15 * 30];   // [0] factor f-1, [1] factor f
  __shared__ float sr[2][15];
  __shared__ float sJtL[2][15 * 15];  // the band's rows of J^T L
  __shared__ float sA[2][15 * 30];    // the band's rows of J^T L J
  __shared__ float srhs[2][15];
  __shared__ float sLr[15];           // L r of factor f
  __shared__ float sE;                // factor f's error
  __shared__ float sGA[9], sGrhs[3], sGrho;
  __shared__ float sOA[36], sOrhs[6], sOe;
  __shared__ float sHd[15], sHv[6];   // the band's rows of mgd.H @ dvec and vis_H @ dp6
  extern __shared__ float dyn[];
  float* dvec = dyn;                   // 15 NW: deviation from the marginal's lin points
  float* dp6 = dvec + 15 * NW;         // 6 NW: pose deviation from the visual lin points
  float* ppA = dp6 + 6 * NW;           // 36 PP
  float* pprhs = ppA + 36 * PP;        // 6 PP
  float* ppe = pprhs + 6 * PP;         // PP
  float* pbrhs = ppe + PP;             // 6 PB
  float* pbe = pbrhs + 6 * PB;         // PB

  const int f = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int N = 15 * NW;
  const int row0 = 15 * f;
  const bool has_prev = f >= 1 && a.imu_mask[f - 1];
  const bool has_cur = f + 1 < NW && a.imu_mask[f];
  const bool gnss_on = a.gnss_mask[f];
  const bool odo_on = a.odo_mask[f];

  for (int q = tid; q < 2 * 15 * 30; q += kThreads) (&sJ[0][0])[q] = 0.f;
  __syncthreads();

  // 1. the factors, one thread each, and the frames' deviations
  if (warp == 0) {
    if (lane == 0 && has_prev) imu_factor(a, f - 1, sJ[0], sr[0]);
  } else if (warp == 1) {
    if (lane == 0 && has_cur) imu_factor(a, f, sJ[1], sr[1]);
  } else if (warp == 2) {
    for (int p = lane; p < PP; p += 32)
      if (prior_on(a.pp_mask, a.pp_frame, p, f))
        pose_prior(a, p, f, ppA + 36 * p, pprhs + 6 * p, ppe + p);
  } else if (warp == 3) {
    for (int p = lane; p < PB; p += 32)
      if (prior_on(a.pb_mask, a.pb_frame, p, f)) bias_prior(a, p, f, pbrhs + 6 * p, pbe + p);
  } else if (warp == 4) {
    if (lane == 0 && gnss_on) gnss_term(a, f, sGA, sGrhs, &sGrho);
    if (lane == 1 && odo_on) odo_term(a, f, sOA, sOrhs, &sOe);
  } else {
    for (int g = tid - 5 * 32; g < NW; g += kFrameThreads) {
      const float* Rg = a.R + 9 * g;
      const float* tg = a.t + 3 * g;
      float d[6];
      if (has_mgd) {
        const float* lin = a.mgd_lin + 21 * g;
        const float m = a.mgd_mask[g] ? 1.f : 0.f;
        se3_local(lin, lin + 9, Rg, tg, d);
#pragma unroll
        for (int q = 0; q < 6; ++q) dvec[15 * g + q] = d[q] * m;
#pragma unroll
        for (int q = 0; q < 3; ++q) dvec[15 * g + 6 + q] = (a.vel[3 * g + q] - lin[12 + q]) * m;
#pragma unroll
        for (int q = 0; q < 6; ++q) dvec[15 * g + 9 + q] = (a.bias[6 * g + q] - lin[15 + q]) * m;
      }
      se3_local(a.vis_linR + 9 * g, a.vis_lint + 3 * g, Rg, tg, d);
      const float m = a.valid[g] ? 1.f : 0.f;
#pragma unroll
      for (int q = 0; q < 6; ++q) dp6[6 * g + q] = d[q] * m;
    }
  }
  __syncthreads();

  // 2. the band's rows of J^T L, factor f's L r, and the band's rows of
  // mgd.H @ dvec and vis_H @ dp6 (a warp a row)
  for (int q = tid; q < 2 * 225 + 15; q += kThreads) {
    if (q < 2 * 225) {
      const int h = q / 225, rr = (q % 225) / 15, kk = q % 15;
      if (!(h ? has_cur : has_prev)) continue;
      const float* L = a.imu_info + 225 * (h ? f : f - 1);
      const int col = h ? rr : 15 + rr;
      float s = 0.f;
      for (int l = 0; l < 15; ++l) s += sJ[h][l * 30 + col] * L[l * 15 + kk];
      sJtL[h][rr * 15 + kk] = s;
    } else if (has_cur) {
      const int rr = q - 2 * 225;
      const float* L = a.imu_info + 225 * f;
      float s = 0.f;
      for (int l = 0; l < 15; ++l) s += L[rr * 15 + l] * sr[1][l];
      sLr[rr] = s;
    }
  }
  for (int row = warp; row < 21; row += kWarps) {
    const float* M;
    const float* x;
    int n;
    if (row < 15) {
      if (!has_mgd) continue;
      M = a.mgd_H + (size_t)(row0 + row) * N;
      x = dvec;
      n = N;
    } else {
      M = a.vis_H + (size_t)(6 * f + row - 15) * (6 * NW);
      x = dp6;
      n = 6 * NW;
    }
    float s = 0.f;
    for (int j = lane; j < n; j += 32) s += M[j] * x[j];
#pragma unroll
    for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) (row < 15 ? sHd[row] : sHv[row - 15]) = s;
  }
  __syncthreads();

  // 3. the band's rows of J^T L J and -J^T L r, and factor f's error
  for (int q = tid; q < 2 * 450 + 2 * 15 + 1; q += kThreads) {
    if (q < 2 * 450) {
      const int h = q / 450, rr = (q % 450) / 30, c = q % 30;
      if (!(h ? has_cur : has_prev)) continue;
      float s = 0.f;
      for (int k = 0; k < 15; ++k) s += sJtL[h][rr * 15 + k] * sJ[h][k * 30 + c];
      sA[h][rr * 30 + c] = s;
    } else if (q < 2 * 450 + 2 * 15) {
      const int h = (q - 900) / 15, rr = (q - 900) % 15;
      if (!(h ? has_cur : has_prev)) continue;
      float s = 0.f;
      for (int k = 0; k < 15; ++k) s += sJtL[h][rr * 15 + k] * sr[h][k];
      srhs[h][rr] = -s;
    } else if (has_cur) {
      float s = 0.f;
      for (int k = 0; k < 15; ++k) s += sr[1][k] * sLr[k];
      sE = 0.5f * s;
    }
  }
  __syncthreads();

  // 4. b and the error's share of the band, then H's rows, each element by
  // one thread, its terms in the plain version's order (IMU, pose priors,
  // bias priors, GNSS, odometry, marginal, visual, hold)
  if (tid < 15) {
    const int i = tid, o = odo_slot(i);
    float v = 0.f;
    if (has_prev) v += srhs[0][i];
    if (has_cur) v += srhs[1][i];
    if (i < 6)
      for (int p = 0; p < PP; ++p)
        if (prior_on(a.pp_mask, a.pp_frame, p, f)) v += pprhs[6 * p + i];
    if (i >= 9)
      for (int p = 0; p < PB; ++p)
        if (prior_on(a.pb_mask, a.pb_frame, p, f)) v += pbrhs[6 * p + i - 9];
    if (gnss_on && i >= 3 && i < 6) v += sGrhs[i - 3];
    if (odo_on && o >= 0) v += sOrhs[o];
    if (has_mgd) v = v + a.mgd_v[row0 + i] - sHd[i];
    if (i < 6) v = v + (a.vis_v[6 * f + i] - sHv[i]);
    a.b[row0 + i] = v;
  } else if (tid == 15) {
    float e = 0.f;
    if (has_cur) e += sE;
    for (int p = 0; p < PP; ++p)
      if (prior_on(a.pp_mask, a.pp_frame, p, f)) e += ppe[p];
    for (int p = 0; p < PB; ++p)
      if (prior_on(a.pb_mask, a.pb_frame, p, f)) e += pbe[p];
    if (gnss_on) e += sGrho;
    if (odo_on) e += sOe;
    if (has_mgd)
      for (int i = 0; i < 15; ++i)
        e += dvec[row0 + i] * (0.5f * sHd[i] - a.mgd_v[row0 + i]);
    for (int i = 0; i < 6; ++i) e += dp6[6 * f + i] * (0.5f * sHv[i] - a.vis_v[6 * f + i]);
    a.partial[f] = e;
  }

  float* Hrow = a.H + (size_t)row0 * N;
  const float* Mrow = has_mgd ? a.mgd_H + (size_t)row0 * N : nullptr;
  const float* Vrow = a.vis_H + (size_t)(6 * f) * (6 * NW);
  for (int idx = tid; idx < 15 * N; idx += kThreads) {
    const int i = idx / N, j = idx - i * N;
    const int g = j / 15, c = j - 15 * g;
    float v = 0.f;
    if (g == f) {
      if (has_prev) v += sA[0][i * 30 + 15 + c];
      if (has_cur) v += sA[1][i * 30 + c];
      if (i < 6 && c < 6)
        for (int p = 0; p < PP; ++p)
          if (prior_on(a.pp_mask, a.pp_frame, p, f)) v += ppA[36 * p + 6 * i + c];
      if (i >= 9 && c >= 9)
        for (int p = 0; p < PB; ++p)
          if (prior_on(a.pb_mask, a.pb_frame, p, f)) v += a.pb_info[36 * p + 6 * (i - 9) + c - 9];
      if (gnss_on && i >= 3 && i < 6 && c >= 3 && c < 6) v += sGA[3 * (i - 3) + c - 3];
      const int oi = odo_slot(i), oc = odo_slot(c);
      if (odo_on && oi >= 0 && oc >= 0) v += sOA[6 * oi + oc];
    } else if (g == f - 1) {
      if (has_prev) v += sA[0][i * 30 + c];
    } else if (g == f + 1) {
      if (has_cur) v += sA[1][i * 30 + 15 + c];
    }
    if (has_mgd) v = v + Mrow[idx];
    if (i < 6 && c < 6) v = v + Vrow[i * 6 * NW + 6 * g + c];
    if (hold_empty && j == row0 + i && v == 0.f) v = 1.f;  // hold an unconstrained row
    Hrow[idx] = v;
  }
}

// err = the bands' shares summed in frame order
__global__ void fg_error_sum_kernel(const float* partial, int NW, float* err) {
  if (threadIdx.x != 0) return;
  float s = 0.f;
  for (int f = 0; f < NW; ++f) s += partial[f];
  *err = s;
}

}  // namespace

// operands: kNumOperands device pointers in FgLinearizeArgs order (the four
// marginal pointers null without a marginal); returns 0 or the launch's
// cudaError, kBadOperands or kBadShape
extern "C" int fg_linearize_launch(const void* const* operands, int n_operands, int NW, int PP,
                                   int PB, int has_mgd, int hold_empty, void* stream) {
  if (n_operands != kNumOperands) return kBadOperands;
  if (NW < 2 || NW > kMaxFrames || PP < 0 || PP > kMaxPriors || PB < 0 || PB > kMaxPriors)
    return kBadShape;
  FgLinearizeArgs a;
  memcpy(&a, operands, sizeof(a));
  const size_t smem = sizeof(float) * (21 * NW + 43 * PP + 7 * PB);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fg_linearize_kernel<<<NW, kThreads, smem, s>>>(a, NW, PP, PB, has_mgd, hold_empty);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  fg_error_sum_kernel<<<1, 32, 0, s>>>(a.partial, NW, a.err);
  return static_cast<int>(cudaGetLastError());
}
