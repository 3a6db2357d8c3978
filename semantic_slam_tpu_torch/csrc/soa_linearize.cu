// K1 and K2: the SoA linearization (observation edges and odometry chain)
// for Hopper (sm_90a).
//
// Replaces the TPU kernels semantic_slam_tpu/solver/pallas_cg.py
// `_chain_lin_kernel` (K2, entry point soa_chain_lin_launch) and
// `_obs_lin_kernel` (K1, soa_obs_lin_launch), wrapper `resident_linearize`.
// Plain versions: solver/ellk_soa.py `soa_chain_linearize` and
// `soa_obs_linearize`.
//
// What bounds them: bytes. Per slot K1 reads meas + info (12 floats), the
// landmark index and row, and writes v + O' (12 floats) plus 12 floats of
// per-slot landmark terms that the landmark pass reads back; per pose K2
// reads the pose, its successor, the chain measurement and information (50
// floats) and writes the chain blocks and gradients (120 floats), and K1
// reads them back and writes gp, diag and Rt (51 floats). The arithmetic
// (~230 flops per slot, ~3k per chain edge) is far below the card's rate.
//
// Design, no atomics, no host sync:
//   K2 chain_kernel: one thread per pose k linearizes chain edge k -> k+1
//      (row K-1 wraps to pose 0 and carries zero information) and writes
//      Hii/Hij/Hjj, g_i, g_j and a per-block chi2 partial; reduce2_kernel
//      adds the partials in a fixed order into the chain's chi2 scalar;
//   K1 pose_kernel: one thread per pose loops over its R slots: residual,
//      robust rho and IRLS weight, v and O' out, the per-pose gradient and
//      6x6 diagonal summed in registers (deterministic), plus the chain's
//      i-side of pose k and j-side of pose k-1 (the TPU wrapper's
//      `gi + shift_down(gj)` and `Hii + shift_down(Hjj)`, fused here); the
//      per-slot landmark terms Rt^T O'r and Rt^T O' Rt go to scratch;
//      landmark_kernel: one warp per landmark sums its slots' terms in the
//      fixed order of the landmark CSR (SoAEdges.lm_slots/lm_start), so gl
//      and Hll are deterministic; reduce2_kernel adds the observation
//      partials and the chain's chi2 into the total.
// Empty slots have zero information, so everything they add is exactly 0.

#include "soa_common.cuh"

using namespace soa;

namespace {

constexpr int BLOCK = 128;

__global__ void __launch_bounds__(BLOCK)
chain_kernel(const float* __restrict__ pose, const float* __restrict__ o_meas, const float* __restrict__ o_info,
             int K, float* __restrict__ Hii, float* __restrict__ Hij, float* __restrict__ Hjj,
             float* __restrict__ gi, float* __restrict__ gj, float* __restrict__ partial) {
  __shared__ float smem[32];
  const int k = blockIdx.x * BLOCK + threadIdx.x;
  float chi[1] = {0.f};
  if (k < K) {
    V3 ti, tj, mt;
    Q4 qi, qj, mq;
    load_pose(pose, K, k, ti, qi);
    load_pose(pose, K, k + 1 < K ? k + 1 : 0, tj, qj);
    load_pose(o_meas, K, k, mt, mq);
    const Info6 O = load_info6(o_info, K, k);
    const ChainRes c = chain_residual(ti, qi, tj, qj, mt, mq);
    // J_j = Jr^-1(r), J_i = -J_j Ad(rel^-1), both [[X, Y], [0, X]]
    const M3 Xj = so3_ljac_inv(neg(c.rw));
    const M3 Yj = mneg(mul(Xj, mul(se3_Q(neg(c.rv), neg(c.rw)), Xj)));
    const Q4 q_ir = qconj(c.rel_q);
    const V3 t_ir = neg(qrotate(q_ir, c.rel_t));
    const M3 R_ir = rotmat(q_ir);
    const M3 Xi = mneg(mul(Xj, R_ir));
    const M3 Yi = mneg(madd(mul(Xj, hat_mul(t_ir, R_ir)), mul(Yj, R_ir)));
    // T = J^T O quadrants
    const M3 Ti11 = mulT(Xi, O.O11), Ti12 = mulT(Xi, O.O12);
    const M3 Ti21 = madd(mulT(Yi, O.O11), mulT(Xi, O.O21)), Ti22 = madd(mulT(Yi, O.O12), mulT(Xi, O.O22));
    const M3 Tj11 = mulT(Xj, O.O11), Tj12 = mulT(Xj, O.O12);
    const M3 Tj21 = madd(mulT(Yj, O.O11), mulT(Xj, O.O21)), Tj22 = madd(mulT(Yj, O.O12), mulT(Xj, O.O22));
    store_TJ(Hii, K, k, Ti11, Ti12, Ti21, Ti22, Xi, Yi);
    store_TJ(Hij, K, k, Ti11, Ti12, Ti21, Ti22, Xj, Yj);
    store_TJ(Hjj, K, k, Tj11, Tj12, Tj21, Tj22, Xj, Yj);
    store_v3(gi, K, k, add(mv(Ti11, c.rv), mv(Ti12, c.rw)));
    store_v3(gi + 3 * K, K, k, add(mv(Ti21, c.rv), mv(Ti22, c.rw)));
    store_v3(gj, K, k, add(mv(Tj11, c.rv), mv(Tj12, c.rw)));
    store_v3(gj + 3 * K, K, k, add(mv(Tj21, c.rv), mv(Tj22, c.rw)));
    chi[0] = chain_chi(c, O);
  }
  block_sum<1>(chi, smem);
  if (threadIdx.x == 0) partial[blockIdx.x] = chi[0];
}

__global__ void __launch_bounds__(BLOCK)
pose_kernel(const float* __restrict__ pose, const float* __restrict__ lm, const float* __restrict__ meas,
            const float* __restrict__ info, const int* __restrict__ ll_rk, int K, int R, int kind, float delta,
            const float* __restrict__ Hii, const float* __restrict__ Hjj, const float* __restrict__ gi,
            const float* __restrict__ gj, float* __restrict__ v_out, float* __restrict__ Ow_out,
            float* __restrict__ Rt_out, float* __restrict__ gp, float* __restrict__ diag,
            float* __restrict__ slot_gl, float* __restrict__ slot_hll, float* __restrict__ partial) {
  __shared__ float smem[32];
  const int k = blockIdx.x * BLOCK + threadIdx.x;
  const int E = R * K;
  float chi[1] = {0.f};
  if (k < K) {
    V3 t;
    Q4 q;
    load_pose(pose, K, k, t, q);
    const M3 Rt = rotmat(qconj(q));
    store_m3(Rt_out, K, k, Rt);
    V3 g_top = v3(0.f, 0.f, 0.f), g_bot = v3(0.f, 0.f, 0.f);
    M3 TL = mzero(), TR = mzero(), BR = mzero();
    for (int r = 0; r < R; ++r) {
      const int e = r * K + k;
      const ObsSlot s = obs_slot(Rt, t, lm, ll_rk, meas, info, E, e);
      float rho, w;
      robust_rho_w(s.chi, kind, delta, rho, w);
      chi[0] += rho;
      const M3 Ow = kind == ROBUST_NONE ? s.O : mscale(s.O, w);
      const V3 Orw = kind == ROBUST_NONE ? s.Or : scale(s.Or, w);
      store_v3(v_out, E, e, s.v);
      store_m3(Ow_out, E, e, Ow);
      g_top = sub(g_top, Orw);
      g_bot = sub(g_bot, cross(s.v, Orw));
      store_v3(slot_gl, E, e, mTv(Rt, Orw));
      store_m3(slot_hll, E, e, mulT(Rt, mul(Ow, Rt)));
      const M3 OB = ob_product(Ow, s.v);
      TL = madd(TL, Ow);
      TR = msub(TR, OB);
      BR = msub(BR, hat_mul(s.v, OB));
    }
    // gp = gp_obs + gi[k] + gj[k-1];  diag = diag_obs + Hii[k] + Hjj[k-1]
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float top = g_top.v[i] + gi[i * K + k], bot = g_bot.v[i] + gi[(i + 3) * K + k];
      if (k > 0) { top += gj[i * K + k - 1]; bot += gj[(i + 3) * K + k - 1]; }
      gp[i * K + k] = top;
      gp[(i + 3) * K + k] = bot;
    }
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        float d;
        if (i < 3) d = j < 3 ? TL.m[i][j] : TR.m[i][j - 3];
        else d = j < 3 ? TR.m[j][i - 3] : BR.m[i - 3][j - 3];
        const int c = i * 6 + j;
        d += Hii[c * K + k];
        if (k > 0) d += Hjj[c * K + k - 1];
        diag[c * K + k] = d;
      }
  }
  block_sum<1>(chi, smem);
  if (threadIdx.x == 0) partial[blockIdx.x] = chi[0];
}

// one warp per landmark: gl [L,3], Hll [L,9] from the per-slot terms
__global__ void __launch_bounds__(BLOCK)
landmark_kernel(const float* __restrict__ slot_gl, const float* __restrict__ slot_hll,
                const int* __restrict__ lm_slots, const int* __restrict__ lm_start, int L, int E,
                float* __restrict__ gl, float* __restrict__ Hll) {
  const int l = (blockIdx.x * BLOCK + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (l >= L) return;  // whole warps leave together
  float acc[12];
#pragma unroll
  for (int c = 0; c < 12; ++c) acc[c] = 0.f;
  for (int j = lm_start[l] + lane; j < lm_start[l + 1]; j += 32) {
    const int e = lm_slots[j];
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[c] += slot_gl[c * E + e];
#pragma unroll
    for (int c = 0; c < 9; ++c) acc[3 + c] += slot_hll[c * E + e];
  }
#pragma unroll
  for (int c = 0; c < 12; ++c)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[c] += __shfl_down_sync(0xffffffffu, acc[c], off);
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) gl[3 * l + c] = acc[c];
#pragma unroll
    for (int c = 0; c < 9; ++c) Hll[9 * l + c] = acc[3 + c];
  }
}

}  // namespace

// Scratch floats each entry point needs from the wrapper.
extern "C" long long soa_chain_lin_scratch(int K) { return (K + BLOCK - 1) / BLOCK; }
extern "C" long long soa_obs_lin_scratch(int K, int R) {
  return 12LL * K * R + (K + BLOCK - 1) / BLOCK;
}

// K2. Launches on `stream`; returns cudaGetLastError() (0 = ok).
extern "C" int soa_chain_lin_launch(const float* pose, const float* o_meas, const float* o_info, int K, float* Hii,
                                    float* Hij, float* Hjj, float* gi, float* gj, float* chi, float* scratch,
                                    void* stream_ptr) {
  if (K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int nb = (K + BLOCK - 1) / BLOCK;
  chain_kernel<<<nb, BLOCK, 0, stream>>>(pose, o_meas, o_info, K, Hii, Hij, Hjj, gi, gj, scratch);
  reduce2_kernel<<<1, 256, 0, stream>>>(scratch, nb, nullptr, 0, chi);
  return static_cast<int>(cudaGetLastError());
}

// K1, given K2's outputs. Launches on `stream`; returns cudaGetLastError().
extern "C" int soa_obs_lin_launch(const float* pose, const float* lm, const float* meas, const float* info,
                                  const int* ll_rk, const int* lm_slots, const int* lm_start, const float* Hii,
                                  const float* Hjj, const float* gi, const float* gj, const float* chi_chain, int K,
                                  int R, int L, int robust_kind, float robust_delta, float* v, float* Ow, float* Rt,
                                  float* gp, float* diag, float* gl, float* Hll, float* chi, float* scratch,
                                  void* stream_ptr) {
  if (K <= 0 || R <= 0 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long E = static_cast<long long>(K) * R;
  const int nb = (K + BLOCK - 1) / BLOCK;
  float* slot_gl = scratch;
  float* slot_hll = slot_gl + 3 * E;
  float* part_obs = slot_hll + 9 * E;
  pose_kernel<<<nb, BLOCK, 0, stream>>>(pose, lm, meas, info, ll_rk, K, R, robust_kind, robust_delta, Hii, Hjj, gi,
                                        gj, v, Ow, Rt, gp, diag, slot_gl, slot_hll, part_obs);
  const long long lanes = 32LL * L;
  landmark_kernel<<<static_cast<int>((lanes + BLOCK - 1) / BLOCK), BLOCK, 0, stream>>>(
      slot_gl, slot_hll, lm_slots, lm_start, L, static_cast<int>(E), gl, Hll);
  reduce2_kernel<<<1, 256, 0, stream>>>(part_obs, nb, chi_chain, 1, chi);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* slam_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
