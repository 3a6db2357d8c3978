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
    V3 ti, tj;
    Q4 qi, qj;
    load_pose(pose, K, k, ti, qi);
    load_pose(pose, K, k + 1 < K ? k + 1 : 0, tj, qj);
    chi[0] = chain_linearize_row(ti, qi, tj, qj, o_meas, o_info, K, k, Hii, Hij, Hjj, gi, gj);
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
  float chi[1] = {0.f};
  if (k < K) {
    const ObsPose o = obs_pose_linearize(pose, lm, meas, info, ll_rk, K, R, k, kind, delta, v_out, Ow_out, Rt_out,
                                         slot_gl, slot_hll);
    chi[0] = o.chi;
    // gp = gp_obs + gi[k] + gj[k-1];  diag = diag_obs + Hii[k] + Hjj[k-1]
    store_pose_gp_diag(o, gi, Hii, gj, Hjj, K, k, gp, diag);
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
  landmark_sum12(slot_gl, slot_hll, lm_slots, lm_start[l], lm_start[l + 1], E, lane, acc);
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
