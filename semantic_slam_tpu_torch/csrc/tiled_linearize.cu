// K6 and K7: the linearization of a row range [off, off + Kl) of poses
// (observation edges and odometry chain) for Hopper (sm_90a).
//
// Replaces the TPU kernels semantic_slam_tpu/solver/pallas_tiled.py
// `_lin_chain_kernel` (K7, entry point tiled_chain_lin_launch) and
// `_lin_obs_kernel` (K6, tiled_obs_lin_launch), wrapper `tiled_linearize`.
// Plain versions: solver/soa_dist.py `chain_plain` and `obs_plain`.
//
// The contract that a multi-device loop builds on: every array here is the
// range's own ([C, Kl] per row, [C, R, Kl] per slot, slot (r, k) at
// e = r*Kl + k); the landmark tables gl [L,3] and Hll [L,9] and the chi2 are
// sums over the range's slots only (the range's landmark CSR); the chain's
// successor pose of each row comes from the host (`succ`, the replicated
// poses rolled by one and sliced to the range), so the range's last row sees
// the next range's first pose; and the chain's j-side (gj, Hjj) is left
// unshifted for the host to add to pose k+1 after the reduction. K6 folds
// only the i-side (gi, Hii) into gp and diag.
//
// What bounds them: bytes, as for K1/K2 (soa_linearize.cu): per slot K6
// reads meas + info (12 floats), the landmark index and row, and writes v +
// O' (12 floats) plus 12 floats of landmark terms that its landmark pass
// reads back; per row K7 reads the pose, its successor, the chain
// measurement and information (57 floats) and writes 120, and K6 reads 42
// of them back and writes gp, diag and Rt (51 floats).
//
// Design, no atomics, no host sync (the per-row bodies are K1/K2's, shared
// through soa_common.cuh):
//   K7 rows_chain: one thread per row linearizes chain edge k -> k+1 against
//      succ[:, k]; per-block chi2 partials, added in a fixed order by
//      reduce2_kernel;
//   K6 rows_obs_pose: one thread per row walks its R slots (v, O' out, the
//      gradient and 6x6 diagonal in registers, plus gi/Hii of the row), the
//      landmark terms to scratch; rows_obs_lm: one warp per landmark sums its
//      slots' terms in the fixed order of the range's CSR; reduce2_kernel
//      adds the observation partials and K7's chi2.
// Empty slots have zero information, so everything they add is exactly 0.

#include "soa_common.cuh"

using namespace soa;

namespace {

constexpr int BLOCK = 128;

__global__ void __launch_bounds__(BLOCK)
rows_chain(const float* __restrict__ pose, const float* __restrict__ succ, const float* __restrict__ o_meas,
           const float* __restrict__ o_info, int Kl, float* __restrict__ Hii, float* __restrict__ Hij,
           float* __restrict__ Hjj, float* __restrict__ gi, float* __restrict__ gj, float* __restrict__ partial) {
  __shared__ float smem[32];
  const int k = blockIdx.x * BLOCK + threadIdx.x;
  float chi[1] = {0.f};
  if (k < Kl) {
    V3 ti, tj;
    Q4 qi, qj;
    load_pose(pose, Kl, k, ti, qi);
    load_pose(succ, Kl, k, tj, qj);
    chi[0] = chain_linearize_row(ti, qi, tj, qj, o_meas, o_info, Kl, k, Hii, Hij, Hjj, gi, gj);
  }
  block_sum<1>(chi, smem);
  if (threadIdx.x == 0) partial[blockIdx.x] = chi[0];
}

__global__ void __launch_bounds__(BLOCK)
rows_obs_pose(const float* __restrict__ pose, const float* __restrict__ lm, const float* __restrict__ meas,
              const float* __restrict__ info, const int* __restrict__ ll_rk, int Kl, int R, int kind, float delta,
              const float* __restrict__ Hii, const float* __restrict__ gi, float* __restrict__ v_out,
              float* __restrict__ Ow_out, float* __restrict__ Rt_out, float* __restrict__ gp,
              float* __restrict__ diag, float* __restrict__ slot_gl, float* __restrict__ slot_hll,
              float* __restrict__ partial) {
  __shared__ float smem[32];
  const int k = blockIdx.x * BLOCK + threadIdx.x;
  float chi[1] = {0.f};
  if (k < Kl) {
    const ObsPose o = obs_pose_linearize(pose, lm, meas, info, ll_rk, Kl, R, k, kind, delta, v_out, Ow_out, Rt_out,
                                         slot_gl, slot_hll);
    chi[0] = o.chi;
    store_pose_gp_diag(o, gi, Hii, Kl, k, gp, diag);  // gp_obs + gi, diag_obs + Hii
  }
  block_sum<1>(chi, smem);
  if (threadIdx.x == 0) partial[blockIdx.x] = chi[0];
}

// one warp per landmark: the range's gl [L,3] and Hll [L,9]
__global__ void __launch_bounds__(BLOCK)
rows_obs_lm(const float* __restrict__ slot_gl, const float* __restrict__ slot_hll, const int* __restrict__ lm_slots,
            const int* __restrict__ lm_start, int L, int E, float* __restrict__ gl, float* __restrict__ Hll) {
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
extern "C" long long tiled_chain_lin_scratch(int Kl) { return (Kl + BLOCK - 1) / BLOCK; }
extern "C" long long tiled_obs_lin_scratch(int Kl, int R) {
  return 12LL * Kl * R + (Kl + BLOCK - 1) / BLOCK;
}

// K7. Launches on `stream`; returns cudaGetLastError() (0 = ok).
extern "C" int tiled_chain_lin_launch(const float* pose, const float* succ, const float* o_meas, const float* o_info,
                                      int Kl, float* Hii, float* Hij, float* Hjj, float* gi, float* gj, float* chi,
                                      float* scratch, void* stream_ptr) {
  if (Kl <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int nb = (Kl + BLOCK - 1) / BLOCK;
  rows_chain<<<nb, BLOCK, 0, stream>>>(pose, succ, o_meas, o_info, Kl, Hii, Hij, Hjj, gi, gj, scratch);
  reduce2_kernel<<<1, 256, 0, stream>>>(scratch, nb, nullptr, 0, chi);
  return static_cast<int>(cudaGetLastError());
}

// K6, given K7's gi, Hii and chi2. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int tiled_obs_lin_launch(const float* pose, const float* lm, const float* meas, const float* info,
                                    const int* ll_rk, const int* lm_slots, const int* lm_start, const float* Hii,
                                    const float* gi, const float* chi_chain, int Kl, int R, int L, int robust_kind,
                                    float robust_delta, float* v, float* Ow, float* Rt, float* gp, float* diag,
                                    float* gl, float* Hll, float* chi, float* scratch, void* stream_ptr) {
  if (Kl <= 0 || R <= 0 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long E = static_cast<long long>(Kl) * R;
  const int nb = (Kl + BLOCK - 1) / BLOCK;
  float* slot_gl = scratch;
  float* slot_hll = slot_gl + 3 * E;
  float* part_obs = slot_hll + 9 * E;
  rows_obs_pose<<<nb, BLOCK, 0, stream>>>(pose, lm, meas, info, ll_rk, Kl, R, robust_kind, robust_delta, Hii, gi, v,
                                          Ow, Rt, gp, diag, slot_gl, slot_hll, part_obs);
  const long long lanes = 32LL * L;
  rows_obs_lm<<<static_cast<int>((lanes + BLOCK - 1) / BLOCK), BLOCK, 0, stream>>>(
      slot_gl, slot_hll, lm_slots, lm_start, L, static_cast<int>(E), gl, Hll);
  reduce2_kernel<<<1, 256, 0, stream>>>(part_obs, nb, chi_chain, 1, chi);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* slam_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
