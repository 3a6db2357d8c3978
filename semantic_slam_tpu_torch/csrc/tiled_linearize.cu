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
// O' (12 floats); per row K7 reads the pose, its successor, the chain
// measurement and information (57 floats) and writes 120, and K6 reads 42 of
// them back and writes gp, diag and Rt (51 floats).
//
// Design, no atomics, no host sync:
//   K7 rows_chain: one thread per row linearizes chain edge k -> k+1 against
//      succ[:, k] (chain_linearize_row); per-block chi2 partials, added in a
//      fixed order by reduce2_kernel;
//   K6, K1's two launches on the range's arrays (soa_common.cuh
//      lin_slots_block, lin_fold_block, here under names of their own so that
//      a trace tells K6 from K1): rows_lin_slots spreads each row's R slots
//      over the grid (solver/kernels.py `lin_split` picks RB and G),
//      rows_lin_fold computes gl and Hll over the range's CSR, folds the
//      chunk sums with the i-side only (gp = obs + gi, diag = obs + Hii) and
//      adds the slot blocks' chi2 partials and K7's chi2.
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

__global__ void __launch_bounds__(POSE_GROUP * MAX_SLOT_GROUPS, 2)
rows_lin_slots(const float* __restrict__ pose, const float* __restrict__ lm, const float* __restrict__ meas,
               const float* __restrict__ info, const int* __restrict__ ll_rk, int Kl, int R, int RB, int kind,
               float delta, float* __restrict__ v_out, float* __restrict__ Ow_out, float* __restrict__ Rt_out,
               float* __restrict__ pose_part, float* __restrict__ chi_part) {
  __shared__ float part[MAX_SLOT_GROUPS * POSE_PART * POSE_GROUP];
  __shared__ float red[32];
  lin_slots_block(blockIdx.x, pose, lm, meas, info, ll_rk, Kl, R, RB, kind, delta, v_out, Ow_out, Rt_out, pose_part,
                  chi_part, part, red);
}

__global__ void __launch_bounds__(FOLD_BLOCK)
rows_lin_fold(const float* __restrict__ pose, const float* __restrict__ lm, const float* __restrict__ meas,
              const float* __restrict__ info, const int* __restrict__ ll_rk, const int* __restrict__ lm_slots,
              const int* __restrict__ lm_start, int Kl, int R, int L, int kind, float delta,
              const float* __restrict__ pose_part, int C, const float* __restrict__ gi, const float* __restrict__ Hii,
              const float* __restrict__ chi_part, int n_slot, const float* __restrict__ chi_chain, int n_lm,
              int n_fold, float* __restrict__ gl, float* __restrict__ Hll, float* __restrict__ gp,
              float* __restrict__ diag, float* __restrict__ chi) {
  lin_fold_block(blockIdx.x, pose, lm, meas, info, ll_rk, lm_slots, lm_start, Kl, R, L, kind, delta, pose_part, C, gi,
                 Hii, nullptr, nullptr, false, chi_part, n_slot, 0, chi_chain, n_lm, n_fold, gl, Hll, gp, diag, chi,
                 nullptr);
}

}  // namespace

// Scratch floats each entry point needs from the wrapper.
extern "C" long long tiled_chain_lin_scratch(int Kl) { return (Kl + BLOCK - 1) / BLOCK; }
extern "C" long long tiled_obs_lin_scratch(int Kl, int R, int RB) { return lin_scratch(Kl, R, RB, 0); }

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

// K6, given K7's gi, Hii and chi2, with RB slots a block in G slot groups
// (warps). Two launches on `stream`; returns cudaGetLastError() (0 = ok).
extern "C" int tiled_obs_lin_launch(const float* pose, const float* lm, const float* meas, const float* info,
                                    const int* ll_rk, const int* lm_slots, const int* lm_start, const float* Hii,
                                    const float* gi, const float* chi_chain, int Kl, int R, int L, int RB, int G,
                                    int robust_kind, float robust_delta, float* v, float* Ow, float* Rt, float* gp,
                                    float* diag, float* gl, float* Hll, float* chi, float* scratch,
                                    void* stream_ptr) {
  if (Kl <= 0 || R <= 0 || L <= 0 || RB <= 0 || G <= 0 || G > MAX_SLOT_GROUPS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int C = (R + RB - 1) / RB, n_slot = static_cast<int>(lin_slot_blocks(Kl, R, RB));
  float* pose_part = scratch;
  float* chi_part = pose_part + static_cast<long long>(C) * POSE_PART * Kl;
  rows_lin_slots<<<n_slot, POSE_GROUP * G, 0, stream>>>(pose, lm, meas, info, ll_rk, Kl, R, RB, robust_kind,
                                                        robust_delta, v, Ow, Rt, pose_part, chi_part);
  int n_lm, n_fold;
  lin_fold_blocks(Kl, L, n_lm, n_fold);
  rows_lin_fold<<<n_lm + n_fold + 1, FOLD_BLOCK, 0, stream>>>(pose, lm, meas, info, ll_rk, lm_slots, lm_start, Kl, R,
                                                              L, robust_kind, robust_delta, pose_part, C, gi, Hii,
                                                              chi_part, n_slot, chi_chain, n_lm, n_fold, gl, Hll, gp,
                                                              diag, chi);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* slam_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
