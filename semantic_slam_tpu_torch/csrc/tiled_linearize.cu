// K6 and K7: the linearization of a row range [off, off + Kl) of poses
// (observation edges and odometry chain) for Hopper (sm_90a), in one entry
// point of two launches.
//
// Replaces the TPU kernels semantic_slam_tpu/solver/pallas_tiled.py
// `_lin_obs_kernel` (K6) and `_lin_chain_kernel` (K7), which the TPU wrapper
// `tiled_linearize` issues one after the other. Plain versions:
// solver/soa_dist.py `obs_plain` and `chain_plain`.
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
// Design, no float atomics, no host sync: K1's two launches (soa_common.cuh
// chain_block and lin_slots_block, then lin_fold_block) on the range's
// arrays, here under names of their own so that a trace tells K6 and K7 from
// K1 and K2:
//   rows_lin_slots: ceil(Kl / 32) chain blocks of 32 rows (K7: each warp
//      computes the rows' Jacobians, then its share of a row's 17 output
//      tasks; row k's successor is succ[:, k], the range's last row
//      included), then the slot blocks, which spread each row's R slots over
//      the grid (solver/kernels.py `lin_split` picks RB and G, counting the
//      chain blocks);
//   rows_lin_fold: gl and Hll over the range's CSR, the chunk sums folded
//      with the i-side only (gp = obs + gi, diag = obs + Hii), and the chi2
//      total over the slot blocks' and then the chain blocks' partials in
//      index order, with the chain's own share apart.
// Without the chain blocks the first launch is K6's slot pass alone, and the
// fold takes given chain blocks and chain chi2 (K6 alone, as the timing of K6
// and the tests use it). Empty slots have zero information, so everything
// they add is exactly 0.

#include "soa_common.cuh"

using namespace soa;

namespace {

__global__ void __launch_bounds__(POSE_GROUP * MAX_SLOT_GROUPS, 2)
rows_lin_slots(const float* __restrict__ pose, const float* __restrict__ succ, const float* __restrict__ lm,
               const float* __restrict__ meas, const float* __restrict__ info, const int* __restrict__ ll_rk,
               const float* __restrict__ o_meas, const float* __restrict__ o_info, int Kl, int R, int RB,
               int n_chain, int kind, float delta, float* __restrict__ v_out, float* __restrict__ Ow_out,
               float* __restrict__ Rt_out, float* __restrict__ Hii, float* __restrict__ Hij,
               float* __restrict__ Hjj, float* __restrict__ gi, float* __restrict__ gj,
               float* __restrict__ pose_part, float* __restrict__ chi_part) {
  __shared__ float part[MAX_SLOT_GROUPS * POSE_PART * POSE_GROUP];
  __shared__ float red[32];
  const int b = blockIdx.x;
  if (b >= n_chain) {
    lin_slots_block(b - n_chain, pose, lm, meas, info, ll_rk, Kl, R, RB, kind, delta, v_out, Ow_out, Rt_out,
                    pose_part, chi_part, part, red);
  } else {
    chain_block(b, pose, succ, o_meas, o_info, Kl, R, RB, Hii, Hij, Hjj, gi, gj, chi_part, part, red);
  }
}

__global__ void __launch_bounds__(FOLD_BLOCK)
rows_lin_fold(const float* __restrict__ pose, const float* __restrict__ lm, const float* __restrict__ meas,
              const float* __restrict__ info, const int* __restrict__ ll_rk, const int* __restrict__ lm_slots,
              const int* __restrict__ lm_start, int Kl, int R, int L, int kind, float delta,
              const float* __restrict__ pose_part, int C, const float* __restrict__ gi, const float* __restrict__ Hii,
              const float* __restrict__ chi_part, int n_slot, int n_chain, const float* __restrict__ chi_given,
              int n_lm, int n_fold, float* __restrict__ gl, float* __restrict__ Hll, float* __restrict__ gp,
              float* __restrict__ diag, float* __restrict__ chi, float* __restrict__ chi_chain) {
  lin_fold_block(blockIdx.x, pose, lm, meas, info, ll_rk, lm_slots, lm_start, Kl, R, L, kind, delta, pose_part, C, gi,
                 Hii, nullptr, nullptr, false, chi_part, n_slot, n_chain, chi_given, n_lm, n_fold, gl, Hll, gp, diag,
                 chi, chi_chain);
}

}  // namespace

// Scratch floats the entry point needs from the wrapper: chunk sums [C, 33,
// Kl], C = ceil(R / RB), and a chi2 partial per slot block and, with the
// chain, per chain block.
extern "C" long long tiled_lin_scratch(int Kl, int R, int RB, int chain) {
  return lin_scratch(Kl, R, RB, chain ? (Kl + POSE_GROUP - 1) / POSE_GROUP : 0);
}

// K6 and K7 with RB slots a block in G slot groups (warps). With `chain`, K7
// runs as ceil(Kl / 32) chain blocks of the first launch against `succ` and
// writes Hii, Hij, Hjj, gi, gj and the chain's chi2 (chi_chain); without,
// they and chi_chain are inputs (succ, o_meas, o_info, Hij, Hjj and gj
// unread). Two launches on `stream`; returns cudaGetLastError() (0 = ok).
extern "C" int tiled_lin_launch(const float* pose, const float* succ, const float* lm, const float* meas,
                                const float* info, const int* ll_rk, const int* lm_slots, const int* lm_start,
                                const float* o_meas, const float* o_info, int Kl, int R, int L, int RB, int G,
                                int chain, int robust_kind, float robust_delta, float* Hii, float* Hij, float* Hjj,
                                float* gi, float* gj, float* chi_chain, float* v, float* Ow, float* Rt, float* gp,
                                float* diag, float* gl, float* Hll, float* chi, float* scratch, void* stream_ptr) {
  if (Kl <= 0 || R <= 0 || L <= 0 || RB <= 0 || G <= 0 || G > MAX_SLOT_GROUPS || (chain && !succ)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int C = (R + RB - 1) / RB, n_slot = static_cast<int>(lin_slot_blocks(Kl, R, RB));
  const int n_chain = chain ? (Kl + POSE_GROUP - 1) / POSE_GROUP : 0;
  float* pose_part = scratch;
  float* chi_part = pose_part + static_cast<long long>(C) * POSE_PART * Kl;
  rows_lin_slots<<<n_chain + n_slot, POSE_GROUP * G, 0, stream>>>(
      pose, succ, lm, meas, info, ll_rk, o_meas, o_info, Kl, R, RB, n_chain, robust_kind, robust_delta, v, Ow, Rt,
      Hii, Hij, Hjj, gi, gj, pose_part, chi_part);
  int n_lm, n_fold;
  lin_fold_blocks(Kl, L, n_lm, n_fold);
  rows_lin_fold<<<n_lm + n_fold + 1, FOLD_BLOCK, 0, stream>>>(
      pose, lm, meas, info, ll_rk, lm_slots, lm_start, Kl, R, L, robust_kind, robust_delta, pose_part, C, gi, Hii,
      chi_part, n_slot, n_chain, chain ? nullptr : chi_chain, n_lm, n_fold, gl, Hll, gp, diag, chi,
      chain ? chi_chain : nullptr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* slam_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
