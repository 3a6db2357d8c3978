// K1 and K2: the SoA linearization (observation edges and odometry chain)
// for Hopper (sm_90a), in one entry point of two launches.
//
// Replaces the TPU kernels semantic_slam_tpu/solver/pallas_cg.py
// `_obs_lin_kernel` (K1) and `_chain_lin_kernel` (K2), which the TPU wrapper
// `resident_linearize` issues one after the other and then combines. Plain
// versions: solver/ellk_soa.py `soa_obs_linearize` and `soa_chain_linearize`.
//
// What bounds them: bytes. Per slot K1 reads meas + info (12 floats), the
// landmark index and row, and writes v + O' (12 floats); per pose K2 reads
// the pose, its successor, the chain measurement and information (50 floats)
// and writes the chain blocks and gradients (120 floats), and K1's fold reads
// 84 of them back and writes gp, diag and Rt (51 floats). The arithmetic
// (~230 flops per slot, ~3k per chain edge) is far below the card's rate.
// At the fixed-lag session's K=512 the bound of K2's part (~0.1 us) is below
// one launch: K2 comes near it only by having no launch of its own.
//
// Design, no float atomics, no host sync: the two launches of soa_common.cuh
// (chain_block and lin_slots_block, then lin_fold_block), with K2 as a block
// role of the first.
//   lin_slots_kernel: ceil(K / 32) chain blocks, then the slot blocks, G
//      warps a block (solver/kernels.py `lin_split` picks RB and G from K, R
//      and the card's SM count, counting the chain blocks). A chain block
//      holds 32 consecutive rows (one a lane): each of its G warps computes
//      the rows' residual and Jacobians (chain_jacobians, the serial part),
//      then its share of each row's 108 H entries, 12 gradient entries and
//      chi2 (chain_row_group_linearize), so that each store is 32
//      consecutive floats. The rows' information is copied into shared
//      memory (cp.async) while the serial part runs. Row K-1 wraps to pose 0
//      and carries zero information. The chain blocks come first so that
//      their longer serial part overlaps the slot blocks; their chi2
//      partials go after the slot blocks'.
//   lin_fold_kernel: landmarks, the per-pose fold of the chunk sums with the
//      chain's i-side of pose k and j-side of pose k-1, and the chi2 total
//      over the slot and chain partials in index order.
// Without the chain blocks the first launch is K1's slot pass alone, and the
// fold takes given chain blocks and chain chi2 (K1 alone, as the timing of
// K1 and the tests use it).

#include "soa_common.cuh"

using namespace soa;

namespace {

__global__ void __launch_bounds__(POSE_GROUP * MAX_SLOT_GROUPS, 2)
lin_slots_kernel(const float* __restrict__ pose, const float* __restrict__ lm, const float* __restrict__ meas,
                 const float* __restrict__ info, const int* __restrict__ ll_rk, const float* __restrict__ o_meas,
                 const float* __restrict__ o_info, int K, int R, int RB, int n_chain, int kind, float delta,
                 float* __restrict__ v_out, float* __restrict__ Ow_out, float* __restrict__ Rt_out,
                 float* __restrict__ Hii, float* __restrict__ Hij, float* __restrict__ Hjj, float* __restrict__ gi,
                 float* __restrict__ gj, float* __restrict__ pose_part, float* __restrict__ chi_part) {
  __shared__ float part[MAX_SLOT_GROUPS * POSE_PART * POSE_GROUP];
  __shared__ float red[32];
  const int b = blockIdx.x;
  if (b >= n_chain) {
    lin_slots_block(b - n_chain, pose, lm, meas, info, ll_rk, K, R, RB, kind, delta, v_out, Ow_out, Rt_out,
                    pose_part, chi_part, part, red);
  } else {
    chain_block(b, pose, nullptr, o_meas, o_info, K, R, RB, Hii, Hij, Hjj, gi, gj, chi_part, part, red);
  }
}

__global__ void __launch_bounds__(FOLD_BLOCK)
lin_fold_kernel(const float* __restrict__ pose, const float* __restrict__ lm, const float* __restrict__ meas,
                const float* __restrict__ info, const int* __restrict__ ll_rk, const int* __restrict__ lm_slots,
                const int* __restrict__ lm_start, int K, int R, int L, int kind, float delta,
                const float* __restrict__ pose_part, int C, const float* __restrict__ gi,
                const float* __restrict__ Hii, const float* __restrict__ gj, const float* __restrict__ Hjj,
                const float* __restrict__ chi_part, int n_slot, int n_chain, const float* __restrict__ chi_given,
                int n_lm, int n_fold, float* __restrict__ gl, float* __restrict__ Hll, float* __restrict__ gp,
                float* __restrict__ diag, float* __restrict__ chi, float* __restrict__ chi_chain) {
  lin_fold_block(blockIdx.x, pose, lm, meas, info, ll_rk, lm_slots, lm_start, K, R, L, kind, delta, pose_part, C, gi,
                 Hii, gj, Hjj, true, chi_part, n_slot, n_chain, chi_given, n_lm, n_fold, gl, Hll, gp, diag, chi,
                 chi_chain);
}

}  // namespace

// Scratch floats the entry point needs from the wrapper: chunk sums [C, 33,
// K], C = ceil(R / RB), and a chi2 partial per slot block and, with the
// chain, per chain block.
extern "C" long long soa_lin_scratch(int K, int R, int RB, int chain) {
  return lin_scratch(K, R, RB, chain ? (K + POSE_GROUP - 1) / POSE_GROUP : 0);
}

// K1 and K2 with RB slots a block in G slot groups (warps). With `chain`, K2
// runs as ceil(K / 32) chain blocks of the first launch and writes Hii, Hij,
// Hjj, gi, gj and the chain's chi2 (chi_chain); without, they and chi_chain
// are inputs (Hij unread). Two launches on `stream`; returns
// cudaGetLastError() (0 = ok).
extern "C" int soa_lin_launch(const float* pose, const float* lm, const float* meas, const float* info,
                              const int* ll_rk, const int* lm_slots, const int* lm_start, const float* o_meas,
                              const float* o_info, int K, int R, int L, int RB, int G, int chain, int robust_kind,
                              float robust_delta, float* Hii, float* Hij, float* Hjj, float* gi, float* gj,
                              float* chi_chain, float* v, float* Ow, float* Rt, float* gp, float* diag, float* gl,
                              float* Hll, float* chi, float* scratch, void* stream_ptr) {
  if (K <= 0 || R <= 0 || L <= 0 || RB <= 0 || G <= 0 || G > MAX_SLOT_GROUPS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int C = (R + RB - 1) / RB, n_slot = static_cast<int>(lin_slot_blocks(K, R, RB));
  const int n_chain = chain ? (K + POSE_GROUP - 1) / POSE_GROUP : 0;
  float* pose_part = scratch;
  float* chi_part = pose_part + static_cast<long long>(C) * POSE_PART * K;
  lin_slots_kernel<<<n_chain + n_slot, POSE_GROUP * G, 0, stream>>>(
      pose, lm, meas, info, ll_rk, o_meas, o_info, K, R, RB, n_chain, robust_kind, robust_delta, v, Ow, Rt, Hii, Hij,
      Hjj, gi, gj, pose_part, chi_part);
  int n_lm, n_fold;
  lin_fold_blocks(K, L, n_lm, n_fold);
  lin_fold_kernel<<<n_lm + n_fold + 1, FOLD_BLOCK, 0, stream>>>(
      pose, lm, meas, info, ll_rk, lm_slots, lm_start, K, R, L, robust_kind, robust_delta, pose_part, C, gi, Hii, gj,
      Hjj, chi_part, n_slot, n_chain, chain ? nullptr : chi_chain, n_lm, n_fold, gl, Hll, gp, diag, chi,
      chain ? chi_chain : nullptr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* slam_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
