// K3: the LM trial objective (observation + odometry chain chi2) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel semantic_slam_tpu/solver/pallas_cg.py `_chi2_kernel`
// (wrapper `resident_chi2`). Plain version: solver/ellk_soa.py `soa_chi2`.
// The per-slot and per-pose math is that of the linearization (K1/K2,
// soa_linearize.cu); nothing edge-sized is written.
//
// What bounds it: bytes. Per slot it reads meas + info (12 floats), the
// landmark index and row; per pose the pose, its successor, the chain
// measurement and information (50 floats). ~60 flops per slot and ~400 per
// chain edge are far below the card's rate.
//
// Design: one thread per pose k evaluates chain edge k -> k+1 and its R slots
// (robust rho), a block sums its threads in a fixed tree, and one more block
// adds the per-block partials in a fixed order into a device scalar. No
// atomics, no host sync.

#include "soa_common.cuh"

using namespace soa;

namespace {

constexpr int BLOCK = 128;

__global__ void __launch_bounds__(BLOCK)
chi2_kernel(const float* __restrict__ pose, const float* __restrict__ lm, const float* __restrict__ meas,
            const float* __restrict__ info, const int* __restrict__ ll_rk, const float* __restrict__ o_meas,
            const float* __restrict__ o_info, int K, int R, int kind, float delta, float* __restrict__ part_obs,
            float* __restrict__ part_chain) {
  __shared__ float smem[64];
  const int k = blockIdx.x * BLOCK + threadIdx.x;
  float chi[2] = {0.f, 0.f};
  if (k < K) {
    V3 tj;
    Q4 qj;
    load_pose(pose, K, k + 1 < K ? k + 1 : 0, tj, qj);
    pose_chi2(pose, tj, qj, lm, meas, info, ll_rk, o_meas, o_info, K, R, k, kind, delta, chi);
  }
  block_sum<2>(chi, smem);
  if (threadIdx.x == 0) {
    part_obs[blockIdx.x] = chi[0];
    part_chain[blockIdx.x] = chi[1];
  }
}

}  // namespace

extern "C" long long soa_chi2_scratch(int K) { return 2LL * ((K + BLOCK - 1) / BLOCK); }

// Launches on `stream`; returns cudaGetLastError() of the launches (0 = ok).
extern "C" int soa_chi2_launch(const float* pose, const float* lm, const float* meas, const float* info,
                               const int* ll_rk, const float* o_meas, const float* o_info, int K, int R,
                               int robust_kind, float robust_delta, float* chi, float* scratch, void* stream_ptr) {
  if (K <= 0 || R <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int nb = (K + BLOCK - 1) / BLOCK;
  chi2_kernel<<<nb, BLOCK, 0, stream>>>(pose, lm, meas, info, ll_rk, o_meas, o_info, K, R, robust_kind,
                                        robust_delta, scratch, scratch + nb);
  reduce2_kernel<<<1, 256, 0, stream>>>(scratch, nb, scratch + nb, nb, chi);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* slam_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
