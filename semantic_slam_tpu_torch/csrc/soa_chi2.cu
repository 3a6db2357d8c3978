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
// Design: two launches. The first (soa_common.cuh chi2_slots_block, which
// K10 shares) spreads the slots as K1 does (soa_linearize.cu
// lin_slots_kernel): a grid of (pose ranges of 32, slot
// chunks of RB) with G warps a block, thread (lane, g) walking its pose's
// slots r = r0 + g, r0 + g + G, ... of the block's chunk (solver/kernels.py
// `lin_split` picks RB and G), so that the grid fills the card at K=512 as at
// K=4096. Warp 0 of each pose range's first chunk also evaluates the chain
// edges k -> k+1 of its 32 poses. A block sums its threads in a fixed tree
// and writes its two partials; reduce2_kernel then adds them in a fixed order
// into the device scalar, so a repeat gives the same bits. No atomics, no
// host sync.

#include "soa_common.cuh"

using namespace soa;

namespace {

__global__ void __launch_bounds__(POSE_GROUP * MAX_SLOT_GROUPS)
chi2_slots_kernel(const float* __restrict__ pose, const float* __restrict__ lm, const float* __restrict__ meas,
                  const float* __restrict__ info, const int* __restrict__ ll_rk, const float* __restrict__ o_meas,
                  const float* __restrict__ o_info, int K, int R, int RB, int kind, float delta,
                  float* __restrict__ part) {
  __shared__ float red[64];
  chi2_slots_block(pose, nullptr, lm, meas, info, ll_rk, o_meas, o_info, K, R, RB, kind, delta, part, red);
}

}  // namespace

// Scratch floats: two partials a block, C = ceil(R / RB) chunks of
// ceil(K / 32) pose ranges.
extern "C" long long soa_chi2_scratch(int K, int R, int RB) {
  return 2LL * ((R + RB - 1) / RB) * ((K + POSE_GROUP - 1) / POSE_GROUP);
}

// RB slots a block in G slot groups (warps). Launches on `stream`; returns
// cudaGetLastError() (0 = ok).
extern "C" int soa_chi2_launch(const float* pose, const float* lm, const float* meas, const float* info,
                               const int* ll_rk, const float* o_meas, const float* o_info, int K, int R, int RB,
                               int G, int robust_kind, float robust_delta, float* chi, float* scratch,
                               void* stream_ptr) {
  if (K <= 0 || R <= 0 || RB <= 0 || G <= 0 || G > MAX_SLOT_GROUPS) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((K + POSE_GROUP - 1) / POSE_GROUP, (R + RB - 1) / RB);
  const int nb = grid.x * grid.y;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  chi2_slots_kernel<<<grid, POSE_GROUP * G, 0, stream>>>(pose, lm, meas, info, ll_rk, o_meas, o_info, K, R, RB,
                                                         robust_kind, robust_delta, scratch);
  reduce2_kernel<<<1, 256, 0, stream>>>(scratch, nb, scratch + nb, nb, chi);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* slam_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
