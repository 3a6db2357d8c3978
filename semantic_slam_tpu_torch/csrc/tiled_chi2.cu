// K10: the LM trial objective (observation + odometry chain chi2) of a row
// range of poses, for Hopper (sm_90a).
//
// Replaces the TPU kernel semantic_slam_tpu/solver/pallas_tiled.py
// `_chi2_kernel` (wrapper `tiled_chi2`). Plain version: solver/soa_dist.py
// `chi2_plain`. It is K3 (soa_chi2.cu) with each row's chain successor
// supplied by the host (`succ`), and the range's sum only.
//
// What bounds it: bytes. Per slot it reads meas + info (12 floats), the
// landmark index and row; per row the pose, its successor, the chain
// measurement and information (57 floats). ~60 flops per slot and ~400 per
// chain edge are far below the card's rate.
//
// Design: K3's two launches, the first under a name of its own so that a
// trace tells K10 from K3. rows_chi2_slots (soa_common.cuh chi2_slots_block)
// spreads each row's R slots over the grid: (row ranges of 32, slot chunks of
// RB) with G warps a block (solver/kernels.py `lin_split` picks RB and G);
// warp 0 of each row range's first chunk also evaluates the chain edges of
// its 32 rows against succ[:, k], the range's last row included. A block
// sums its threads in a fixed tree and writes its two partials;
// reduce2_kernel then adds them in a fixed order into the device scalar, so a
// repeat gives the same bits. No atomics, no host sync.

#include "soa_common.cuh"

using namespace soa;

namespace {

__global__ void __launch_bounds__(POSE_GROUP * MAX_SLOT_GROUPS)
rows_chi2_slots(const float* __restrict__ pose, const float* __restrict__ succ, const float* __restrict__ lm,
                const float* __restrict__ meas, const float* __restrict__ info, const int* __restrict__ ll_rk,
                const float* __restrict__ o_meas, const float* __restrict__ o_info, int Kl, int R, int RB, int kind,
                float delta, float* __restrict__ part) {
  __shared__ float red[64];
  chi2_slots_block(pose, succ, lm, meas, info, ll_rk, o_meas, o_info, Kl, R, RB, kind, delta, part, red);
}

}  // namespace

// Scratch floats: two partials a block, C = ceil(R / RB) chunks of
// ceil(Kl / 32) row ranges.
extern "C" long long tiled_chi2_scratch(int Kl, int R, int RB) {
  return 2LL * ((R + RB - 1) / RB) * ((Kl + POSE_GROUP - 1) / POSE_GROUP);
}

// RB slots a block in G slot groups (warps). Two launches on `stream`;
// returns cudaGetLastError() (0 = ok).
extern "C" int tiled_chi2_launch(const float* pose, const float* succ, const float* lm, const float* meas,
                                 const float* info, const int* ll_rk, const float* o_meas, const float* o_info, int Kl,
                                 int R, int RB, int G, int robust_kind, float robust_delta, float* chi, float* scratch,
                                 void* stream_ptr) {
  if (Kl <= 0 || R <= 0 || RB <= 0 || G <= 0 || G > MAX_SLOT_GROUPS || !succ) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((Kl + POSE_GROUP - 1) / POSE_GROUP, (R + RB - 1) / RB);
  const int nb = grid.x * grid.y;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  rows_chi2_slots<<<grid, POSE_GROUP * G, 0, stream>>>(pose, succ, lm, meas, info, ll_rk, o_meas, o_info, Kl, R, RB,
                                                       robust_kind, robust_delta, scratch);
  reduce2_kernel<<<1, 256, 0, stream>>>(scratch, nb, scratch + nb, nb, chi);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* slam_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
