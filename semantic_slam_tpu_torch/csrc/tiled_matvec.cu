// K8 and K9: the two halves of the Schur-reduced matvec over a row range of
// poses, for Hopper (sm_90a).
//
// Replaces the TPU kernels semantic_slam_tpu/solver/pallas_tiled.py
// `_mv_fwd_kernel` (K8, entry point tiled_mv_fwd_launch, wrapper
// `tiled_mv_fwd`) and `_mv_bwd_kernel` (K9, tiled_mv_bwd_launch, wrapper
// `tiled_mv_bwd`). Plain versions: solver/soa_dist.py `mv_fwd_plain` and
// `mv_bwd_plain`. They are K4's matvec halves (soa_solve.cu) as launches of
// their own, with the host between them:
//
//   K8: Oa = O' (-x_t + v x x_r) per slot (written out), and
//       T = sum Rt^T Oa per landmark over the range's slots   [L,3]
//   (host: T summed over all ranges, z = A^-1 T)
//   K9: u = sum_r Jp^T (Oa - O' Rt z) + Hii x + Hij xj        [6,Kl]
//       vj = Hij^T x + Hjj xj, NOT shifted to pose k+1        [6,Kl]
//   (host: u and vj summed over all ranges, u += shift_down(vj))
//
// x is the masked direction of the range's rows and xj that of each row's
// successor, both from the host (the successor of the range's last row is
// the next range's first).
//
// What bounds them: bytes. Per slot K8 reads v + O' (12 floats) and writes
// Oa (3), its landmark pass reads Oa, Rt and the CSR back; per slot K9 reads
// v, O', Oa and z, per row Rt, x, xj and the three chain blocks (9 + 12 +
// 108 floats) and writes u and vj (12). Arithmetic is ~40 flops per slot and
// ~300 per row.
//
// Design: K8 is one thread per slot (rows_mvf_slot) and then one warp per
// landmark walking the range's landmark CSR in a fixed order
// (rows_mvf_lm, the mv_fwd_landmark_warp pattern); K9 is one thread per row
// walking its R slots (mv_bwd_slots) and adding the chain products. No
// atomics: the results are the same on every run. No host sync.

#include "soa_common.cuh"

using namespace soa;

namespace {

constexpr int BLOCK = 128;

__global__ void __launch_bounds__(BLOCK)
rows_mvf_slot(const float* __restrict__ v, const float* __restrict__ Ow, const float* __restrict__ x, int Kl, int E,
              float* __restrict__ Oa) {
  const int e = blockIdx.x * BLOCK + threadIdx.x;
  if (e >= E) return;
  const int k = e % Kl;
  const V3 xt = load_v3(x, Kl, k), xr = load_v3(x + 3 * Kl, Kl, k);
  store_v3(Oa, E, e, mv_fwd_slot(v, Ow, E, e, xt, xr));
}

// one warp per landmark: T [L,3] over the range's slots
__global__ void __launch_bounds__(BLOCK)
rows_mvf_lm(const float* __restrict__ Rt, const float* __restrict__ Oa, const int* __restrict__ lm_slots,
            const int* __restrict__ lm_start, int L, int Kl, int E, float* __restrict__ T) {
  const int l = (blockIdx.x * BLOCK + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (l >= L) return;  // whole warps leave together
  const V3 t = mv_fwd_landmark_warp(Rt, Oa, lm_slots, lm_start[l], lm_start[l + 1], Kl, E, lane);
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) T[3 * l + c] = t.v[c];
  }
}

__global__ void __launch_bounds__(BLOCK)
rows_mvb_pose(const float* __restrict__ v, const float* __restrict__ Ow, const float* __restrict__ Rt,
              const float* __restrict__ Oa, const float* __restrict__ z, const int* __restrict__ ll_rk,
              const float* __restrict__ x, const float* __restrict__ xj, const float* __restrict__ Hii,
              const float* __restrict__ Hij, const float* __restrict__ Hjj, int Kl, int R, float* __restrict__ u,
              float* __restrict__ vj) {
  const int k = blockIdx.x * BLOCK + threadIdx.x;
  if (k >= Kl) return;
  float xm[6], xn[6], uk[6], vk[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 6; ++i) { xm[i] = x[i * Kl + k]; xn[i] = xj[i * Kl + k]; }
  mv_bwd_slots(v, Ow, Rt, Oa, z, ll_rk, Kl, R, k, uk);
  m66_vec_acc(Hii, Kl, k, xm, uk);
  m66_vec_acc(Hij, Kl, k, xn, uk);
  m66T_vec_acc(Hij, Kl, k, xm, vk);
  m66_vec_acc(Hjj, Kl, k, xn, vk);
#pragma unroll
  for (int i = 0; i < 6; ++i) { u[i * Kl + k] = uk[i]; vj[i * Kl + k] = vk[i]; }
}

}  // namespace

// K8. Launches on `stream`; returns cudaGetLastError() (0 = ok).
extern "C" int tiled_mv_fwd_launch(const float* v, const float* Ow, const float* Rt, const float* x,
                                   const int* lm_slots, const int* lm_start, int Kl, int R, int L, float* Oa,
                                   float* T, void* stream_ptr) {
  if (Kl <= 0 || R <= 0 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long E = static_cast<long long>(Kl) * R;
  rows_mvf_slot<<<static_cast<int>((E + BLOCK - 1) / BLOCK), BLOCK, 0, stream>>>(v, Ow, x, Kl,
                                                                                  static_cast<int>(E), Oa);
  const long long lanes = 32LL * L;
  rows_mvf_lm<<<static_cast<int>((lanes + BLOCK - 1) / BLOCK), BLOCK, 0, stream>>>(Rt, Oa, lm_slots, lm_start, L, Kl,
                                                                                    static_cast<int>(E), T);
  return static_cast<int>(cudaGetLastError());
}

// K9. Launches on `stream`; returns cudaGetLastError() (0 = ok).
extern "C" int tiled_mv_bwd_launch(const float* v, const float* Ow, const float* Rt, const float* Oa, const float* z,
                                   const int* ll_rk, const float* x, const float* xj, const float* Hii,
                                   const float* Hij, const float* Hjj, int Kl, int R, float* u, float* vj,
                                   void* stream_ptr) {
  if (Kl <= 0 || R <= 0) return static_cast<int>(cudaErrorInvalidValue);
  rows_mvb_pose<<<(Kl + BLOCK - 1) / BLOCK, BLOCK, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      v, Ow, Rt, Oa, z, ll_rk, x, xj, Hii, Hij, Hjj, Kl, R, u, vj);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* slam_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
