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
// (rows_mvf_lm, the mv_fwd_landmark_warp pattern). K9 is K4's phase-c body
// (soa_common.cuh mv_bwd_slot_group): a block of 32 rows (one a lane) x 8
// slot groups (one a warp), each thread walking its row's slots r = g, g + 8,
// ... with every warp load coalesced over 32 consecutive rows; the 8 partial
// 6-vectors of a row are summed through shared memory in a fixed order, and
// the four 6x6 chain products are split over the block one output row a
// thread. One thread walking all of a row's slots would be R dependent
// gathers in a row (R=32 on the tiled session's path) on Kl threads; here a
// thread walks R/8 of them and the block keeps 8 warps of loads in flight.
// No atomics: the results are the same on every run. No host sync.

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

// K9: one block per POSE_GROUP rows, MVB_G slot groups (warps) per block
constexpr int MVB_G = 8;

__global__ void __launch_bounds__(POSE_GROUP * MVB_G)
rows_mvb_pose(const float* __restrict__ v, const float* __restrict__ Ow, const float* __restrict__ Rt,
              const float* __restrict__ Oa, const float* __restrict__ z, const int* __restrict__ ll_rk,
              const float* __restrict__ x, const float* __restrict__ xj, const float* __restrict__ Hii,
              const float* __restrict__ Hij, const float* __restrict__ Hjj, int Kl, int R, float* __restrict__ u,
              float* __restrict__ vj) {
  constexpr int NT = POSE_GROUP * MVB_G;
  __shared__ float part[MVB_G * 6 * POSE_GROUP];
  __shared__ float chain[24][POSE_GROUP];
  __shared__ float xs[12][POSE_GROUP];  // x in rows 0-5, xj in rows 6-11
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int k0 = blockIdx.x * POSE_GROUP, k = k0 + lane;
  const bool on = k < Kl;
  for (int t = threadIdx.x; t < 12 * POSE_GROUP; t += NT) {
    const int c = t / POSE_GROUP, kq = k0 + t % POSE_GROUP;
    xs[c][t % POSE_GROUP] = kq < Kl ? (c < 6 ? x[c * Kl + kq] : xj[(c - 6) * Kl + kq]) : 0.f;
  }
  __syncthreads();
  float us[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (on) {
    mv_bwd_slot_group(v, Ow, Oa, ll_rk, z, load_m3(Rt, Kl, k), R * Kl, Kl, k, R, g, MVB_G,
                      LoadLdg{}, us);
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) part[(g * 6 + i) * POSE_GROUP + lane] = us[i];
  // the chain's four products, one output row a thread: Hii x and Hij xj to
  // u, Hij^T x and Hjj xj to vj
  for (int j = g; j < 24; j += MVB_G) {
    const int b = j / 6, i = j % 6;
    const float* M = b == 0 ? Hii : b == 3 ? Hjj : Hij;
    const float* xv = (b == 0 || b == 2) ? &xs[0][lane] : &xs[6][lane];
    chain[j][lane] = on ? m66_row(M, Kl, k, i, b == 2, xv, POSE_GROUP) : 0.f;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 12 * POSE_GROUP; t += NT) {
    const int o = t / POSE_GROUP, q = t % POSE_GROUP, kq = k0 + q;
    if (kq >= Kl) continue;
    if (o < 6) u[o * Kl + kq] = group_total(part, MVB_G, o, q) + chain[o][q] + chain[6 + o][q];
    else vj[(o - 6) * Kl + kq] = chain[12 + o - 6][q] + chain[18 + o - 6][q];
  }
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
  rows_mvb_pose<<<(Kl + POSE_GROUP - 1) / POSE_GROUP, POSE_GROUP * MVB_G, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      v, Ow, Rt, Oa, z, ll_rk, x, xj, Hii, Hij, Hjj, Kl, R, u, vj);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* slam_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
