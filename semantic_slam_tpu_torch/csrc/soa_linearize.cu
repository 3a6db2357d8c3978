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
// landmark index and row, and writes v + O' (12 floats); per pose K2
// reads the pose, its successor, the chain measurement and information (50
// floats) and writes the chain blocks and gradients (120 floats), and K1
// reads them back and writes gp, diag and Rt (51 floats). The arithmetic
// (~230 flops per slot, ~3k per chain edge) is far below the card's rate.
//
// Design, no float atomics, no host sync:
//   K2 chain_kernel: one thread per pose k linearizes chain edge k -> k+1
//      (row K-1 wraps to pose 0 and carries zero information) and writes
//      Hii/Hij/Hjj, g_i, g_j and a per-block chi2 partial; reduce2_kernel
//      adds the partials in a fixed order into the chain's chi2 scalar.
//   K1, two launches. A pose's R slots are spread over the grid, so that
//      the grid fills the card at the fixed-lag session's K=512 as at K=4096
//      (one thread a pose walking all R slots left 4 blocks at K=512):
//   lin_slots_kernel: grid (pose ranges of 32, slot chunks of RB), G warps
//      a block (solver/kernels.py `lin_split` picks RB and G from K, R and
//      the card's SM count). Thread (lane, g) walks its pose's slots
//      r = r0 + g, r0 + g + G, ... of the block's chunk: residual, robust rho
//      and IRLS weight, v and O' out, and the pose's gradient and 6x6
//      diagonal quadrants summed in registers. The G groups' sums meet in
//      shared memory in the order g = 0..G-1 and each chunk's sums go to
//      scratch [C, 33, K]; chunk 0 writes Rt.
//   lin_fold_kernel, three block roles: one warp per landmark walks its
//      slots in the fixed order of the landmark CSR (SoAEdges.lm_slots /
//      lm_start), computes each slot's terms Rt^T O'r and Rt^T O' Rt from
//      the inputs and sums them into gl and Hll (the CSR holds only the real
//      slots, an eighth of R*K at the sessions' graphs, so this reads less
//      than a per-slot scratch array would cost to write); one thread per
//      pose and output channel adds the C chunk sums in the order
//      c = 0..C-1 plus the chain's i-side of pose k and j-side of pose k-1
//      (the TPU wrapper's `gi + shift_down(gj)` and
//      `Hii + shift_down(Hjj)`) into gp and diag; one block adds the slot
//      blocks' chi2 partials in index order and the chain's chi2 into the
//      total.
// Every sum has a fixed order, so a repeat gives the same bits. Empty slots
// have zero information, so everything they add is exactly 0.

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

constexpr int FOLD_BLOCK = 128;
constexpr int FOLD_OUT = 42;  // gp (6) and diag (36) channels of a pose

__global__ void __launch_bounds__(POSE_GROUP * MAX_SLOT_GROUPS)
lin_slots_kernel(const float* __restrict__ pose, const float* __restrict__ lm, const float* __restrict__ meas,
                 const float* __restrict__ info, const int* __restrict__ ll_rk, int K, int R, int RB, int kind,
                 float delta, float* __restrict__ v_out, float* __restrict__ Ow_out, float* __restrict__ Rt_out,
                 float* __restrict__ pose_part, float* __restrict__ chi_part) {
  __shared__ float part[MAX_SLOT_GROUPS * POSE_PART * POSE_GROUP];
  __shared__ float red[32];
  const int G = blockDim.x >> 5, lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int k0 = blockIdx.x * POSE_GROUP, k = k0 + lane, c = blockIdx.y;
  const int r0 = c * RB, r1 = min(R, r0 + RB);
  ObsPose o = obs_pose_zero();
  if (k < K) {
    V3 t;
    Q4 q;
    load_pose(pose, K, k, t, q);
    const M3 Rt = rotmat(qconj(q));
    if (c == 0 && g == 0) store_m3(Rt_out, K, k, Rt);
    o = obs_slot_group_linearize(Rt, t, lm, meas, info, ll_rk, K, R * K, k, r0, r1, g, G, kind, delta, v_out,
                                 Ow_out);
  }
  pose_part_store(o, part + g * POSE_PART * POSE_GROUP + lane, POSE_GROUP);
  float chi[1] = {o.chi};
  block_sum<1>(chi, red);  // its barrier also publishes part[]
  for (int i = threadIdx.x; i < POSE_PART * POSE_GROUP; i += blockDim.x) {
    const int ch = i / POSE_GROUP, q = i % POSE_GROUP;
    if (k0 + q >= K) continue;
    float s = 0.f;
    for (int gg = 0; gg < G; ++gg) s += part[(gg * POSE_PART + ch) * POSE_GROUP + q];
    pose_part[(static_cast<long long>(c) * POSE_PART + ch) * K + k0 + q] = s;
  }
  if (threadIdx.x == 0) chi_part[c * gridDim.x + blockIdx.x] = chi[0];
}

// blocks [0, n_lm): one warp per landmark; then n_fold blocks of one thread
// per (output channel, pose); the last block: the chi2 total
__global__ void __launch_bounds__(FOLD_BLOCK)
lin_fold_kernel(const float* __restrict__ pose, const float* __restrict__ lm, const float* __restrict__ meas,
                const float* __restrict__ info, const int* __restrict__ ll_rk, const int* __restrict__ lm_slots,
                const int* __restrict__ lm_start, int K, int R, int L, int kind, float delta,
                const float* __restrict__ pose_part, int C,
                const float* __restrict__ gi, const float* __restrict__ Hii, const float* __restrict__ gj,
                const float* __restrict__ Hjj, const float* __restrict__ chi_part, int n_chi,
                const float* __restrict__ chi_chain, int n_lm, int n_fold, float* __restrict__ gl,
                float* __restrict__ Hll, float* __restrict__ gp, float* __restrict__ diag, float* __restrict__ chi) {
  const int b = blockIdx.x;
  if (b < n_lm) {
    const int l = (b * FOLD_BLOCK + threadIdx.x) >> 5, lane = threadIdx.x & 31;
    if (l >= L) return;  // whole warps leave together
    float acc[12];
    landmark_lin_warp(pose, lm, meas, info, ll_rk, lm_slots, lm_start[l], lm_start[l + 1], K, R * K, kind, delta,
                      lane, acc);
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < 3; ++i) gl[3 * l + i] = acc[i];
#pragma unroll
      for (int i = 0; i < 9; ++i) Hll[9 * l + i] = acc[3 + i];
    }
    return;
  }
  if (b < n_lm + n_fold) {
    const long long t = static_cast<long long>(b - n_lm) * FOLD_BLOCK + threadIdx.x;
    if (t >= static_cast<long long>(FOLD_OUT) * K) return;
    const int o = static_cast<int>(t / K), k = static_cast<int>(t % K);
    const int ch = o < 6 ? o : diag_part_channel((o - 6) / 6, (o - 6) % 6);
    float s = 0.f;
    for (int c = 0; c < C; ++c) s += pose_part[(static_cast<long long>(c) * POSE_PART + ch) * K + k];
    // gp = gp_obs + gi[k] + gj[k-1];  diag = diag_obs + Hii[k] + Hjj[k-1]
    const float* side_i = o < 6 ? gi : Hii;
    const float* side_j = o < 6 ? gj : Hjj;
    const int oc = o < 6 ? o : o - 6;
    s += side_i[oc * K + k];
    if (k > 0) s += side_j[oc * K + k - 1];
    (o < 6 ? gp : diag)[oc * K + k] = s;
    return;
  }
  __shared__ float red[32];
  float s[1] = {0.f};
  for (int i = threadIdx.x; i < n_chi; i += FOLD_BLOCK) s[0] += chi_part[i];
  block_sum<1>(s, red);
  if (threadIdx.x == 0) chi[0] = s[0] + chi_chain[0];
}

}  // namespace

// Scratch floats each entry point needs from the wrapper: K2's block
// partials; K1's chunk sums [C, 33, K] and slot blocks' chi2 partials, with
// C = ceil(R / RB).
extern "C" long long soa_chain_lin_scratch(int K) { return (K + BLOCK - 1) / BLOCK; }
extern "C" long long soa_obs_lin_scratch(int K, int R, int RB) {
  const long long C = (R + RB - 1) / RB, npr = (K + POSE_GROUP - 1) / POSE_GROUP;
  return C * POSE_PART * K + C * npr;
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

// K1, given K2's outputs, with RB slots a block in G slot groups (warps).
// Two launches on `stream`; returns cudaGetLastError() (0 = ok).
extern "C" int soa_obs_lin_launch(const float* pose, const float* lm, const float* meas, const float* info,
                                  const int* ll_rk, const int* lm_slots, const int* lm_start, const float* Hii,
                                  const float* Hjj, const float* gi, const float* gj, const float* chi_chain, int K,
                                  int R, int L, int RB, int G, int robust_kind, float robust_delta, float* v,
                                  float* Ow, float* Rt, float* gp, float* diag, float* gl, float* Hll, float* chi,
                                  float* scratch, void* stream_ptr) {
  if (K <= 0 || R <= 0 || L <= 0 || RB <= 0 || G <= 0 || G > MAX_SLOT_GROUPS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int C = (R + RB - 1) / RB, npr = (K + POSE_GROUP - 1) / POSE_GROUP;
  float* pose_part = scratch;
  float* chi_part = pose_part + static_cast<long long>(C) * POSE_PART * K;
  lin_slots_kernel<<<dim3(npr, C), POSE_GROUP * G, 0, stream>>>(pose, lm, meas, info, ll_rk, K, R, RB, robust_kind,
                                                                robust_delta, v, Ow, Rt, pose_part, chi_part);
  const int n_lm = (32 * L + FOLD_BLOCK - 1) / FOLD_BLOCK;
  const int n_fold = static_cast<int>((static_cast<long long>(FOLD_OUT) * K + FOLD_BLOCK - 1) / FOLD_BLOCK);
  lin_fold_kernel<<<n_lm + n_fold + 1, FOLD_BLOCK, 0, stream>>>(
      pose, lm, meas, info, ll_rk, lm_slots, lm_start, K, R, L, robust_kind, robust_delta, pose_part, C, gi, Hii, gj,
      Hjj, chi_part, C * npr, chi_chain, n_lm, n_fold, gl, Hll, gp, diag, chi);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* slam_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
