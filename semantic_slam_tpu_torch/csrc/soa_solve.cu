// K4: the damped Schur-reduced PCG solve and landmark back-substitution in one
// persistent launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel semantic_slam_tpu/solver/pallas_cg.py
// `_solve_kernel` (wrapper `resident_solve`), jacobi preconditioner, with its
// fixed-lag prior branch. Plain version: solver/ellk_soa.py `soa_schur_step`.
//
//   A^-1 = inv33((Hll + lam I) lmf + I (1 - lmf))   per landmark
//   M^-1 = inv66((diag + lam I) pf + I (1 - pf))    per pose
//   b    = -(gp - W A^-1 (gl lmf)) pf
//   n_steps of PCG on (Hpp - W A^-1 W^T [+ Sel Hp Sel^T] + lam I) under the
//   `active` mask
//   db   = A^-1 (-gl lmf - W^T dp) lmf
//
// The fixed-lag prior (PB > 0): Hp [6PB, 6PB] is the dense information over
// the PB boundary poses pidx[b]; its gradient, diagonal blocks and landmark
// part are already inside gp, diag, gl and Hll, so only the matvec changes:
// u[:, pidx[b]] += row block b of Hp times the masked direction gathered at
// every slot's pose. The product y = Hp xg (6PB rows of 6PB FMAs) is formed
// in phase b, after the barrier that completes p, one row per thread of the
// grid's last 6PB threads, beside the landmark work; in phase c the thread that
// owns pose k adds y's rows of the slots with pidx[b] == k, before lam x and
// the mask. No extra barrier, no atomics, and a repeated index (the padded
// slots' 0) adds in the owner's loop. A first version formed the product in
// phase c on the owner's thread: with the padded slots all on pose 0 that
// thread ran PB * 6 * 6PB dependent FMAs a step alone, which doubled the
// launch at K=4096. Hp (9 KB at PB = 8) stays in L1/L2.
//
// What bounds it: latency, then bytes. Each CG step streams v, O' (12 floats
// per slot), Rt and the chain blocks (9 + 108 floats per pose) once and the
// CG vectors a few times; at K=4096, R=4 that is ~3 MB a step, which the
// 50 MB L2 holds, against ~1.5 Mflop. Each step also needs four grid-wide
// barriers (the two matvec halves and two dot products).
//
// Design: one cooperative launch (cudaLaunchCooperativeKernel, the grid sized
// to what is co-resident); every phase is a grid-stride loop over slots,
// landmarks (one warp each, through the landmark CSR) or poses, and a
// grid.sync() separates the phases:
//   a. per slot: Oa = O' (-x_t + v x x_r)                      (K8, first half)
//   b. per landmark: z = A^-1 sum Rt^T Oa                      (K8, second half)
//   c. per pose: Ap = Jp^T (Oa - O' Rt z) + chain + lam x; p.Ap (K9)
//   d. per pose: x, r, z = M^-1 r; r.z and r.r
// Dot products are per-block partials (fixed tree) that every block then adds
// in the same fixed order, so all blocks agree bit for bit, a step's
// `active` test is uniform, and the run repeats exactly on the same card. The
// step p = z + beta p is folded into the next step's phase a (double-buffered
// p). Once a step is inactive every later one is too (r no longer changes),
// so the loop leaves early with the result of the masked fixed-count loop.
// Nothing is fetched by the host.

#include <cooperative_groups.h>

#include "soa_common.cuh"

namespace cg = cooperative_groups;
using namespace soa;

namespace {

constexpr int BLOCK = 256;
constexpr int NP = 4;  // dot-product partial slots per block: pAp, rz, rr, bb

struct SolveArgs {
  const float *v, *Ow, *Rt, *Hii, *Hij, *Hjj, *diag, *gp, *gl, *Hll, *lmf, *pf, *lam;
  const int *ll_rk, *lm_slots, *lm_start;
  const float* Hp;  // [6PB, 6PB] row-major, the fixed-lag prior (PB = 0: none)
  const int* pidx;  // [PB]
  int PB;
  float* yp;  // [6PB] scratch: Hp times the gathered direction, per step
  float tol;
  int n_steps, K, R, L;
  float *dp, *db;
  float *Ainv, *y, *glm, *zl, *Minv, *x, *r, *z, *p0, *p1, *Ap, *Oa, *partials;
};

// sum of one partial slot over all blocks, the same fixed order in every block
__device__ __forceinline__ float grid_total(const float* partials, int slot, float* bcast) {
  if (threadIdx.x < 32) {
    float s = 0.f;
    for (int b = threadIdx.x; b < gridDim.x; b += 32) s += __ldcg(partials + b * NP + slot);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (threadIdx.x == 0) *bcast = s;
  }
  __syncthreads();
  const float out = *bcast;
  __syncthreads();
  return out;
}

__device__ __forceinline__ void load6_cg(const float* a, int K, int k, float* out) {
#pragma unroll
  for (int i = 0; i < 6; ++i) out[i] = __ldcg(a + i * K + k);
}

// row r of the prior's product y = Hp xg, xg the masked p gathered at every
// slot's pose (p is complete: the caller runs after the barrier that ends
// phase a)
__device__ __forceinline__ void prior_product(const SolveArgs& A, const float* pc, int K, int r) {
  const int n = 6 * A.PB;
  const float* row = A.Hp + static_cast<long long>(r) * n;
  float s = 0.f;
  for (int c = 0; c < A.PB; ++c) {
    const int kc = __ldg(A.pidx + c);
    const float fc = __ldg(A.pf + kc);
#pragma unroll
    for (int d = 0; d < 6; ++d) s += __ldg(row + 6 * c + d) * (__ldcg(pc + d * K + kc) * fc);
  }
  A.yp[r] = s;
}

// u (pose k's matvec row) += y's rows of the slots b with pidx[b] == k (y is
// complete: the caller runs after the barrier that ends phase b)
__device__ __forceinline__ void prior_add(const SolveArgs& A, int k, float* u) {
  for (int b = 0; b < A.PB; ++b) {
    if (__ldg(A.pidx + b) != k) continue;
#pragma unroll
    for (int i = 0; i < 6; ++i) u[i] += __ldcg(A.yp + 6 * b + i);
  }
}

__global__ void __launch_bounds__(BLOCK) solve_kernel(SolveArgs A) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float smem[32 * 2];
  __shared__ float bcast;
  const int K = A.K, R = A.R, L = A.L, E = K * R;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x, nthr = gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31, gwarp = tid >> 5, nwarps = nthr >> 5;
  const float lam = *A.lam;

  // ---- set-up: A^-1, y = A^-1 (gl lmf), M^-1
  for (int l = tid; l < L; l += nthr) {
    const float f = A.lmf[l];
    M3 H;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) H.m[i][j] = (A.Hll[9 * l + 3 * i + j] + (i == j ? lam : 0.f)) * f + (i == j ? 1.f - f : 0.f);
    const M3 Ai = inv33(H);
#pragma unroll
    for (int c = 0; c < 9; ++c) A.Ainv[9 * l + c] = Ai.m[c / 3][c % 3];
    const V3 g = scale(load_row3(A.gl, l), f);
    const V3 yy = mv(Ai, g);
#pragma unroll
    for (int c = 0; c < 3; ++c) { A.glm[3 * l + c] = g.v[c]; A.y[3 * l + c] = yy.v[c]; }
  }
  for (int k = tid; k < K; k += nthr) {
    const float f = A.pf[k];
    float Md[36], Mi[36];
#pragma unroll
    for (int c = 0; c < 36; ++c) {
      const bool d = c / 6 == c % 6;
      Md[c] = (A.diag[c * K + k] + (d ? lam : 0.f)) * f + (d ? 1.f - f : 0.f);
    }
    inv66(Md, Mi);
#pragma unroll
    for (int c = 0; c < 36; ++c) A.Minv[c * K + k] = Mi[c];
  }
  grid.sync();

  // ---- right-hand side and CG start: x = 0, r = b, z = M^-1 r, p = z
  {
    float part[2] = {0.f, 0.f};  // r.z, b.b
    for (int k = tid; k < K; k += nthr) {
      const M3 Rtk = load_m3(A.Rt, K, k);
      float c6[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int r = 0; r < R; ++r) {
        const int e = r * K + k;
        const V3 m = mv(load_m3(A.Ow, E, e), mv(Rtk, load_row3_cg(A.y, A.ll_rk[e])));
        const V3 vm = cross(load_v3(A.v, E, e), m);
#pragma unroll
        for (int i = 0; i < 3; ++i) { c6[i] -= m.v[i]; c6[i + 3] -= vm.v[i]; }
      }
      const float f = A.pf[k];
      float b[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        b[i] = -(A.gp[i * K + k] - c6[i]) * f;
        A.x[i * K + k] = 0.f;
        A.r[i * K + k] = b[i];
        part[1] += b[i] * b[i];
      }
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < 6; ++j) s += A.Minv[(i * 6 + j) * K + k] * b[j];
        s *= f;
        A.z[i * K + k] = s;
        A.p0[i * K + k] = s;
        part[0] += b[i] * s;
      }
    }
    block_sum<2>(part, smem);
    if (threadIdx.x == 0) {
      A.partials[blockIdx.x * NP + 1] = part[0];
      A.partials[blockIdx.x * NP + 3] = part[1];
    }
  }
  grid.sync();
  float rz = grid_total(A.partials, 1, &bcast);
  const float bb = grid_total(A.partials, 3, &bcast);
  const float b2 = fmaxf(bb, 1e-30f);
  float rr = bb, beta = 0.f;

  for (int it = 0; it < A.n_steps; ++it) {
    if (!(rr > A.tol * b2)) break;  // inactive from here on: x stays as it is
    float* pc = (it & 1) ? A.p1 : A.p0;
    const float* pprev = (it & 1) ? A.p0 : A.p1;

    // a. per slot (K8 first half); p = z + beta p_prev is formed here
    for (int e = tid; e < E; e += nthr) {
      const int k = e % K;
      float pk[6];
      if (it == 0) {
        load6_cg(pc, K, k, pk);
      } else {
        float zk[6], pp[6];
        load6_cg(A.z, K, k, zk);
        load6_cg(pprev, K, k, pp);
#pragma unroll
        for (int i = 0; i < 6; ++i) pk[i] = zk[i] + beta * pp[i];
        if (e < K)
#pragma unroll
          for (int i = 0; i < 6; ++i) pc[i * K + k] = pk[i];
      }
      const float f = A.pf[k];
      const V3 Oa = mv_fwd_slot(A.v, A.Ow, E, e, v3(pk[0] * f, pk[1] * f, pk[2] * f), v3(pk[3] * f, pk[4] * f, pk[5] * f));
      store_v3(A.Oa, E, e, Oa);
    }
    grid.sync();

    // b. per landmark (K8 second half): z_l = A^-1 sum Rt^T Oa
    for (int l = gwarp; l < L; l += nwarps) {
      const V3 T = mv_fwd_landmark_warp(A.Rt, A.Oa, A.lm_slots, A.lm_start[l], A.lm_start[l + 1], K, E, lane);
      if (lane == 0) {
        M3 Ai;
#pragma unroll
        for (int c = 0; c < 9; ++c) Ai.m[c / 3][c % 3] = __ldcg(A.Ainv + 9 * l + c);
        const V3 zz = mv(Ai, T);
#pragma unroll
        for (int c = 0; c < 3; ++c) A.zl[3 * l + c] = zz.v[c];
      }
    }
    // the prior's product on the grid's last threads, whose warps come last
    // in the landmark loop
    if (nthr - 1 - tid < 6 * A.PB) prior_product(A, pc, K, nthr - 1 - tid);
    grid.sync();

    // c. per pose (K9): Ap and p.Ap
    {
      float pap[1] = {0.f};
      for (int k = tid; k < K; k += nthr) {
        float pk[6], xm[6], xn[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, xp[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        const float f = A.pf[k];
        load6_cg(pc, K, k, pk);
#pragma unroll
        for (int i = 0; i < 6; ++i) xm[i] = pk[i] * f;
        if (k + 1 < K) {
          load6_cg(pc, K, k + 1, xn);
          const float fn = A.pf[k + 1];
#pragma unroll
          for (int i = 0; i < 6; ++i) xn[i] *= fn;
        }
        if (k > 0) {
          load6_cg(pc, K, k - 1, xp);
          const float fp = A.pf[k - 1];
#pragma unroll
          for (int i = 0; i < 6; ++i) xp[i] *= fp;
        }
        float u[6];
        mv_bwd_pose(A.v, A.Ow, A.Rt, A.Oa, A.zl, A.ll_rk, A.Hii, A.Hij, A.Hjj, K, R, k, xm, xn, xp, u);
        if (A.PB > 0) prior_add(A, k, u);
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          const float ap = (u[i] + lam * xm[i]) * f;
          A.Ap[i * K + k] = ap;
          pap[0] += pk[i] * ap;
        }
      }
      block_sum<1>(pap, smem);
      if (threadIdx.x == 0) A.partials[blockIdx.x * NP + 0] = pap[0];
    }
    grid.sync();
    const float alpha = rz / fmaxf(grid_total(A.partials, 0, &bcast), 1e-30f);

    // d. per pose: x += alpha p, r -= alpha Ap, z = M^-1 r
    {
      float part[2] = {0.f, 0.f};  // r.z, r.r
      for (int k = tid; k < K; k += nthr) {
        float pk[6], rk[6];
        load6_cg(pc, K, k, pk);
        const float f = A.pf[k];
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          A.x[i * K + k] += alpha * pk[i];
          rk[i] = A.r[i * K + k] - alpha * A.Ap[i * K + k];
          A.r[i * K + k] = rk[i];
          part[1] += rk[i] * rk[i];
        }
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < 6; ++j) s += A.Minv[(i * 6 + j) * K + k] * rk[j];
          s *= f;
          A.z[i * K + k] = s;
          part[0] += rk[i] * s;
        }
      }
      block_sum<2>(part, smem);
      if (threadIdx.x == 0) {
        A.partials[blockIdx.x * NP + 1] = part[0];
        A.partials[blockIdx.x * NP + 2] = part[1];
      }
    }
    grid.sync();
    const float rz_new = grid_total(A.partials, 1, &bcast);
    rr = grid_total(A.partials, 2, &bcast);
    beta = rz_new / fmaxf(rz, 1e-30f);
    rz = rz_new;
  }

  // ---- back-substitution: dp = x pf; db = A^-1 (-gl lmf - W^T dp) lmf
  for (int e = tid; e < E; e += nthr) {
    const int k = e % K;
    float xk[6];
    load6_cg(A.x, K, k, xk);
    const float f = A.pf[k];
#pragma unroll
    for (int i = 0; i < 6; ++i) xk[i] *= f;
    if (e < K)
#pragma unroll
      for (int i = 0; i < 6; ++i) A.dp[i * K + k] = xk[i];
    store_v3(A.Oa, E, e, mv_fwd_slot(A.v, A.Ow, E, e, v3(xk[0], xk[1], xk[2]), v3(xk[3], xk[4], xk[5])));
  }
  grid.sync();
  for (int l = gwarp; l < L; l += nwarps) {
    const V3 T = mv_fwd_landmark_warp(A.Rt, A.Oa, A.lm_slots, A.lm_start[l], A.lm_start[l + 1], K, E, lane);
    if (lane == 0) {
      M3 Ai;
#pragma unroll
      for (int c = 0; c < 9; ++c) Ai.m[c / 3][c % 3] = __ldcg(A.Ainv + 9 * l + c);
      const float f = A.lmf[l];
      const V3 d = scale(mv(Ai, sub(neg(load_row3_cg(A.glm, l)), T)), f);
#pragma unroll
      for (int c = 0; c < 3; ++c) A.db[3 * l + c] = d.v[c];
    }
  }
}

// co-resident blocks of solve_kernel on the current device (cached per device)
int max_coresident_blocks() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, solve_kernel, BLOCK, 0) != cudaSuccess) return 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
    cached[dev] = per_sm * sms;
  }
  return cached[dev];
}

}  // namespace

// Scratch floats the wrapper must provide for up to `max_blocks` blocks.
extern "C" long long soa_solve_scratch(int K, int R, int L, int PB, int max_blocks) {
  return 18LL * L + 72LL * K + 3LL * K * R + 6LL * PB + static_cast<long long>(NP) * max_blocks;
}

// Launches on `stream`; returns the CUDA error of the launch (0 = ok).
// `lam` is a device scalar; dp is [6, K], db is [L, 3]. PB = 0 runs without a
// prior (Hp and pidx are then not read).
extern "C" int soa_solve_launch(const float* v, const float* Ow, const float* Rt, const float* Hii, const float* Hij,
                                const float* Hjj, const float* diag, const float* gp, const float* gl,
                                const float* Hll, const float* lmf, const float* pf, const int* ll_rk,
                                const int* lm_slots, const int* lm_start, const float* lam, const float* Hp,
                                const int* pidx, int PB, float tol, int n_steps, int K, int R, int L, float* dp,
                                float* db, float* scratch, int max_blocks, void* stream_ptr) {
  // the prior's product takes 6PB threads of the grid, which has at least one block
  if (K <= 0 || R <= 0 || L <= 0 || PB < 0 || 6 * PB > BLOCK || max_blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int coresident = max_coresident_blocks();
  if (coresident <= 0) {
    const cudaError_t e = cudaGetLastError();
    return static_cast<int>(e != cudaSuccess ? e : cudaErrorInvalidConfiguration);
  }
  const long long E = static_cast<long long>(K) * R;
  const long long work = E > 32LL * L ? E : 32LL * L;
  long long blocks = (work + BLOCK - 1) / BLOCK;
  if (blocks > coresident) blocks = coresident;
  if (blocks > max_blocks) blocks = max_blocks;

  SolveArgs A;
  A.v = v; A.Ow = Ow; A.Rt = Rt; A.Hii = Hii; A.Hij = Hij; A.Hjj = Hjj; A.diag = diag; A.gp = gp; A.gl = gl;
  A.Hll = Hll; A.lmf = lmf; A.pf = pf; A.lam = lam; A.ll_rk = ll_rk; A.lm_slots = lm_slots; A.lm_start = lm_start;
  A.Hp = Hp; A.pidx = pidx; A.PB = PB;
  A.tol = tol; A.n_steps = n_steps; A.K = K; A.R = R; A.L = L; A.dp = dp; A.db = db;
  float* s = scratch;
  A.Ainv = s; s += 9LL * L;
  A.y = s; s += 3LL * L;
  A.glm = s; s += 3LL * L;
  A.zl = s; s += 3LL * L;
  A.Minv = s; s += 36LL * K;
  A.x = s; s += 6LL * K;
  A.r = s; s += 6LL * K;
  A.z = s; s += 6LL * K;
  A.p0 = s; s += 6LL * K;
  A.p1 = s; s += 6LL * K;
  A.Ap = s; s += 6LL * K;
  A.Oa = s; s += 3 * E;
  A.yp = s; s += 6LL * PB;
  A.partials = s;
  void* params[] = {&A};
  const cudaError_t err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(solve_kernel),
                                                      dim3(static_cast<unsigned>(blocks)), dim3(BLOCK), params, 0,
                                                      static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* slam_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
