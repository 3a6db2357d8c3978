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
// every slot's pose. The product y = Hp xg is formed in phase b, after the
// barrier that completes p, by the unit's last block after its landmark work
// (prior_product); in phase c the thread that finishes pose k's row adds y's
// rows of the slots with pidx[b] == k, before lam x and the mask. No extra
// unit barrier, no atomics, and a repeated index (the padded slots' 0) adds
// in a fixed order.

// What bounds it: latency. Each CG step streams v, O' (12 floats per slot),
// Rt and the chain blocks once and the CG vectors a few times (~1.3 MB at
// K=512, R=32) against ~0.4 Mflop; the four reductions of a step (the two
// matvec halves and two dot products) each need every block to wait for
// every other. So the design spreads the per-pose work (phase c: R
// dependent slot gathers per pose) over all of a block's threads, and at
// small graphs keeps the state in shared memory behind hardware cluster
// barriers. On an H100 a step takes ~9.9 us at K=512, R=32 in the cluster
// shape, ~5.3 of them barriers and reductions, and ~19 us at K=4096 in the
// grid shape (PERF.md; tools/kernel_times.py --split).

// Design. Every block owns a contiguous range of Kb poses (a multiple of
// POSE_GROUP) and those poses' slots; phases a, c and d touch only the own
// range, phase b (per landmark over the CSR), the pose k-1 / k+1 neighbours at
// a range's edges and the prior's gather read other blocks' data:
//   a. per pose: p = z + beta p; per slot: Oa = O' (-x_t + v x x_r)   (K8 first half)
//   b. per landmark, one warp: z_l = A^-1 sum Rt^T Oa                 (K8 second half)
//   c. per 32 poses x G slot groups: Ap = Jp^T (Oa - O' Rt z) + chain + lam x; p.Ap
//      (K9's body, soa_common.cuh mv_bwd_slot_group; the four 6x6 chain
//      products one row a thread)
//   d. per pose and channel: x, r; then z = M^-1 r; r.z and r.r
// Two launch shapes share these bodies (template on CLUSTER):
//   * the cluster: one thread-block cluster of up to 16 CTAs (non-portable
//     size) when a range's slots, pose blocks and the landmark z fit in shared
//     memory (solver/kernels.py `solve_shape` decides, from K, R, L and the
//     card's shared memory). Each CTA copies its range's v, O', ll_rk, Rt,
//     chain blocks (with pose k0-1's Hij/Hjj) and pf into shared memory with
//     cp.async once per launch; M^-1 and the CG vectors live there too.
//     Barriers are cluster.sync() (hardware). Other CTAs' Oa (phase b) and p
//     (the prior's gather) are read through distributed shared memory; what
//     every CTA needs is pushed instead, so that it reads it locally after
//     the barrier: z_l into every CTA's copy, a range's edge poses' p into
//     the neighbours' halos, each CTA's dot-product partials into every CTA.
//   * the grid: a cooperative launch of up to the co-resident block count for
//     larger graphs; the same ranges over device memory, grid.sync() and
//     per-block partials in device memory.
// Dot products are per-block partials (fixed tree) that every block adds in
// the same fixed order, so all blocks agree bit for bit, a step's `active`
// test is uniform, and the run repeats exactly on the same card. Once a step
// is inactive every later one is too (r no longer changes), so the loop
// leaves early with the result of the masked fixed-count loop. Nothing is
// fetched by the host.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include "soa_common.cuh"

namespace cg = cooperative_groups;
using namespace soa;

namespace {

constexpr int BLOCK = 512;               // threads a block
constexpr int G = BLOCK / POSE_GROUP;    // slot groups in phase c
constexpr int NP = 4;                    // dot-product partial slots: pAp, rz, rr, bb
constexpr int MAX_CLUSTER = 16;          // CTAs of the cluster shape (non-portable size)
constexpr int MAX_PRIOR_ROWS = 256;      // 6 PB, the threads the prior's product takes

struct SolveArgs {
  const float *v, *Ow, *Rt, *Hii, *Hij, *Hjj, *diag, *gp, *gl, *Hll, *lmf, *pf, *lam;
  const int *ll_rk, *lm_slots, *lm_start;
  const float* Hp;  // [6PB, 6PB] row-major, the fixed-lag prior (PB = 0: none)
  const int* pidx;  // [PB]
  int PB;
  float tol;
  int n_steps, K, R, L, Kb;  // Kb: poses a block
  float *dp, *db;
  // device scratch: landmark tables, the prior's product, per-block partials
  float *Ainv, *y, *glm, *zl, *yp, *partials;
  // the grid shape's per-pose and per-slot state (the cluster keeps it in shared memory)
  float *Minv, *x, *r, *z, *p, *Ap, *Oa;
};

// Where a block's own poses and slots live. Slot arrays: element (c, r) of the
// pose with local index kk at c*cs + r*rs + kk; pose arrays: (c, kk) at c*ps +
// kk; Hij and Hjj also hold pose k0-1: (c, kk) at c*hps + kk + hoff. The grid
// indexes device memory by the global pose (kb = 0), the cluster its shared
// memory by k - k0.
struct Loc {
  const float *v, *Ow, *Rt, *Hii, *Hij, *Hjj, *pf;
  const int* ll;
  float *Oa, *Minv, *x, *r, *z, *p, *Ap, *zl;
  int cs, rs, ps, hps, hoff, kb;
};

// The cluster shape's dynamic shared memory, in 4-byte words
struct ClusterLayout {
  int v, Ow, Oa, ll, Rt, Hii, Hij, Hjj, pf, Minv, x, r, z, p, Ap, zl, words;
  __host__ __device__ ClusterLayout(int Kb, int R, int L) {
    const int S = R * Kb;
    int o = 0;
    v = o; o += 3 * S;
    Ow = o; o += 9 * S;
    Oa = o; o += 3 * S;
    ll = o; o += S;
    Rt = o; o += 9 * Kb;
    Hii = o; o += 36 * Kb;
    Hij = o; o += 36 * (Kb + 1);
    Hjj = o; o += 36 * (Kb + 1);
    pf = o; o += Kb;
    Minv = o; o += 36 * Kb;
    x = o; o += 6 * Kb;
    r = o; o += 6 * Kb;
    z = o; o += 6 * Kb;
    p = o; o += 6 * Kb;
    Ap = o; o += 6 * Kb;
    zl = o; o += 3 * L;
    words = o;
  }
};

struct Shared {
  float part[G * 6 * POSE_GROUP];    // phase c's slot partials
  float chain[24][POSE_GROUP];       // phase c's chain rows
  float xs[6][POSE_GROUP + 2];       // the masked p of a chunk and its two neighbours
  float red[32 * 2];                 // block_sum
  float xg[MAX_PRIOR_ROWS];          // the prior's gathered direction
  float dots[NP][MAX_CLUSTER];       // cluster: every CTA's partials, pushed by each CTA
  float halo[2][6];                  // cluster: the masked p of poses k0-1 and k1, pushed by the neighbours
  float bcast;                       // grid: a total, from warp 0 to the block
};

template <bool CLUSTER>
struct Unit;

// sum over the blocks of one partial slot, `at(b)` block b's: every warp
// runs the same fixed tree, so every thread of every block gets the same bits
template <class At>
__device__ __forceinline__ float warp_total(int n, At at) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int b = lane; b < n; b += 32) s += at(b);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  return __shfl_sync(0xffffffffu, s, 0);
}

template <>
struct Unit<false> {  // the cooperative grid
  using Ld = LoadCg;
  cg::grid_group grid = cg::this_grid();
  __device__ void sync() { grid.sync(); }
  __device__ int rank() { return blockIdx.x; }
  __device__ int size() { return gridDim.x; }
  // a block's partial (valid in thread 0) into its slot; read after the next sync
  __device__ void publish(const SolveArgs& A, Shared&, int slot, float mine) {
    if (threadIdx.x == 0) A.partials[blockIdx.x * NP + slot] = mine;
  }
  // warp 0 sums the blocks' partials from device memory (one read per block
  // and block, not per warp) and hands the total to the block
  __device__ float gather(const SolveArgs& A, Shared& sh, int slot) {
    if (threadIdx.x < 32) {
      const float t = warp_total(size(), [&](int b) { return __ldcg(A.partials + b * NP + slot); });
      if (threadIdx.x == 0) sh.bcast = t;
    }
    __syncthreads();
    const float out = sh.bcast;
    __syncthreads();
    return out;
  }
  __device__ float p_at(const SolveArgs& A, const Loc&, int k, int c) { return __ldcg(A.p + c * A.K + k); }
  // the masked p of the neighbour k (k0-1 or k1) of the block's range
  __device__ float halo(const SolveArgs& A, const Loc&, Shared&, int k, int, int, int c) {
    return __ldcg(A.p + c * A.K + k) * __ldg(A.pf + k);
  }
  __device__ void push_halo(const SolveArgs&, const Loc&, Shared&, int, int) {}
  __device__ V3 oa_at(const SolveArgs& A, const Loc&, int e) { return load_v3_cg(A.Oa, A.K * A.R, e); }
  // z_l, valid in lane 0
  __device__ void put_zl(const SolveArgs& A, const Loc&, int l, const V3& zz) {
    if ((threadIdx.x & 31) == 0)
#pragma unroll
      for (int c = 0; c < 3; ++c) A.zl[3 * l + c] = zz.v[c];
  }
};

template <>
struct Unit<true> {  // one thread-block cluster
  using Ld = LoadPlain;
  cg::cluster_group cluster = cg::this_cluster();
  __device__ void sync() { cluster.sync(); }
  __device__ int rank() { return static_cast<int>(cluster.block_rank()); }
  __device__ int size() { return static_cast<int>(cluster.num_blocks()); }
  // a CTA's partial (valid in thread 0) into every CTA's dots[slot][rank]:
  // after the next sync each CTA sums its own copy, with no remote read
  __device__ void publish(const SolveArgs&, Shared& sh, int slot, float mine) {
    if (threadIdx.x < 32) {
      const float v = __shfl_sync(0xffffffffu, mine, 0);
      if (static_cast<int>(threadIdx.x) < size()) cluster.map_shared_rank(&sh.dots[slot][rank()], threadIdx.x)[0] = v;
    }
  }
  __device__ float gather(const SolveArgs&, Shared& sh, int slot) {
    return warp_total(size(), [&](int b) { return sh.dots[slot][b]; });
  }
  // the CTA that owns pose k, and k's index there (every CTA has the same layout)
  __device__ float p_at(const SolveArgs& A, const Loc& loc, int k, int c) {
    const int b = k / A.Kb;
    return cluster.map_shared_rank(loc.p, b)[c * loc.ps + k - b * A.Kb];
  }
  __device__ float halo(const SolveArgs&, const Loc&, Shared& sh, int k, int k0, int k1, int c) {
    return k == k0 - 1 ? sh.halo[0][c] : k == k1 ? sh.halo[1][c] : 0.f;
  }
  // the masked p of the range's first and last pose into the neighbours' halos
  __device__ void push_halo(const SolveArgs&, const Loc& loc, Shared& sh, int nk, int) {
    const int t = threadIdx.x;
    if (t >= 12) return;
    const int side = t / 6, c = t % 6, b = rank() + (side == 0 ? -1 : 1);
    if (b < 0 || b >= size()) return;
    const int kl = side == 0 ? 0 : nk - 1;
    cluster.map_shared_rank(&sh.halo[1 - side][c], b)[0] = loc.p[c * loc.ps + kl] * loc.pf[kl];
  }
  __device__ V3 oa_at(const SolveArgs& A, const Loc& loc, int e) {
    const int rr = e / A.K, k = e - rr * A.K, b = k / A.Kb;
    const float* o = cluster.map_shared_rank(loc.Oa, b) + rr * loc.rs + k - b * A.Kb;
    return v3(o[0], o[loc.cs], o[2 * loc.cs]);
  }
  // z_l (valid in lane 0) into every CTA's copy, lane b writing CTA b's
  __device__ void put_zl(const SolveArgs&, const Loc& loc, int l, const V3& zz) {
    const int lane = threadIdx.x & 31;
    const float z0 = __shfl_sync(0xffffffffu, zz.v[0], 0), z1 = __shfl_sync(0xffffffffu, zz.v[1], 0),
                z2 = __shfl_sync(0xffffffffu, zz.v[2], 0);
    if (lane < size()) {
      float* d = cluster.map_shared_rank(loc.zl, lane) + 3 * l;
      d[0] = z0; d[1] = z1; d[2] = z2;
    }
  }
};

// rows x n floats from src (row stride sstride) to dst (row stride dstride),
// 4-byte cp.async copies (any alignment); the caller waits
template <class T>
__device__ __forceinline__ void stage(T* dst, int dstride, const T* src, long long sstride, int rows, int n) {
  for (int t = threadIdx.x; t < rows * n; t += BLOCK) {
    const int row = t / n, i = t - row * n;
    __pipeline_memcpy_async(dst + row * dstride + i, src + row * sstride + i, sizeof(T));
  }
}

// The prior's product y = Hp xg on the unit's last block, after the landmark
// work: xg (the masked p at the boundary poses, one element a thread, all
// loads at once) into shared memory; then for each row r and slot group s of
// PRIOR_SPLIT the products over the boundary poses c = s, s + PRIOR_SPLIT, ...;
// then each row's PRIOR_SPLIT partials in order. Every thread of every block
// calls it (two block barriers).
constexpr int PRIOR_SPLIT = 8;

template <bool CLUSTER>
__device__ __forceinline__ void prior_product(const SolveArgs& A, const Loc& loc, Unit<CLUSTER>& U, Shared& sh) {
  const int n = 6 * A.PB;
  const bool last = U.rank() == U.size() - 1;
  if (last)
    for (int j = threadIdx.x; j < n; j += BLOCK) {
      const int kc = __ldg(A.pidx + j / 6);
      sh.xg[j] = U.p_at(A, loc, kc, j % 6) * __ldg(A.pf + kc);
    }
  __syncthreads();
  if (last)
    for (int t = threadIdx.x; t < n * PRIOR_SPLIT; t += BLOCK) {
      const int r = t / PRIOR_SPLIT;
      const float* row = A.Hp + static_cast<long long>(r) * n;
      float acc = 0.f;
      for (int c = t % PRIOR_SPLIT; c < A.PB; c += PRIOR_SPLIT)
#pragma unroll
        for (int d = 0; d < 6; ++d) acc += __ldg(row + 6 * c + d) * sh.xg[6 * c + d];
      sh.part[t] = acc;  // free in phase b
    }
  __syncthreads();
  if (last)
    for (int r = threadIdx.x; r < n; r += BLOCK) {
      float y = 0.f;
#pragma unroll
      for (int q = 0; q < PRIOR_SPLIT; ++q) y += sh.part[r * PRIOR_SPLIT + q];
      A.yp[r] = y;
    }
}

// Phase c, or the right-hand side (RHS: Oa = 0 and zl = y, no chain, no prior).
// Per chunk of POSE_GROUP poses of the block's range: the masked p over the
// chunk and its neighbours into xs; thread (lane, g) the slot part of pose
// lane over slot group g, and chain rows; then one thread per (channel, pose)
// sums them in a fixed order. Returns this thread's share of p.Ap (MATVEC) or
// of r.z, with b.b in bb (RHS).
template <bool CLUSTER, bool RHS>
__device__ float pose_rows(const SolveArgs& A, const Loc& loc, Unit<CLUSTER>& U, Shared& sh, int k0, int k1,
                           float lam, float& bb) {
  const typename Unit<CLUSTER>::Ld ld{};  // the block's own state: shared memory, or L2
  const int K = A.K, lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  float acc = 0.f;
  bb = 0.f;
  for (int c0 = k0; c0 < k1; c0 += POSE_GROUP) {
    if (!RHS) {
      for (int t = threadIdx.x; t < 6 * (POSE_GROUP + 2); t += BLOCK) {
        const int c = t / (POSE_GROUP + 2), j = t % (POSE_GROUP + 2), kq = c0 - 1 + j;
        float val = 0.f;
        if (kq >= 0 && kq < K) {
          val = (kq >= k0 && kq < k1) ? ld(loc.p + c * loc.ps + kq - loc.kb) * loc.pf[kq - loc.kb]
                                      : U.halo(A, loc, sh, kq, k0, k1, c);
        }
        sh.xs[c][j] = val;
      }
      __syncthreads();
    }
    const int k = c0 + lane, kk = k - loc.kb;
    const bool on = k < k1;
    float us[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (on) {
      mv_bwd_slot_group(loc.v, loc.Ow, RHS ? nullptr : loc.Oa, loc.ll, loc.zl, load_m3(loc.Rt, loc.ps, kk), loc.cs,
                        loc.rs, kk, A.R, g, G, ld, us);
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) sh.part[(g * 6 + i) * POSE_GROUP + lane] = us[i];
    if (!RHS) {
      // Hii x_k, Hij x_{k+1}, Hij_{k-1}^T x_{k-1}, Hjj_{k-1} x_k
      for (int j = g; j < 24; j += G) {
        const int b = j / 6, i = j % 6;
        float val = 0.f;
        if (on && (b < 2 || k > 0)) {
          const int hc = kk + loc.hoff - (b >= 2 ? 1 : 0);
          val = b == 0 ? m66_row(loc.Hii, loc.ps, kk, i, false, &sh.xs[0][lane + 1], POSE_GROUP + 2)
              : b == 1 ? m66_row(loc.Hij, loc.hps, hc, i, false, &sh.xs[0][lane + 2], POSE_GROUP + 2)
              : b == 2 ? m66_row(loc.Hij, loc.hps, hc, i, true, &sh.xs[0][lane], POSE_GROUP + 2)
                       : m66_row(loc.Hjj, loc.hps, hc, i, false, &sh.xs[0][lane + 1], POSE_GROUP + 2);
        }
        sh.chain[j][lane] = val;
      }
    }
    __syncthreads();
    if (RHS) {
      // b = -(gp - c) pf with c = W y = -(the slot part at Oa = 0, z = y); x = 0, r = b
      for (int t = threadIdx.x; t < 6 * POSE_GROUP; t += BLOCK) {
        const int i = t / POSE_GROUP, q = t % POSE_GROUP, kq = c0 + q, kl = kq - loc.kb;
        if (kq >= k1) continue;
        const float b = -(A.gp[i * K + kq] + group_total(sh.part, G, i, q)) * loc.pf[kl];
        loc.x[i * loc.ps + kl] = 0.f;
        loc.r[i * loc.ps + kl] = b;
        bb += b * b;
      }
      __syncthreads();
      // z = M^-1 r pf, p = z
      for (int t = threadIdx.x; t < 6 * POSE_GROUP; t += BLOCK) {
        const int i = t / POSE_GROUP, q = t % POSE_GROUP, kq = c0 + q, kl = kq - loc.kb;
        if (kq >= k1) continue;
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < 6; ++j)
          s += ld(loc.Minv + (i * 6 + j) * loc.ps + kl) * ld(loc.r + j * loc.ps + kl);
        s *= loc.pf[kl];
        loc.z[i * loc.ps + kl] = s;
        loc.p[i * loc.ps + kl] = s;
        acc += ld(loc.r + i * loc.ps + kl) * s;
      }
    } else {
      for (int t = threadIdx.x; t < 6 * POSE_GROUP; t += BLOCK) {
        const int i = t / POSE_GROUP, q = t % POSE_GROUP, kq = c0 + q, kl = kq - loc.kb;
        if (kq >= k1) continue;
        float u = group_total(sh.part, G, i, q) + sh.chain[i][q] + sh.chain[6 + i][q] + sh.chain[12 + i][q] +
                  sh.chain[18 + i][q];
        for (int b = 0; b < A.PB; ++b)
          if (__ldg(A.pidx + b) == kq) u += __ldcg(A.yp + 6 * b + i);
        const float ap = (u + lam * sh.xs[i][q + 1]) * loc.pf[kl];
        loc.Ap[i * loc.ps + kl] = ap;
        acc += ld(loc.p + i * loc.ps + kl) * ap;
      }
    }
    __syncthreads();  // the chunk's shared buffers are reused
  }
  return acc;
}

// per slot of the block's range: Oa = O' (Jp xf), xf the masked p
template <bool CLUSTER>
__device__ __forceinline__ void slots_fwd(const SolveArgs& A, const Loc& loc, int k0, int nk) {
  const typename Unit<CLUSTER>::Ld ld{};
  for (int t = threadIdx.x; t < A.R * nk; t += BLOCK) {
    const int rr = t / nk, kl = k0 + t - rr * nk - loc.kb, e = rr * loc.rs + kl;
    const float f = loc.pf[kl];
    float pk[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) pk[i] = ld(loc.p + i * loc.ps + kl) * f;
    store_v3(loc.Oa, loc.cs, e, mv_fwd_slot(loc.v, loc.Ow, loc.cs, e, v3(pk[0], pk[1], pk[2]), v3(pk[3], pk[4], pk[5])));
  }
}

template <bool CLUSTER>
__device__ void solve_body(const SolveArgs& A, float* dyn) {
  __shared__ Shared sh;
  Unit<CLUSTER> U;
  const typename Unit<CLUSTER>::Ld ld{};
  const int K = A.K, R = A.R, L = A.L, E = K * R;
  const int blk = U.rank();
  const int k0 = blk * A.Kb, k1 = min(K, k0 + A.Kb), nk = k1 - k0;
  const int utid = blk * BLOCK + threadIdx.x, unthr = U.size() * BLOCK;
  const int lane = threadIdx.x & 31, uwarp = utid >> 5, unwarps = unthr >> 5;
  const float lam = *A.lam;

  Loc loc;
  if (CLUSTER) {
    const ClusterLayout lay(A.Kb, R, L);
    float* s = dyn;
    loc.v = s + lay.v; loc.Ow = s + lay.Ow; loc.Oa = s + lay.Oa; loc.ll = reinterpret_cast<const int*>(s + lay.ll);
    loc.Rt = s + lay.Rt; loc.Hii = s + lay.Hii; loc.Hij = s + lay.Hij; loc.Hjj = s + lay.Hjj; loc.pf = s + lay.pf;
    loc.Minv = s + lay.Minv; loc.x = s + lay.x; loc.r = s + lay.r; loc.z = s + lay.z; loc.p = s + lay.p;
    loc.Ap = s + lay.Ap; loc.zl = s + lay.zl;
    loc.cs = R * A.Kb; loc.rs = A.Kb; loc.ps = A.Kb; loc.hps = A.Kb + 1; loc.hoff = 1; loc.kb = k0;
    // the range's read-only inputs into shared memory, once per launch
    stage(s + lay.v, loc.rs, A.v + k0, K, 3 * R, nk);
    stage(s + lay.Ow, loc.rs, A.Ow + k0, K, 9 * R, nk);
    stage(reinterpret_cast<int*>(s + lay.ll), loc.rs, A.ll_rk + k0, K, R, nk);
    stage(s + lay.Rt, loc.ps, A.Rt + k0, K, 9, nk);
    stage(s + lay.Hii, loc.ps, A.Hii + k0, K, 36, nk);
    const int h0 = k0 > 0 ? 1 : 0;  // column 0 holds pose k0-1
    stage(s + lay.Hij + 1 - h0, loc.hps, A.Hij + k0 - h0, K, 36, nk + h0);
    stage(s + lay.Hjj + 1 - h0, loc.hps, A.Hjj + k0 - h0, K, 36, nk + h0);
    stage(s + lay.pf, loc.ps, A.pf + k0, K, 1, nk);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
  } else {
    loc.v = A.v; loc.Ow = A.Ow; loc.Oa = A.Oa; loc.ll = A.ll_rk; loc.Rt = A.Rt; loc.Hii = A.Hii; loc.Hij = A.Hij;
    loc.Hjj = A.Hjj; loc.pf = A.pf; loc.Minv = A.Minv; loc.x = A.x; loc.r = A.r; loc.z = A.z; loc.p = A.p;
    loc.Ap = A.Ap; loc.zl = A.zl;
    loc.cs = E; loc.rs = K; loc.ps = K; loc.hps = K; loc.hoff = 0; loc.kb = 0;
  }

  // ---- set-up: A^-1, y = A^-1 (gl lmf) per landmark; M^-1 per own pose
  for (int l = utid; l < L; l += unthr) {
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
  for (int q = threadIdx.x; q < nk; q += BLOCK) {
    const int k = k0 + q, kl = k - loc.kb;
    const float f = A.pf[k];
    float Md[36], Mi[36];
#pragma unroll
    for (int c = 0; c < 36; ++c) {
      const bool d = c / 6 == c % 6;
      Md[c] = (A.diag[c * K + k] + (d ? lam : 0.f)) * f + (d ? 1.f - f : 0.f);
    }
    inv66(Md, Mi);
#pragma unroll
    for (int c = 0; c < 36; ++c) loc.Minv[c * loc.ps + kl] = Mi[c];
  }
  U.sync();

  // ---- right-hand side and CG start: x = 0, r = b, z = M^-1 r, p = z
  Loc rhs = loc;
  if (CLUSTER) {
    for (int t = threadIdx.x; t < 3 * L; t += BLOCK) loc.zl[t] = __ldcg(A.y + t);
    __syncthreads();
  } else {
    rhs.zl = A.y;
  }
  float start[2];  // r.z, b.b
  start[0] = pose_rows<CLUSTER, true>(A, rhs, U, sh, k0, k1, lam, start[1]);
  block_sum<2>(start, sh.red);
  U.publish(A, sh, 1, start[0]);
  U.publish(A, sh, 3, start[1]);
  U.sync();
  float rz = U.gather(A, sh, 1);
  const float bb = U.gather(A, sh, 3);
  const float b2 = fmaxf(bb, 1e-30f);
  float rr = bb, beta = 0.f;

  for (int it = 0; it < A.n_steps; ++it) {
    if (!(rr > A.tol * b2)) break;  // inactive from here on: x stays as it is

    // a. p = z + beta p (own poses); per own slot Oa = O' (Jp p pf)
    if (it > 0) {
      for (int t = threadIdx.x; t < 6 * nk; t += BLOCK) {
        const int i = t / nk, kl = k0 + t - i * nk - loc.kb;
        loc.p[i * loc.ps + kl] =
            ld(loc.z + i * loc.ps + kl) + beta * ld(loc.p + i * loc.ps + kl);
      }
      __syncthreads();
    }
    U.push_halo(A, loc, sh, nk, k0);
    slots_fwd<CLUSTER>(A, loc, k0, nk);
    U.sync();

    // b. per landmark: z_l = A^-1 sum Rt^T Oa; the prior's product on the unit's last threads
    for (int l = uwarp; l < L; l += unwarps) {
      const V3 T = mv_fwd_landmark_warp_at(A.Rt, A.lm_slots, A.lm_start[l], A.lm_start[l + 1], K, lane,
                                           [&](int e) { return U.oa_at(A, loc, e); });
      M3 Ai;
#pragma unroll
      for (int c = 0; c < 9; ++c) Ai.m[c / 3][c % 3] = __ldcg(A.Ainv + 9 * l + c);
      U.put_zl(A, loc, l, mv(Ai, T));
    }
    if (A.PB > 0) prior_product<CLUSTER>(A, loc, U, sh);
    U.sync();

    // c. per pose: Ap and p.Ap
    float unused;
    float pap = pose_rows<CLUSTER, false>(A, loc, U, sh, k0, k1, lam, unused);
    block_sum<1>(&pap, sh.red);
    U.publish(A, sh, 0, pap);
    U.sync();
    const float alpha = rz / fmaxf(U.gather(A, sh, 0), 1e-30f);

    // d. per own pose and channel: x += alpha p, r -= alpha Ap; then z = M^-1 r
    for (int t = threadIdx.x; t < 6 * nk; t += BLOCK) {
      const int i = t / nk, kl = k0 + t - i * nk - loc.kb, o = i * loc.ps + kl;
      loc.x[o] = ld(loc.x + o) + alpha * ld(loc.p + o);
      loc.r[o] = ld(loc.r + o) - alpha * ld(loc.Ap + o);
    }
    __syncthreads();
    float part[2] = {0.f, 0.f};  // r.z, r.r
    for (int t = threadIdx.x; t < 6 * nk; t += BLOCK) {
      const int i = t / nk, kl = k0 + t - i * nk - loc.kb;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 6; ++j)
        s += ld(loc.Minv + (i * 6 + j) * loc.ps + kl) * ld(loc.r + j * loc.ps + kl);
      s *= loc.pf[kl];
      loc.z[i * loc.ps + kl] = s;
      const float ri = ld(loc.r + i * loc.ps + kl);
      part[0] += ri * s;
      part[1] += ri * ri;
    }
    block_sum<2>(part, sh.red);
    U.publish(A, sh, 1, part[0]);
    U.publish(A, sh, 2, part[1]);
    U.sync();
    const float rz_new = U.gather(A, sh, 1);
    rr = U.gather(A, sh, 2);
    beta = rz_new / fmaxf(rz, 1e-30f);
    rz = rz_new;
  }

  // ---- back-substitution: dp = x pf; db = A^-1 (-gl lmf - W^T dp) lmf
  for (int t = threadIdx.x; t < 6 * nk; t += BLOCK) {
    const int i = t / nk, k = k0 + t - i * nk, kl = k - loc.kb;
    const float xf = ld(loc.x + i * loc.ps + kl) * loc.pf[kl];
    A.dp[i * K + k] = xf;
    loc.p[i * loc.ps + kl] = xf;  // p is free now: slots_fwd masks it with pf again (pf^2 = pf)
  }
  __syncthreads();
  slots_fwd<CLUSTER>(A, loc, k0, nk);
  U.sync();
  for (int l = uwarp; l < L; l += unwarps) {
    const V3 T = mv_fwd_landmark_warp_at(A.Rt, A.lm_slots, A.lm_start[l], A.lm_start[l + 1], K, lane,
                                         [&](int e) { return U.oa_at(A, loc, e); });
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
  if (CLUSTER) U.sync();  // no CTA leaves while another still reads its shared memory
}

__global__ void __launch_bounds__(BLOCK, 1) solve_cluster_kernel(SolveArgs A) {
  extern __shared__ float dyn[];
  solve_body<true>(A, dyn);
}

__global__ void __launch_bounds__(BLOCK, 1) solve_grid_kernel(SolveArgs A) { solve_body<false>(A, nullptr); }

// co-resident blocks of the grid kernel on the current device (cached per device)
int max_coresident_blocks() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, solve_grid_kernel, BLOCK, 0) != cudaSuccess) return 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
    cached[dev] = per_sm * sms;
  }
  return cached[dev];
}

int ceil_div(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

// poses a block: a multiple of POSE_GROUP, so that at most `blocks` blocks cover K
int poses_per_block(int K, int blocks) { return POSE_GROUP * ceil_div(ceil_div(K, blocks), POSE_GROUP); }

}  // namespace

// Bytes of shared memory a CTA of the cluster shape takes (dynamic + static)
// at K, R, L: what solver/kernels.py `solve_shape` holds against the card's.
extern "C" long long soa_solve_cluster_smem(int K, int R, int L) {
  const ClusterLayout lay(poses_per_block(K, MAX_CLUSTER), R, L);
  return 4LL * lay.words + static_cast<long long>(sizeof(Shared));
}

// Shared memory a block may opt in to on the current device, in bytes (0 on error)
extern "C" long long soa_solve_smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) return 0;
  return bytes;
}

// Scratch floats the wrapper must provide (either shape, up to `max_blocks` blocks).
extern "C" long long soa_solve_scratch(int K, int R, int L, int PB, int max_blocks) {
  return 18LL * L + 6LL * PB + static_cast<long long>(NP) * max_blocks + 36LL * K + 30LL * K + 3LL * K * R;
}

// Launches on `stream`; returns the CUDA error of the launch (0 = ok).
// `cluster` = 1 takes the cluster shape, 0 the cooperative grid (the wrapper's
// `solve_shape` decides). `lam` is a device scalar; dp is [6, K], db is [L, 3].
// PB = 0 runs without a prior (Hp and pidx are then not read).
extern "C" int soa_solve_launch(const float* v, const float* Ow, const float* Rt, const float* Hii, const float* Hij,
                                const float* Hjj, const float* diag, const float* gp, const float* gl,
                                const float* Hll, const float* lmf, const float* pf, const int* ll_rk,
                                const int* lm_slots, const int* lm_start, const float* lam, const float* Hp,
                                const int* pidx, int PB, float tol, int n_steps, int K, int R, int L, float* dp,
                                float* db, float* scratch, int max_blocks, int cluster, void* stream_ptr) {
  if (K <= 0 || R <= 0 || L <= 0 || PB < 0 || 6 * PB > MAX_PRIOR_ROWS || max_blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  A.yp = s; s += 6LL * PB;
  A.partials = s; s += static_cast<long long>(NP) * max_blocks;
  A.Minv = s; s += 36LL * K;
  A.x = s; s += 6LL * K;
  A.r = s; s += 6LL * K;
  A.z = s; s += 6LL * K;
  A.p = s; s += 6LL * K;
  A.Ap = s; s += 6LL * K;
  A.Oa = s;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);

  if (cluster) {
    A.Kb = poses_per_block(K, MAX_CLUSTER);
    const int blocks = ceil_div(K, A.Kb);
    const ClusterLayout lay(A.Kb, R, L);
    const size_t dyn = 4ULL * lay.words;
    cudaError_t err = cudaFuncSetAttribute(solve_cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(solve_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(dyn));
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(BLOCK);
    cfg.dynamicSmemBytes = dyn;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, solve_cluster_kernel, A);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }

  const int coresident = max_coresident_blocks();
  if (coresident <= 0) {
    const cudaError_t e = cudaGetLastError();
    return static_cast<int>(e != cudaSuccess ? e : cudaErrorInvalidConfiguration);
  }
  const int cap = coresident < max_blocks ? coresident : max_blocks;
  A.Kb = poses_per_block(K, cap);
  const int blocks = ceil_div(K, A.Kb);
  void* params[] = {&A};
  const cudaError_t err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(solve_grid_kernel),
                                                      dim3(static_cast<unsigned>(blocks)), dim3(BLOCK), params, 0,
                                                      stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* slam_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
