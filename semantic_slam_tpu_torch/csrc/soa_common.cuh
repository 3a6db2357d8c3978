// Device math shared by the SoA Schur-PCG kernels, written for Hopper
// (sm_90a): the whole-graph kernels K1-K4 (soa_linearize.cu, soa_chi2.cu,
// soa_solve.cu) and the row-range kernels K6-K10 (tiled_linearize.cu,
// tiled_matvec.cu, tiled_chi2.cu).
//
// Layouts are those of semantic_slam_tpu_torch/solver/ellk_soa.py: channel
// tensors with the big axes last, [C, R, K] per landmark slot (slot (r, k) at
// e = r*K + k, so neighbouring threads read neighbouring k) and [C, K] per
// pose; channel c of a [C, N] array sits at c*N. Landmark tables are [L, C].
//
// The chain math mirrors solver/chain_soa.py (same Taylor cutoffs and guards,
// atan2f for the quaternion log). The two halves of the Schur matvec,
// mv_fwd_* and mv_bwd_slot_group with m66_row, are the math of the TPU
// kernels _mv_fwd_kernel / _mv_bwd_kernel (solver/pallas_tiled.py): K4 runs
// them inside its one launch, K8 and K9 as launches of their own. The two
// launches of the linearization (chain_block and lin_slots_block, then
// lin_fold_block) are K1's with K2's chain blocks on the whole graph and
// K6's with K7's on a row range; the objective's slot pass
// (chi2_slots_block) is K3's and K10's.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace soa {

struct V3 { float v[3]; };
struct M3 { float m[3][3]; };
struct Q4 { float w, x, y, z; };

__device__ __forceinline__ V3 v3(float a, float b, float c) { V3 r; r.v[0] = a; r.v[1] = b; r.v[2] = c; return r; }
__device__ __forceinline__ V3 add(const V3& a, const V3& b) { return v3(a.v[0] + b.v[0], a.v[1] + b.v[1], a.v[2] + b.v[2]); }
__device__ __forceinline__ V3 sub(const V3& a, const V3& b) { return v3(a.v[0] - b.v[0], a.v[1] - b.v[1], a.v[2] - b.v[2]); }
__device__ __forceinline__ V3 scale(const V3& a, float s) { return v3(a.v[0] * s, a.v[1] * s, a.v[2] * s); }
__device__ __forceinline__ V3 neg(const V3& a) { return v3(-a.v[0], -a.v[1], -a.v[2]); }
__device__ __forceinline__ float dot(const V3& a, const V3& b) { return a.v[0] * b.v[0] + a.v[1] * b.v[1] + a.v[2] * b.v[2]; }
__device__ __forceinline__ V3 cross(const V3& a, const V3& b) {
  return v3(a.v[1] * b.v[2] - a.v[2] * b.v[1], a.v[2] * b.v[0] - a.v[0] * b.v[2], a.v[0] * b.v[1] - a.v[1] * b.v[0]);
}

__device__ __forceinline__ M3 mzero() { M3 r;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) r.m[i][j] = 0.f;
  return r;
}
__device__ __forceinline__ M3 eye3() { M3 r = mzero(); r.m[0][0] = r.m[1][1] = r.m[2][2] = 1.f; return r; }
__device__ __forceinline__ M3 madd(const M3& A, const M3& B) { M3 r;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) r.m[i][j] = A.m[i][j] + B.m[i][j];
  return r;
}
__device__ __forceinline__ M3 msub(const M3& A, const M3& B) { M3 r;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) r.m[i][j] = A.m[i][j] - B.m[i][j];
  return r;
}
__device__ __forceinline__ M3 mscale(const M3& A, float s) { M3 r;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) r.m[i][j] = A.m[i][j] * s;
  return r;
}
__device__ __forceinline__ M3 mneg(const M3& A) { return mscale(A, -1.f); }
__device__ __forceinline__ M3 mT(const M3& A) { M3 r;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) r.m[i][j] = A.m[j][i];
  return r;
}
// A @ B
__device__ __forceinline__ M3 mul(const M3& A, const M3& B) { M3 r;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) r.m[i][j] = A.m[i][0] * B.m[0][j] + A.m[i][1] * B.m[1][j] + A.m[i][2] * B.m[2][j];
  return r;
}
// A^T @ B
__device__ __forceinline__ M3 mulT(const M3& A, const M3& B) { M3 r;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) r.m[i][j] = A.m[0][i] * B.m[0][j] + A.m[1][i] * B.m[1][j] + A.m[2][i] * B.m[2][j];
  return r;
}
__device__ __forceinline__ V3 mv(const M3& A, const V3& x) {
  return v3(A.m[0][0] * x.v[0] + A.m[0][1] * x.v[1] + A.m[0][2] * x.v[2],
            A.m[1][0] * x.v[0] + A.m[1][1] * x.v[1] + A.m[1][2] * x.v[2],
            A.m[2][0] * x.v[0] + A.m[2][1] * x.v[1] + A.m[2][2] * x.v[2]);
}
// A^T x
__device__ __forceinline__ V3 mTv(const M3& A, const V3& x) {
  return v3(A.m[0][0] * x.v[0] + A.m[1][0] * x.v[1] + A.m[2][0] * x.v[2],
            A.m[0][1] * x.v[0] + A.m[1][1] * x.v[1] + A.m[2][1] * x.v[2],
            A.m[0][2] * x.v[0] + A.m[1][2] * x.v[1] + A.m[2][2] * x.v[2]);
}
__device__ __forceinline__ M3 hat(const V3& w) {
  M3 r = mzero();
  r.m[0][1] = -w.v[2]; r.m[0][2] = w.v[1];
  r.m[1][0] = w.v[2];  r.m[1][2] = -w.v[0];
  r.m[2][0] = -w.v[1]; r.m[2][1] = w.v[0];
  return r;
}
// hat(v) @ M, in chain_soa.hat_mul's op order
__device__ __forceinline__ M3 hat_mul(const V3& v, const M3& M) { M3 r;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    r.m[0][j] = -v.v[2] * M.m[1][j] + v.v[1] * M.m[2][j];
    r.m[1][j] = v.v[2] * M.m[0][j] - v.v[0] * M.m[2][j];
    r.m[2][j] = -v.v[1] * M.m[0][j] + v.v[0] * M.m[1][j];
  }
  return r;
}
// O @ hat(v) (ellk_soa._ob_product)
__device__ __forceinline__ M3 ob_product(const M3& O, const V3& v) { M3 r;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    r.m[i][0] = O.m[i][1] * v.v[2] - O.m[i][2] * v.v[1];
    r.m[i][1] = -O.m[i][0] * v.v[2] + O.m[i][2] * v.v[0];
    r.m[i][2] = O.m[i][0] * v.v[1] - O.m[i][1] * v.v[0];
  }
  return r;
}

// closed-form adjugate 3x3 inverse (lm.inv33)
__device__ __forceinline__ M3 inv33(const M3& A) {
  const float a = A.m[0][0], b = A.m[0][1], c = A.m[0][2];
  const float d = A.m[1][0], e = A.m[1][1], f = A.m[1][2];
  const float g = A.m[2][0], h = A.m[2][1], i = A.m[2][2];
  M3 r;
  r.m[0][0] = e * i - f * h; r.m[0][1] = c * h - b * i; r.m[0][2] = b * f - c * e;
  r.m[1][0] = f * g - d * i; r.m[1][1] = a * i - c * g; r.m[1][2] = c * d - a * f;
  r.m[2][0] = d * h - e * g; r.m[2][1] = b * g - a * h; r.m[2][2] = a * e - b * d;
  const float det = a * r.m[0][0] + b * r.m[1][0] + c * r.m[2][0];
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int q = 0; q < 3; ++q) r.m[p][q] = r.m[p][q] / det;
  return r;
}

// 6x6 inverse by the 2x2 block Schur complement of two 3x3 inverses
// (lm.inv66); M and out are row-major [36] in registers.
__device__ __forceinline__ void inv66(const float* M, float* out) {
  M3 A, B, C, D;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      A.m[i][j] = M[i * 6 + j];       B.m[i][j] = M[i * 6 + j + 3];
      C.m[i][j] = M[(i + 3) * 6 + j]; D.m[i][j] = M[(i + 3) * 6 + j + 3];
    }
  const M3 Ai = inv33(A);
  const M3 CAi = mul(C, Ai);
  const M3 Si = inv33(msub(D, mul(CAi, B)));
  const M3 AiB = mul(Ai, B);
  const M3 AiBSi = mul(AiB, Si);
  const M3 TL = madd(Ai, mul(AiBSi, CAi));
  const M3 BL = mneg(mul(Si, CAi));
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      out[i * 6 + j] = TL.m[i][j];       out[i * 6 + j + 3] = -AiBSi.m[i][j];
      out[(i + 3) * 6 + j] = BL.m[i][j]; out[(i + 3) * 6 + j + 3] = Si.m[i][j];
    }
}

// ---------------------------------------------------------------------------
// quaternions (w first) and the SE3 chain (solver/chain_soa.py)
// ---------------------------------------------------------------------------

__device__ __forceinline__ Q4 qconj(const Q4& q) { return Q4{q.w, -q.x, -q.y, -q.z}; }
__device__ __forceinline__ Q4 qmul(const Q4& a, const Q4& b) {
  return Q4{a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
            a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
            a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
            a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w};
}
__device__ __forceinline__ Q4 qnormalize(const Q4& q) {
  const float n = sqrtf(q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z);
  return Q4{q.w / n, q.x / n, q.y / n, q.z / n};
}
__device__ __forceinline__ V3 qrotate(const Q4& q, const V3& v) {
  const V3 u = v3(q.x, q.y, q.z);
  const V3 uv = cross(u, v);
  return add(v, scale(add(scale(uv, q.w), cross(u, uv)), 2.f));
}
__device__ __forceinline__ M3 rotmat(const Q4& q) {
  const float xx = q.x * q.x, yy = q.y * q.y, zz = q.z * q.z;
  const float wx = q.w * q.x, wy = q.w * q.y, wz = q.w * q.z;
  const float xy = q.x * q.y, xz = q.x * q.z, yz = q.y * q.z;
  M3 r;
  r.m[0][0] = 1 - 2 * (yy + zz); r.m[0][1] = 2 * (xy - wz);     r.m[0][2] = 2 * (xz + wy);
  r.m[1][0] = 2 * (xy + wz);     r.m[1][1] = 1 - 2 * (xx + zz); r.m[1][2] = 2 * (yz - wx);
  r.m[2][0] = 2 * (xz - wy);     r.m[2][1] = 2 * (yz + wx);     r.m[2][2] = 1 - 2 * (xx + yy);
  return r;
}
__device__ __forceinline__ V3 quat_log(Q4 q) {
  const float sign = q.w < 0.f ? -1.f : 1.f;
  q = Q4{q.w * sign, q.x * sign, q.y * sign, q.z * sign};
  const float w = fminf(fmaxf(q.w, -1.f), 1.f);
  const float vnorm = sqrtf(q.x * q.x + q.y * q.y + q.z * q.z);
  const float theta = 2.f * atan2f(vnorm, fmaxf(w, 0.f));
  const float s = vnorm < 1e-8f ? 2.f / fmaxf(w, 1e-12f) : theta / fmaxf(vnorm, 1e-32f);
  return v3(s * q.x, s * q.y, s * q.z);
}
__device__ __forceinline__ M3 so3_ljac_inv(const V3& w) {
  const float theta2 = dot(w, w);
  const float theta = sqrtf(theta2 + 1e-32f);
  const M3 W = hat(w);
  const M3 W2 = mul(W, W);
  const float half = 0.5f * theta;
  const float cot = theta2 < 4e-3f
      ? 1.f / 12.f + theta2 / 720.f + theta2 * theta2 / 30240.f
      : (1.f - half * cosf(half) / fmaxf(sinf(half), 1e-32f)) / fmaxf(theta2, 1e-32f);
  return madd(msub(eye3(), mscale(W, 0.5f)), mscale(W2, cot));
}
__device__ __forceinline__ M3 se3_Q(const V3& v, const V3& w) {
  const float theta2 = dot(w, w);
  const float theta = sqrtf(theta2 + 1e-32f);
  const M3 V = hat(v), W = hat(w);
  const M3 WV = mul(W, V), VW = mul(V, W), WW = mul(W, W);
  const M3 W_VW = mul(W, VW);
  const bool small = theta2 < 4e-3f;
  const float t4 = theta2 * theta2;
  const float s = sinf(theta), c = cosf(theta);
  const float c1 = small ? 1.f / 6.f - theta2 / 120.f + t4 / 5040.f : (theta - s) / fmaxf(theta2 * theta, 1e-32f);
  const float c2 = small ? 1.f / 24.f - theta2 / 720.f + t4 / 40320.f
                         : (theta2 + 2.f * c - 2.f) / fmaxf(2.f * theta2 * theta2, 1e-32f);
  const float c3 = small ? 1.f / 120.f - theta2 / 2520.f + t4 / 120960.f
                         : (2.f * theta - 3.f * s + theta * c) / fmaxf(2.f * theta2 * theta2 * theta, 1e-32f);
  M3 r = mscale(V, 0.5f);
  r = madd(r, mscale(madd(madd(WV, VW), W_VW), c1));
  r = madd(r, mscale(msub(madd(mul(WW, V), mul(V, WW)), mscale(W_VW, 3.f)), c2));
  r = madd(r, mscale(madd(mul(W_VW, W), mul(WW, VW)), c3));
  return r;
}

struct ChainRes { V3 rv, rw, rel_t; Q4 rel_q; };

// r = log(m^-1 T_i^-1 T_j), translation part first
__device__ __forceinline__ ChainRes chain_residual(const V3& ti, const Q4& qi, const V3& tj, const Q4& qj,
                                                   const V3& mt, const Q4& mq) {
  ChainRes out;
  const Q4 qic = qconj(qi);
  // R^T (t_j - t_i): the difference first, as chain_soa.chain_residual_ch
  out.rel_t = qrotate(qic, sub(tj, ti));
  out.rel_q = qnormalize(qmul(qic, qj));
  const Q4 mqc = qconj(mq);
  const V3 Et = qrotate(mqc, sub(out.rel_t, mt));
  const Q4 Eq = qnormalize(qmul(mqc, out.rel_q));
  out.rw = quat_log(Eq);
  out.rv = mv(so3_ljac_inv(out.rw), Et);
  return out;
}

// information quadrants of a [6,6,K] channel array at pose k
struct Info6 { M3 O11, O12, O21, O22; };
__device__ __forceinline__ Info6 load_info6(const float* O, int K, int k) {
  Info6 r;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      r.O11.m[i][j] = O[(i * 6 + j) * K + k];
      r.O12.m[i][j] = O[(i * 6 + j + 3) * K + k];
      r.O21.m[i][j] = O[((i + 3) * 6 + j) * K + k];
      r.O22.m[i][j] = O[((i + 3) * 6 + j + 3) * K + k];
    }
  return r;
}

__device__ __forceinline__ float chain_chi(const ChainRes& c, const Info6& O) {
  const V3 Orv = add(mv(O.O11, c.rv), mv(O.O12, c.rw));
  const V3 Orw = add(mv(O.O21, c.rv), mv(O.O22, c.rw));
  return dot(c.rv, Orv) + dot(c.rw, Orw);
}

// ---------------------------------------------------------------------------
// poses and the observation slot (solver/ellk_soa.py soa_linearize)
// ---------------------------------------------------------------------------

// pose k of a [7, K] channel array: t = rows 0-2, q = rows 3-6 (w first)
__device__ __forceinline__ void load_pose(const float* P, int K, int k, V3& t, Q4& q) {
  t = v3(P[k], P[K + k], P[2 * K + k]);
  q = Q4{P[3 * K + k], P[4 * K + k], P[5 * K + k], P[6 * K + k]};
}

__device__ __forceinline__ V3 load_v3(const float* a, int n, int i) { return v3(a[i], a[n + i], a[2 * n + i]); }
__device__ __forceinline__ void store_v3(float* a, int n, int i, const V3& x) {
  a[i] = x.v[0]; a[n + i] = x.v[1]; a[2 * n + i] = x.v[2];
}
__device__ __forceinline__ M3 load_m3(const float* a, int n, int i) { M3 r;
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int q = 0; q < 3; ++q) r.m[p][q] = a[(p * 3 + q) * n + i];
  return r;
}
__device__ __forceinline__ void store_m3(float* a, int n, int i, const M3& x) {
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int q = 0; q < 3; ++q) a[(p * 3 + q) * n + i] = x.m[p][q];
}
__device__ __forceinline__ V3 load_row3(const float* tab, int l) { return v3(tab[3 * l], tab[3 * l + 1], tab[3 * l + 2]); }
// loads of data that other blocks of the same launch wrote: __ldcg reads
// through L2, past this SM's (incoherent) L1
__device__ __forceinline__ V3 load_v3_cg(const float* a, int n, int i) {
  return v3(__ldcg(a + i), __ldcg(a + n + i), __ldcg(a + 2 * n + i));
}
__device__ __forceinline__ V3 load_row3_cg(const float* tab, int l) {
  return v3(__ldcg(tab + 3 * l), __ldcg(tab + 3 * l + 1), __ldcg(tab + 3 * l + 2));
}

enum RobustKind { ROBUST_NONE = 0, ROBUST_HUBER = 1, ROBUST_DCS = 2 };

// robust rho and IRLS weight (solver/robust.py)
__device__ __forceinline__ void robust_rho_w(float chi, int kind, float delta, float& rho, float& w) {
  if (kind == ROBUST_HUBER) {
    const float d2 = delta * delta;
    const float e = sqrtf(fmaxf(chi, 1e-30f));
    rho = chi <= d2 ? chi : 2.f * delta * e - d2;
    w = fminf(1.f, delta / e);
  } else if (kind == ROBUST_DCS) {
    const float phi = delta * delta;
    rho = 2.f * phi * chi / (phi + fmaxf(chi, 1e-30f));
    const float s = 2.f * phi / (phi + fmaxf(chi, 0.f));
    w = fminf(1.f, s * s);
  } else {
    rho = chi;
    w = 1.f;
  }
}

// the observation residual of slot e of pose (t, Rt): v = Rt (l - t), O r, chi
struct ObsSlot { V3 v, Or; M3 O; float chi; };
__device__ __forceinline__ ObsSlot obs_slot(const M3& Rt, const V3& t, const float* lm, const int* ll_rk,
                                            const float* meas, const float* info, int E, int e) {
  ObsSlot s;
  const V3 lw = load_row3(lm, ll_rk[e]);
  s.v = mv(Rt, sub(lw, t));
  const V3 r = sub(s.v, load_v3(meas, E, e));
  s.O = load_m3(info, E, e);
  s.Or = mv(s.O, r);
  s.chi = dot(r, s.Or);
  return s;
}

// ---------------------------------------------------------------------------
// the Schur matvec halves (TPU kernels K8 / K9)
// ---------------------------------------------------------------------------

// K8, per slot: Oa = O' (Jp x) with Jp x = -x_t + v x x_r
__device__ __forceinline__ V3 mv_fwd_slot(const float* v, const float* Ow, int E, int e, const V3& xt, const V3& xr) {
  const V3 ve = load_v3(v, E, e);
  return mv(load_m3(Ow, E, e), add(neg(xt), cross(ve, xr)));
}

// K8, per landmark, one warp: T = sum over the landmark's slots of
// Rt_k^T a_e, lanes striding the CSR segment, then a fixed shuffle tree; the
// result is valid in lane 0. Deterministic: the order depends only on the
// CSR. `a_at(e)` reads slot e's 3-vector wherever it lives (device memory
// written by other blocks, or another CTA's shared memory).
template <class SlotAt>
__device__ __forceinline__ V3 mv_fwd_landmark_warp_at(const float* Rt, const int* lm_slots, int j0, int j1, int K,
                                                      int lane, SlotAt a_at) {
  V3 T = v3(0.f, 0.f, 0.f);
  for (int j = j0 + lane; j < j1; j += 32) {
    const int e = lm_slots[j];
    T = add(T, mTv(load_m3(Rt, K, e % K), a_at(e)));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    T.v[0] += __shfl_down_sync(0xffffffffu, T.v[0], off);
    T.v[1] += __shfl_down_sync(0xffffffffu, T.v[1], off);
    T.v[2] += __shfl_down_sync(0xffffffffu, T.v[2], off);
  }
  return T;
}
// `a` [3, E] may have been written by other blocks of the same launch
__device__ __forceinline__ V3 mv_fwd_landmark_warp(const float* Rt, const float* a, const int* lm_slots, int j0,
                                                   int j1, int K, int E, int lane) {
  return mv_fwd_landmark_warp_at(Rt, lm_slots, j0, j1, K, lane, [=](int e) { return load_v3_cg(a, E, e); });
}

// ---------------------------------------------------------------------------
// K9's body, and K4's phase c: the per-pose half of the matvec spread over a
// group of threads. A block holds POSE_GROUP consecutive poses (one a lane)
// times G slot groups (one a warp). Slots are slot-major (e = r*K + k), so
// each warp's loads of v, O', Oa and ll_rk at one slot index are coalesced.
// Thread (lane, g) walks its pose's slots r = g, g + G, ... (a ragged R
// leaves some warps with one slot fewer); the G partial 6-vectors of a pose
// are summed through shared memory in the order g = 0..G-1, and the four
// 6x6 chain products are split over the group, one output row a thread.
// ---------------------------------------------------------------------------

constexpr int POSE_GROUP = 32;

// loads for mv_bwd_slot_group's `ld`: through L2 (data other blocks of the
// launch wrote), through the read-only path, or plain (shared memory)
struct LoadCg { __device__ float operator()(const float* a) const { return __ldcg(a); } };
struct LoadLdg { __device__ float operator()(const float* a) const { return __ldg(a); } };
struct LoadPlain { __device__ float operator()(const float* a) const { return *a; } };

// The slot part of one pose for slot group g of G:
//   u = sum over r = g, g + G, ... < R of Jp^T (Oa - O' Rt z_l)
// Slot arrays hold element (c, r) of the pose at c*cs + r*rs + kk; Oa ==
// nullptr stands for Oa = 0. `ld` reads Oa and z, which the same launch may
// have written (through L2, or from shared memory).
template <class Ld>
__device__ __forceinline__ void mv_bwd_slot_group(const float* v, const float* Ow, const float* Oa, const int* ll_rk,
                                                  const float* zl, const M3& Rtk, int cs, int rs, int kk, int R,
                                                  int g, int G, Ld ld, float* u) {
#pragma unroll
  for (int i = 0; i < 6; ++i) u[i] = 0.f;
  for (int r = g; r < R; r += G) {
    const int e = r * rs + kk;
    const int l = ll_rk[e];
    const V3 wz = mv(load_m3(Ow, cs, e), mv(Rtk, v3(ld(zl + 3 * l), ld(zl + 3 * l + 1), ld(zl + 3 * l + 2))));
    const V3 m = Oa ? sub(v3(ld(Oa + e), ld(Oa + cs + e), ld(Oa + 2 * cs + e)), wz) : neg(wz);
    const V3 vm = cross(load_v3(v, cs, e), m);
#pragma unroll
    for (int i = 0; i < 3; ++i) { u[i] -= m.v[i]; u[i + 3] -= vm.v[i]; }
  }
}

// Row i of a 6x6 channel block (element (a, b) at (a*6 + b)*n + col) times
// x, or of its transpose; x[c] at x[c * xs].
__device__ __forceinline__ float m66_row(const float* M, int n, int col, int i, bool transpose, const float* x,
                                         int xs) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < 6; ++c) s += M[(transpose ? c * 6 + i : i * 6 + c) * n + col] * x[c * xs];
  return s;
}

// The G slot partials of one output (6 channels x POSE_GROUP lanes a group),
// summed in the order g = 0..G-1
__device__ __forceinline__ float group_total(const float* part, int G, int i, int lane) {
  float s = 0.f;
  for (int g = 0; g < G; ++g) s += part[(g * 6 + i) * POSE_GROUP + lane];
  return s;
}

// ---------------------------------------------------------------------------
// the chain's linearization: a row's outputs spread over a group of warps
// (K2 and K7, as a block role of K1's and K6's first launch, chain_block)
// ---------------------------------------------------------------------------

// The residual of row k's chain edge, from pose (ti, qi) to its successor
// (tj, qj), and its Jacobians J_j = Jr^-1(r), J_i = -J_j Ad(rel^-1), both
// [[X, Y], [0, X]]: the serial part of the row.
struct ChainJac { ChainRes c; M3 Xi, Yi, Xj, Yj; };
__device__ __forceinline__ ChainJac chain_jacobians(const V3& ti, const Q4& qi, const V3& tj, const Q4& qj,
                                                    const float* o_meas, int K, int k) {
  V3 mt;
  Q4 mq;
  load_pose(o_meas, K, k, mt, mq);
  ChainJac J;
  J.c = chain_residual(ti, qi, tj, qj, mt, mq);
  J.Xj = so3_ljac_inv(neg(J.c.rw));
  J.Yj = mneg(mul(J.Xj, mul(se3_Q(neg(J.c.rv), neg(J.c.rw)), J.Xj)));
  const Q4 q_ir = qconj(J.c.rel_q);
  const V3 t_ir = neg(qrotate(q_ir, J.c.rel_t));
  const M3 R_ir = rotmat(q_ir);
  J.Xi = mneg(mul(J.Xj, R_ir));
  J.Yi = mneg(madd(mul(J.Xj, hat_mul(t_ir, R_ir)), mul(J.Yj, R_ir)));
  return J;
}

// quadrant (a, b) of a [6,6,n] channel array at column i
__device__ __forceinline__ M3 load_quad(const float* O, int n, int i, int a, int b) { M3 r;
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int q = 0; q < 3; ++q) r.m[p][q] = O[((3 * a + p) * 6 + 3 * b + q) * n + i];
  return r;
}

// The top (T11, T12) or bottom (T21, T22) quadrant row of T = J^T O for J =
// [[X, Y], [0, X]] (T11 = X^T O11, T21 = Y^T O11 + X^T O21, ...); O is
// [6,6,n] at column i.
__device__ __forceinline__ void chain_T_row(const M3& X, const M3& Y, const float* O, int n, int i, bool bottom,
                                            M3& Ta, M3& Tb) {
  const M3 O11 = load_quad(O, n, i, 0, 0), O12 = load_quad(O, n, i, 0, 1);
  if (bottom) {
    Ta = madd(mulT(Y, O11), mulT(X, load_quad(O, n, i, 1, 0)));
    Tb = madd(mulT(Y, O12), mulT(X, load_quad(O, n, i, 1, 1)));
  } else {
    Ta = mulT(X, O11);
    Tb = mulT(X, O12);
  }
}

// p ? A : B elementwise (selects of values: a conditional of the two lvalues
// would take their addresses and put the row's Jacobians in local memory)
__device__ __forceinline__ M3 msel(bool p, const M3& A, const M3& B) { M3 r;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) r.m[i][j] = p ? A.m[i][j] : B.m[i][j];
  return r;
}

// K2's outputs of a row as 17 tasks: t < 12 the quadrant t % 4 (11, 12, 21,
// 22) of Hii, Hij, Hjj (t / 4); t = 12..15 the top or bottom half of gi, gj;
// t = 16 the chi2.
constexpr int CHAIN_TASKS = 17;

// K2's and K7's body after the serial part (chain_jacobians, which every
// warp of a group computes for its rows, recomputed rather than exchanged):
// warp g of a group of G warps that holds 32 consecutive rows (one a lane)
// computes only the tasks t = g, g + G, ... < CHAIN_TASKS of row k, each
// with the T quadrants it needs (H = T J by quadrants: T11 X, T11 Y + T12 X,
// ...), so that a warp's store of one channel is 32 consecutive floats. The
// row's information is O [6,6,n] at column i. Returns the row's chi2 in the
// warp that has task 16, else 0.
__device__ __forceinline__ float chain_row_group_linearize(const ChainJac& J, const float* O, int n, int i, int K,
                                                           int k, int g, int G, float* Hii, float* Hij, float* Hjj,
                                                           float* gi, float* gj) {
  float chi = 0.f;
  for (int t = g; t < CHAIN_TASKS; t += G) {
    if (t == CHAIN_TASKS - 1) {
      chi = chain_chi(J.c, load_info6(O, n, i));
    } else if (t >= 12) {  // gradients: T rows of side i (gi) or j (gj) against [rv; rw]
      const bool side_j = t >= 14, bottom = (t & 1) != 0;
      M3 Ta, Tb;
      chain_T_row(msel(side_j, J.Xj, J.Xi), msel(side_j, J.Yj, J.Yi), O, n, i, bottom, Ta, Tb);
      store_v3((side_j ? gj : gi) + (bottom ? 3 * K : 0), K, k, add(mv(Ta, J.c.rv), mv(Tb, J.c.rw)));
    } else {  // H = T J quadrant: T from side i (Hii, Hij) or j (Hjj), J of side i (Hii) or j (Hij, Hjj)
      const int blk = t >> 2;
      const bool bottom = (t & 2) != 0, right = (t & 1) != 0;
      M3 Ta, Tb;
      chain_T_row(msel(blk == 2, J.Xj, J.Xi), msel(blk == 2, J.Yj, J.Yi), O, n, i, bottom, Ta, Tb);
      const M3 X = msel(blk == 0, J.Xi, J.Xj);
      const M3 Q = right ? madd(mul(Ta, msel(blk == 0, J.Yi, J.Yj)), mul(Tb, X)) : mul(Ta, X);
      float* H = blk == 0 ? Hii : blk == 1 ? Hij : Hjj;
      const int r0 = bottom ? 3 : 0, c0 = right ? 3 : 0;
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int q = 0; q < 3; ++q) H[((r0 + p) * 6 + c0 + q) * K + k] = Q.m[p][q];
    }
  }
  return chi;
}

// ---------------------------------------------------------------------------
// the observation slot's linearization and a pose's sums over its slots
// ---------------------------------------------------------------------------

// Slot e's linearization: the residual, its robust rho and IRLS weight, and
// the weighted O' and O'r (ellk_soa.obs_parts)
struct SlotLin { V3 v, Orw; M3 Ow; float rho; };
__device__ __forceinline__ SlotLin slot_linearize(const M3& Rt, const V3& t, const float* lm, const int* ll_rk,
                                                  const float* meas, const float* info, int E, int e, int kind,
                                                  float delta) {
  const ObsSlot s = obs_slot(Rt, t, lm, ll_rk, meas, info, E, e);
  SlotLin out;
  float w;
  robust_rho_w(s.chi, kind, delta, out.rho, w);
  out.v = s.v;
  out.Ow = kind == ROBUST_NONE ? s.O : mscale(s.O, w);
  out.Orw = kind == ROBUST_NONE ? s.Or : scale(s.Or, w);
  return out;
}

// A pose's sums over its slots: the gradient [-O'r; -v x O'r], the 6x6
// diagonal's quadrants [[O', -O'B], [., -hat(v) O'B]] (B = hat(v)), chi2
struct ObsPose { V3 g_top, g_bot; M3 TL, TR, BR; float chi; };
__device__ __forceinline__ ObsPose obs_pose_zero() {
  ObsPose o;
  o.g_top = o.g_bot = v3(0.f, 0.f, 0.f);
  o.TL = o.TR = o.BR = mzero();
  o.chi = 0.f;
  return o;
}
__device__ __forceinline__ void pose_accumulate(ObsPose& o, const SlotLin& s) {
  o.chi += s.rho;
  o.g_top = sub(o.g_top, s.Orw);
  o.g_bot = sub(o.g_bot, cross(s.v, s.Orw));
  const M3 OB = ob_product(s.Ow, s.v);
  o.TL = madd(o.TL, s.Ow);
  o.TR = msub(o.TR, OB);
  o.BR = msub(o.BR, hat_mul(s.v, OB));
}

// ---------------------------------------------------------------------------
// K1's, K3's, K6's and K10's bodies: a pose's slots spread over the grid. A block
// holds POSE_GROUP consecutive poses (one a lane) times G slot groups (one a
// warp) and one chunk [r0, r1) of their slots; the chunks of a pose range are
// blocks of their own. Warp g walks r = r0 + g, r0 + g + G, ... < r1, every
// load coalesced over the 32 poses (slot (r, k) at e = r*K + k).
// ---------------------------------------------------------------------------

// slot groups (warps) a block of K1's, K3's, K6's or K10's slot pass at most
constexpr int MAX_SLOT_GROUPS = 8;

// a pose's partial sums as floats: g_top, g_bot, then TL, TR, BR row-major
constexpr int POSE_PART = 33;
__device__ __forceinline__ void pose_part_store(const ObsPose& o, float* p, int stride) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p[i * stride] = o.g_top.v[i];
    p[(3 + i) * stride] = o.g_bot.v[i];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      p[(6 + 3 * i + j) * stride] = o.TL.m[i][j];
      p[(15 + 3 * i + j) * stride] = o.TR.m[i][j];
      p[(24 + 3 * i + j) * stride] = o.BR.m[i][j];
    }
  }
}
// the part channel of element (i, j) of the 6x6 diagonal (lower left: TR^T)
__device__ __forceinline__ int diag_part_channel(int i, int j) {
  if (i < 3) return j < 3 ? 6 + 3 * i + j : 15 + 3 * i + j - 3;
  return j < 3 ? 15 + 3 * j + i - 3 : 24 + 3 * (i - 3) + j - 3;
}

// K1, thread (lane, g): pose k's slots r = r0 + g, r0 + g + G, ... < r1, v
// and O' out per slot; returns these slots' share of the pose's sums.
__device__ __forceinline__ ObsPose obs_slot_group_linearize(const M3& Rt, const V3& t, const float* lm,
                                                            const float* meas, const float* info, const int* ll_rk,
                                                            int K, int E, int k, int r0, int r1, int g, int G,
                                                            int kind, float delta, float* v_out, float* Ow_out) {
  ObsPose o = obs_pose_zero();
  for (int r = r0 + g; r < r1; r += G) {
    const int e = r * K + k;
    const SlotLin s = slot_linearize(Rt, t, lm, ll_rk, meas, info, E, e, kind, delta);
    store_v3(v_out, E, e, s.v);
    store_m3(Ow_out, E, e, s.Ow);
    pose_accumulate(o, s);
  }
  return o;
}

// K1, one warp per landmark: its gradient Rt^T O'r and block Rt^T O' Rt over
// its CSR segment [j0, j1), each slot's terms computed from the inputs as the
// slot pass computes them (only the CSR's real slots are visited, a small
// share of the R*K at the sessions' graphs, so this reads less than a
// per-slot scratch array would cost to write); lanes stride the segment, then
// a fixed shuffle tree (deterministic); acc[12] (gl, then Hll row-major) is
// valid in lane 0.
__device__ __forceinline__ void landmark_lin_warp(const float* pose, const float* lm, const float* meas,
                                                  const float* info, const int* ll_rk, const int* lm_slots, int j0,
                                                  int j1, int K, int E, int kind, float delta, int lane, float* acc) {
#pragma unroll
  for (int c = 0; c < 12; ++c) acc[c] = 0.f;
  for (int j = j0 + lane; j < j1; j += 32) {
    const int e = lm_slots[j], k = e % K;
    V3 t;
    Q4 q;
    load_pose(pose, K, k, t, q);
    const M3 Rt = rotmat(qconj(q));
    const SlotLin s = slot_linearize(Rt, t, lm, ll_rk, meas, info, E, e, kind, delta);
    const V3 gl = mTv(Rt, s.Orw);
    const M3 H = mulT(Rt, mul(s.Ow, Rt));
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      acc[i] += gl.v[i];
#pragma unroll
      for (int jj = 0; jj < 3; ++jj) acc[3 + 3 * i + jj] += H.m[i][jj];
    }
  }
#pragma unroll
  for (int c = 0; c < 12; ++c)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[c] += __shfl_down_sync(0xffffffffu, acc[c], off);
}

// K3 and K10, thread (lane, g): the robust chi2 of pose k's slots r = r0 +
// g, ... < r1
__device__ __forceinline__ float obs_slot_group_chi2(const M3& Rt, const V3& t, const float* lm, const float* meas,
                                                     const float* info, const int* ll_rk, int K, int E, int k,
                                                     int r0, int r1, int g, int G, int kind, float delta) {
  float chi = 0.f;
  for (int r = r0 + g; r < r1; r += G) {
    float rho, w;
    robust_rho_w(obs_slot(Rt, t, lm, ll_rk, meas, info, E, r * K + k).chi, kind, delta, rho, w);
    chi += rho;
  }
  return chi;
}

// Deterministic block sum of NV values per thread (blockDim.x a multiple of
// 32, at most 1024); the result is valid in thread 0.
template <int NV>
__device__ __forceinline__ void block_sum(float* vals, float* smem /* [32 * NV] */) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
  for (int c = 0; c < NV; ++c)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) vals[c] += __shfl_down_sync(0xffffffffu, vals[c], off);
  __syncthreads();
  if (lane == 0)
#pragma unroll
    for (int c = 0; c < NV; ++c) smem[warp * NV + c] = vals[c];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      float s = lane < nw ? smem[lane * NV + c] : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
      vals[c] = s;
    }
  }
}

// The objective's slot pass, K3's on the whole graph (soa_chi2.cu) and K10's
// on a row range (tiled_chi2.cu, K = Kl rows): block (blockIdx.x, blockIdx.y)
// of a grid of ceil(K / 32) pose ranges x ceil(R / RB) slot chunks, thread
// (lane, g) walking its pose's slots of the chunk (obs_slot_group_chi2). Warp
// 0 of each pose range's first chunk also evaluates the chain edges of its 32
// rows: against pose (k + 1) mod K where succ is nullptr (K3: row K-1 wraps
// to pose 0 and carries zero information), else against succ[:, k] for every
// row (K10: the range's last row meets the next range's first pose, with its
// real information). The block's two partials, observations then chain, go
// to part[b] and part[nb + b] (b = blockIdx.y * gridDim.x + blockIdx.x, nb
// blocks), for reduce2_kernel to add in a fixed order. red [64] is the
// kernel's shared memory.
__device__ __forceinline__ void chi2_slots_block(const float* pose, const float* succ, const float* lm,
                                                 const float* meas, const float* info, const int* ll_rk,
                                                 const float* o_meas, const float* o_info, int K, int R, int RB,
                                                 int kind, float delta, float* part, float* red) {
  const int G = blockDim.x >> 5, lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int k = blockIdx.x * POSE_GROUP + lane, c = blockIdx.y;
  const int r0 = c * RB, r1 = min(R, r0 + RB);
  float s[2] = {0.f, 0.f};  // observations, chain
  if (k < K) {
    V3 t;
    Q4 q;
    load_pose(pose, K, k, t, q);
    s[0] = obs_slot_group_chi2(rotmat(qconj(q)), t, lm, meas, info, ll_rk, K, R * K, k, r0, r1, g, G, kind, delta);
    if (c == 0 && g == 0) {
      V3 tj, mt;
      Q4 qj, mq;
      if (succ) {
        load_pose(succ, K, k, tj, qj);
      } else {
        load_pose(pose, K, k + 1 < K ? k + 1 : 0, tj, qj);
      }
      load_pose(o_meas, K, k, mt, mq);
      s[1] = chain_chi(chain_residual(t, q, tj, qj, mt, mq), load_info6(o_info, K, k));
    }
  }
  block_sum<2>(s, red);
  if (threadIdx.x == 0) {
    const int nb = gridDim.x * gridDim.y, b = blockIdx.y * gridDim.x + blockIdx.x;
    part[b] = s[0];
    part[nb + b] = s[1];
  }
}

// ---------------------------------------------------------------------------
// The two launches of the linearization, K1's (with K2's chain blocks) on the
// whole graph (soa_linearize.cu) and K6's (with K7's) on a row range
// (tiled_linearize.cu, whose arrays are the range's own with K = Kl rows):
//   chain blocks (chain_block), where the chain is in the launch: ceil(K / 32)
//      blocks of 32 consecutive rows (one a lane), in front of the slot
//      blocks so that their longer serial part overlaps them. The rows'
//      information is copied into shared memory (cp.async) while each of the
//      G warps computes the rows' residual and Jacobians (chain_jacobians);
//      then each warp takes its share of a row's 17 output tasks
//      (chain_row_group_linearize), and the block's chain chi2 partial goes
//      after the slot blocks' partials.
//   slot pass, C x ceil(K / 32) slot blocks: block b takes pose range b % n
//      (n = ceil(K / 32)) and slot chunk c = b / n of RB slots. Thread (lane,
//      g) walks its pose's slots of the chunk (obs_slot_group_linearize): v
//      and O' out, the pose's gradient and 6x6 diagonal quadrants summed in
//      registers. The G groups' sums meet in shared memory in the order g =
//      0..G-1 and go to scratch pose_part [C, 33, K]; chunk 0 writes Rt; the
//      block's chi2 partial goes to chi_part[b].
//   fold, three block roles: one warp per landmark walks its slots in the
//      fixed order of the CSR (landmark_lin_warp) into gl and Hll; one thread
//      per pose and output channel adds the C chunk sums in the order c =
//      0..C-1 and the chain's i-side of pose k (gi, Hii), and with fold_j the
//      j-side of pose k-1 (the TPU wrapper's gi + shift_down(gj)); the K6 row
//      range leaves the j-side to the host. The last block adds the chi2
//      partials in index order: the n_slot slot blocks' and then, with the
//      chain in the same launch, its n_chain blocks' that follow them, or else
//      the chain's given chi2.
// Every sum has a fixed order, so a repeat gives the same bits. Empty slots
// have zero information, so everything they add is exactly 0.
// ---------------------------------------------------------------------------

constexpr int FOLD_BLOCK = 128;
constexpr int FOLD_OUT = 42;  // gp (6) and diag (36) channels of a pose

// slot blocks of the slot pass, and scratch floats of the two launches (chunk
// sums, then a chi2 partial per slot block and per chain block)
__host__ __device__ inline long long lin_slot_blocks(int K, int R, int RB) {
  return static_cast<long long>((R + RB - 1) / RB) * ((K + POSE_GROUP - 1) / POSE_GROUP);
}
inline long long lin_scratch(int K, int R, int RB, int n_chain) {
  return static_cast<long long>((R + RB - 1) / RB) * POSE_PART * K + lin_slot_blocks(K, R, RB) + n_chain;
}
// blocks of the fold launch: landmark warps, fold threads, the chi2 block
inline void lin_fold_blocks(int K, int L, int& n_lm, int& n_fold) {
  n_lm = (32 * L + FOLD_BLOCK - 1) / FOLD_BLOCK;
  n_fold = static_cast<int>((static_cast<long long>(FOLD_OUT) * K + FOLD_BLOCK - 1) / FOLD_BLOCK);
}

// slot block b of the slot pass; part [MAX_SLOT_GROUPS * POSE_PART *
// POSE_GROUP] and red [32] are the kernel's shared memory
__device__ __forceinline__ void lin_slots_block(int b, const float* pose, const float* lm, const float* meas,
                                                const float* info, const int* ll_rk, int K, int R, int RB, int kind,
                                                float delta, float* v_out, float* Ow_out, float* Rt_out,
                                                float* pose_part, float* chi_part, float* part, float* red) {
  const int G = blockDim.x >> 5, lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int n = (K + POSE_GROUP - 1) / POSE_GROUP, c = b / n, k0 = (b % n) * POSE_GROUP, k = k0 + lane;
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
    const int ch = i / POSE_GROUP, qq = i % POSE_GROUP;
    if (k0 + qq >= K) continue;
    float s = 0.f;
    for (int gg = 0; gg < G; ++gg) s += part[(gg * POSE_PART + ch) * POSE_GROUP + qq];
    pose_part[(static_cast<long long>(c) * POSE_PART + ch) * K + k0 + qq] = s;
  }
  if (threadIdx.x == 0) chi_part[b] = chi[0];
}

// chain block b (rows [32 b, 32 b + 32), one a lane) of the slot pass's
// launch: the chain edge of row k against pose (k + 1) mod K where succ is
// nullptr (K2: row K-1 wraps to pose 0 and carries zero information), else
// against succ[:, k] for every row (K7: the range's last row meets the next
// range's first pose). Writes Hii, Hij, Hjj, gi, gj of its rows and its chi2
// partial to chi_part[lin_slot_blocks(K, R, RB) + b]. The rows' information
// [36, 32] goes to O (the slot blocks' part[], at least 36 * 32 floats) while
// the warps compute the serial part; red [32] is the kernel's shared memory.
__device__ __forceinline__ void chain_block(int b, const float* pose, const float* succ, const float* o_meas,
                                            const float* o_info, int K, int R, int RB, float* Hii, float* Hij,
                                            float* Hjj, float* gi, float* gj, float* chi_part, float* O,
                                            float* red) {
  const int lane = threadIdx.x & 31, k0 = b * POSE_GROUP, k = k0 + lane;
  for (int i = threadIdx.x; i < 36 * POSE_GROUP; i += blockDim.x) {
    const int c = i / POSE_GROUP, q = i % POSE_GROUP;
    if (k0 + q < K) __pipeline_memcpy_async(O + i, o_info + static_cast<long long>(c) * K + k0 + q, sizeof(float));
  }
  __pipeline_commit();
  ChainJac J;
  if (k < K) {
    V3 ti, tj;
    Q4 qi, qj;
    load_pose(pose, K, k, ti, qi);
    if (succ) {
      load_pose(succ, K, k, tj, qj);
    } else {
      load_pose(pose, K, k + 1 < K ? k + 1 : 0, tj, qj);
    }
    J = chain_jacobians(ti, qi, tj, qj, o_meas, K, k);
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  float chi[1] = {0.f};
  if (k < K) {
    chi[0] = chain_row_group_linearize(J, O, POSE_GROUP, lane, K, k, threadIdx.x >> 5, blockDim.x >> 5, Hii, Hij,
                                       Hjj, gi, gj);
  }
  block_sum<1>(chi, red);
  if (threadIdx.x == 0) chi_part[lin_slot_blocks(K, R, RB) + b] = chi[0];
}

// block b of the fold launch (FOLD_BLOCK threads): blocks [0, n_lm) landmark
// warps, then n_fold blocks of fold threads, then the chi2 block; chi_part
// holds n_slot slot partials and after them n_chain chain partials, or
// n_chain = 0 and chi_given is the chain's chi2; chi_chain, where given,
// receives the chain's share
__device__ __forceinline__ void lin_fold_block(int b, const float* pose, const float* lm, const float* meas,
                                               const float* info, const int* ll_rk, const int* lm_slots,
                                               const int* lm_start, int K, int R, int L, int kind, float delta,
                                               const float* pose_part, int C, const float* gi, const float* Hii,
                                               const float* gj, const float* Hjj, bool fold_j,
                                               const float* chi_part, int n_slot, int n_chain,
                                               const float* chi_given, int n_lm, int n_fold, float* gl, float* Hll,
                                               float* gp, float* diag, float* chi, float* chi_chain) {
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
    // gp = gp_obs + gi[k] (+ gj[k-1]);  diag = diag_obs + Hii[k] (+ Hjj[k-1])
    const int oc = o < 6 ? o : o - 6;
    s += (o < 6 ? gi : Hii)[oc * K + k];
    if (fold_j && k > 0) s += (o < 6 ? gj : Hjj)[oc * K + k - 1];
    (o < 6 ? gp : diag)[oc * K + k] = s;
    return;
  }
  __shared__ float red[64];
  float s[2] = {0.f, 0.f};  // slot blocks, chain
  for (int i = threadIdx.x; i < n_slot; i += FOLD_BLOCK) s[0] += chi_part[i];
  for (int i = threadIdx.x; i < n_chain; i += FOLD_BLOCK) s[1] += chi_part[n_slot + i];
  if (n_chain == 0 && threadIdx.x == 0) s[1] = chi_given[0];
  block_sum<2>(s, red);
  if (threadIdx.x == 0) {
    chi[0] = s[0] + s[1];
    if (chi_chain) chi_chain[0] = s[1];
  }
}

// out[0] = sum(a[0:na]) + sum(b[0:nb]), in a fixed order (one block of 256)
__global__ void __launch_bounds__(256)
reduce2_kernel(const float* __restrict__ a, int na, const float* __restrict__ b, int nb, float* __restrict__ out) {
  __shared__ float smem[64];
  float s[2] = {0.f, 0.f};
  for (int i = threadIdx.x; i < na; i += blockDim.x) s[0] += a[i];
  for (int i = threadIdx.x; i < nb; i += blockDim.x) s[1] += b[i];
  block_sum<2>(s, smem);
  if (threadIdx.x == 0) out[0] = s[0] + s[1];
}

}  // namespace soa
