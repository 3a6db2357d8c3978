// RANSAC hypothesis scoring for the plane extractor, written for Hopper (sm_90a).
//
// Replaces the TPU kernel semantic_slam_tpu/frontend/pallas_kernels.py
// `_score_kernel` (wrapper `score_hypotheses_pallas`). For every detection d,
// every point p and every plane hypothesis s it counts p as an inlier of s when
//   |p . n_s + d_s| < dist_thres  and  n_p . n_s > cos_thres  and  cand[d, p],
// and writes the per-hypothesis counts. The [N, S] intermediate never leaves
// registers.
//
// What bounds it: FP32 compares on the CUDA cores. The extractor's shape is
// D=8 detections x N=65,536 points x S=128 hypotheses = 67 M point-hypothesis
// tests per RANSAC round, ~12 instructions each, against 28 bytes read per
// point (15 MB per round). So the design keeps every point in registers and
// streams the hypotheses from shared memory:
//   * grid = (point chunks, detections); a block stages its detection's S
//     hypotheses as float4 (n, d) in shared memory, read as warp broadcasts;
//   * each thread holds PTS_PER_THREAD points and tests them against all S;
//   * a warp sums its per-thread counts for one hypothesis with one
//     __reduce_add_sync; lane j keeps the sum for hypothesis s0 + j, so 32
//     hypotheses cost one shared-memory atomic per lane;
//   * one global atomicAdd per block and hypothesis into int32 counts.
// Integer atomics keep the counts exact and independent of the order in which
// blocks finish. The ragged tail (N not a multiple of the chunk) is masked.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PTS_PER_THREAD = 4;
constexpr int CHUNK = THREADS * PTS_PER_THREAD;

__global__ void __launch_bounds__(THREADS)
score_kernel(const float* __restrict__ pts, const float* __restrict__ nrm,
             const uint8_t* __restrict__ cand, const float* __restrict__ hyp_n,
             const float* __restrict__ hyp_d, int N, int S, float dist_thres,
             float cos_thres, int* __restrict__ counts) {
  extern __shared__ float4 smem[];
  float4* hyp = smem;                               // [S] (nx, ny, nz, d)
  int* cnt = reinterpret_cast<int*>(smem + S);      // [S]
  const int det = blockIdx.y;
  const size_t hoff = static_cast<size_t>(det) * S;

  for (int s = threadIdx.x; s < S; s += THREADS) {
    const float* hn = hyp_n + (hoff + s) * 3;
    hyp[s] = make_float4(hn[0], hn[1], hn[2], hyp_d[hoff + s]);
    cnt[s] = 0;
  }

  float px[PTS_PER_THREAD], py[PTS_PER_THREAD], pz[PTS_PER_THREAD];
  float nx[PTS_PER_THREAD], ny[PTS_PER_THREAD], nz[PTS_PER_THREAD];
  bool ok[PTS_PER_THREAD];
  const size_t poff = static_cast<size_t>(det) * N;
#pragma unroll
  for (int k = 0; k < PTS_PER_THREAD; ++k) {
    const int p = blockIdx.x * CHUNK + k * THREADS + threadIdx.x;
    ok[k] = p < N && cand[poff + p] != 0;
    const size_t q = (poff + (p < N ? p : 0)) * 3;
    px[k] = pts[q]; py[k] = pts[q + 1]; pz[k] = pts[q + 2];
    nx[k] = nrm[q]; ny[k] = nrm[q + 1]; nz[k] = nrm[q + 2];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int n_here = min(32, S - s0);  // uniform across the block
    int mine = 0;
    for (int j = 0; j < n_here; ++j) {
      const float4 h = hyp[s0 + j];
      int c = 0;
#pragma unroll
      for (int k = 0; k < PTS_PER_THREAD; ++k) {
        const float dist = fabsf(fmaf(pz[k], h.z, fmaf(py[k], h.y, px[k] * h.x)) + h.w);
        const float align = fmaf(nz[k], h.z, fmaf(ny[k], h.y, nx[k] * h.x));
        c += (ok[k] && dist < dist_thres && align > cos_thres) ? 1 : 0;
      }
      const int warp_sum = __reduce_add_sync(0xffffffffu, c);
      if (lane == j) mine = warp_sum;
    }
    if (lane < n_here && mine != 0) atomicAdd(&cnt[s0 + lane], mine);
  }
  __syncthreads();

  for (int s = threadIdx.x; s < S; s += THREADS) {
    if (cnt[s] != 0) atomicAdd(&counts[hoff + s], cnt[s]);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() of the launch (0 = ok).
// `counts` [D, S] int32 must be zeroed by the caller on the same stream.
extern "C" int score_hypotheses_launch(const float* pts, const float* nrm,
                                       const uint8_t* cand, const float* hyp_n,
                                       const float* hyp_d, int D, int N, int S,
                                       float dist_thres, float cos_thres,
                                       int* counts, void* stream) {
  if (D == 0 || N == 0 || S == 0) return 0;
  const dim3 grid((N + CHUNK - 1) / CHUNK, D);
  const size_t smem = static_cast<size_t>(S) * (sizeof(float4) + sizeof(int));
  score_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      pts, nrm, cand, hyp_n, hyp_d, N, S, dist_thres, cos_thres, counts);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* slam_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
