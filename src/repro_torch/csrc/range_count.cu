// Fused pairwise-distance + eps-histogram range count, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/range_count.py::
// range_count_hist_pallas (pl.pallas_call at :117, body _kernel at :54):
//   counts[i, j] = #{ k < nr_valid : d(q_i, r_k) <= eps_j }   int32 [nq, m]
// with d = 1 - q.r (cosine) or sqrt(max(2 - 2 q.r, 0)) (l2), every dot in
// plain fp32 FMA (no TF32: a 10-bit mantissa would flip counts near eps).
//
// Bound on this card: operations. The sweep does 2 * nq * nr * d fp32
// operations on nq*d + nr*d + m input words, e.g. the 120 000 x 120 000
// x 200 ground-truth table is 5.76 TFLOP over 96 MB: ~86 ms at the 67
// TFLOP/s fp32 (non-tensor) peak against ~0.03 ms of memory traffic.
//
// Design. One CTA owns BQ = 64 query rows and loops over ALL of R in
// BR = 64-row tiles, so the histogram of its rows never leaves shared
// memory and no cross-CTA reduction or output atomics are needed (the
// TPU kernel's sequential r grid axis becomes this loop). q and r tiles
// are staged through shared memory BK = 16 features at a time; each of
// the 256 threads accumulates a 4 x 4 block of dots in registers. Each
// distance finds its first eps bin by binary search in the sorted grid
// (d <= eps_j  <=>  j >= lower_bound(eps, d)) and increments that bin of
// the row's shared histogram; a prefix sum at the end turns bins into
// counts. For sorted eps this equals the TPU kernel's m compares, ties
// included. R rows at or past nr_valid are never loaded or counted, so
// any padding of R is masked exactly, for every eps.
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;          // query rows per CTA
constexpr int BR = 64;          // R rows per staged tile
constexpr int BK = 16;          // features per staged chunk
constexpr int THREADS = 256;    // 16 x 16 threads, TM x TM dots each
constexpr int TM = 4;
constexpr int LD = BQ + 1;      // padded shared stride (bank spread)

__device__ __forceinline__ int first_bin(const float* eps, int m, float d) {
  if (d != d) return m;         // NaN is within no eps
  int lo = 0, hi = m;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (eps[mid] < d) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
range_count_hist_kernel(const float* __restrict__ q, const float* __restrict__ r,
                        const float* __restrict__ eps, int* __restrict__ out,
                        int nq, int nr_valid, int d, int m, int l2) {
  extern __shared__ float smem[];
  float* Qs = smem;                       // [BK][LD], feature-major
  float* Rs = Qs + BK * LD;               // [BK][LD]
  float* eps_s = Rs + BK * LD;            // [m]
  int* hist = reinterpret_cast<int*>(eps_s + m);   // [BQ][m]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BQ;

  for (int i = tid; i < m; i += THREADS) eps_s[i] = eps[i];
  for (int i = tid; i < BQ * m; i += THREADS) hist[i] = 0;

  for (int r0 = 0; r0 < nr_valid; r0 += BR) {
    float acc[TM][TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += BK) {
      __syncthreads();                    // previous chunk fully consumed
      for (int i = tid; i < BQ * BK; i += THREADS) {
        const int row = i / BK, col = i % BK, gk = k0 + col;
        const int gq = q0 + row, gr = r0 + row;
        Qs[col * LD + row] =
            (gq < nq && gk < d) ? q[(size_t)gq * d + gk] : 0.f;
        Rs[col * LD + row] =
            (gr < nr_valid && gk < d) ? r[(size_t)gr * d + gk] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float a[TM], b[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = Qs[k * LD + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < TM; ++j) b[j] = Rs[k * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = ty + 16 * i;
      if (q0 + row >= nq) continue;
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        if (r0 + tx + 16 * j >= nr_valid) continue;
        const float c = acc[i][j];
        const float dist = l2 ? sqrtf(fmaxf(__fsub_rn(2.f, __fmul_rn(2.f, c)), 0.f))
                              : __fsub_rn(1.f, c);
        const int bin = first_bin(eps_s, m, dist);
        if (bin < m) atomicAdd(&hist[row * m + bin], 1);
      }
    }
  }
  __syncthreads();

  for (int row = tid; row < BQ; row += THREADS) {
    const int gq = q0 + row;
    if (gq >= nq) continue;
    int run = 0;
    for (int j = 0; j < m; ++j) {
      run += hist[row * m + j];
      out[(size_t)gq * m + j] = run;
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA for an m-value eps grid.
size_t range_count_smem_bytes(int m) {
  return (size_t)(2 * BK * LD + m) * sizeof(float) + (size_t)BQ * m * sizeof(int);
}

// q f32 [nq, d], r f32 [>= nr_valid, d], eps f32 [m] sorted ascending,
// out int32 [nq, m]; all contiguous device memory. Launches on `stream`
// and returns the cudaError_t of the launch.
int range_count_hist(const float* q, const float* r, const float* eps, int* out,
                     int nq, int nr_valid, int d, int m, int l2, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nq <= 0 || m <= 0) return 0;
  const size_t smem = range_count_smem_bytes(m);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(range_count_hist_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((nq + BQ - 1) / BQ);
  range_count_hist_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      q, r, eps, out, nq, nr_valid, d, m, l2);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
