// IVF-PQ ADC ranking of a candidate pool, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/adc_rank.py::adc_rank_pallas
// (pl.pallas_call at :174, body _kernel at :106). For each query row q:
//   lut[mi][c] = (qq - 2 * dot) + cc             (per PQ segment mi, codeword c)
//     qq  = sum_s q[mi*seg+s]^2, dot = sum_s q[mi*seg+s] * cb[mi][c][s],
//     cc  = sum_s cb[mi][c][s]^2, each a sum in ascending s from 0.0f
//   adc[lane] = sum over mi = 0 .. m-1, in that order, of lut[mi][codes[id][mi]]
//               (from 0.0f), with id = cand[q][lane]; +inf where id < 0
//   out[q][:] = cand[q][lanes of the n_cand smallest adc, ascending,
//                       the lower lane first on ties]
// which is jax.lax.top_k(-adc)'s order. Every multiply and add rounds on
// its own (__fmul_rn / __fadd_rn, never contracted to an FMA), in the same
// order as the plain PyTorch version in kernels/adc_rank.py, so the two
// select the same lanes bit for bit.
//
// Bound on this card: bytes. The pool is read once (4 * b * C bytes: at
// the main path's C = 50 probed lists x 1 702 = 85 100 lanes that is
// 340 KB per query, mostly -1 padding), the code rows of the live lanes
// come from the 3 MB code table, which stays in L2, and the LUT costs
// 6 * m * 256 * seg operations per query. At b 4096 the pool alone is
// 1.4 GB: ~0.42 ms at 3.35 TB/s.
//
// Design. One CTA per query row; the TPU kernel's [Bb, C, 256] one-hot
// budget does not scale to an 85 k-lane pool, so nothing here is sized by C
// except a global scratch row of C keys the wrapper allocates.
//   1. The m x 256 LUT is built in shared memory (<= 32 KB for m <= 32).
//   2. Every lane is scored and its orderable 32-bit key (the float's bits
//      mapped so that unsigned order is float order) goes to the scratch
//      row, while a shared 256-bin histogram counts the top key byte.
//   3. Radix select finds the n_cand-th smallest key T in four 8-bit
//      passes (the first histogram comes free with the scoring pass).
//   4. One ordered pass over the lanes collects every key < T and the
//      lowest-lane keys == T (a block-wide ballot scan keeps lane order for
//      the ties) as 64-bit (key << 32 | lane) into shared memory, over the
//      LUT, which is dead by then.
//   5. A bitonic sort of those n_cand unique 64-bit keys gives the order,
//      and the candidate ids are written. With fewer than n_cand live
//      lanes the +inf lanes fill the tail, lowest lane first, ids -1.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr uint32_t INF_KEY = 0xFF800000u;      // orderable key of +inf

__device__ __forceinline__ uint32_t orderable(float f) {
  if (f == 0.0f) f = 0.0f;                     // -0 ranks as +0
  if (f != f) return 0xFFFFFFFFu;              // NaN after +inf
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__global__ void __launch_bounds__(THREADS)
adc_rank_kernel(const float* __restrict__ q, const float* __restrict__ cb,
                const int* __restrict__ cand, const uint8_t* __restrict__ codes,
                int* __restrict__ out, uint32_t* __restrict__ scratch,
                int C, int m, int seg, int n_cand, int sort_n) {
  extern __shared__ unsigned long long smem8[];
  unsigned long long* sortbuf = smem8;                  // [sort_n], after 2.
  float* lut = reinterpret_cast<float*>(smem8);          // [m * 256], 1.-2.
  const int region = max(sort_n * 2, m * 256);          // in 4-byte words
  float* qrow = reinterpret_cast<float*>(smem8) + region;        // [m * seg]
  uint32_t* hist = reinterpret_cast<uint32_t*>(qrow + m * seg);  // [256]
  int* warp_tot = reinterpret_cast<int*>(hist + 256);            // [WARPS]
  __shared__ uint32_t prefix, mask;
  __shared__ int need, n_lt, tie_base;

  const int tid = threadIdx.x, lane_id = tid & 31, warp = tid >> 5;
  const long long row = blockIdx.x;
  const int dim = m * seg;
  const int* cand_row = cand + row * C;
  uint32_t* keys = scratch + row * C;

  for (int i = tid; i < dim; i += THREADS) qrow[i] = q[row * dim + i];
  for (int i = tid; i < 256; i += THREADS) hist[i] = 0;
  __syncthreads();

  // 1. LUT, one entry per (segment, codeword), fixed arithmetic order
  for (int e = tid; e < m * 256; e += THREADS) {
    const int mi = e >> 8;
    const float* qs = qrow + mi * seg;
    const float* cs = cb + (long long)e * seg;
    float qq = 0.0f, dot = 0.0f, cc = 0.0f;
    for (int s = 0; s < seg; ++s) {
      const float a = qs[s], c = cs[s];
      qq = __fadd_rn(qq, __fmul_rn(a, a));
      dot = __fadd_rn(dot, __fmul_rn(a, c));
      cc = __fadd_rn(cc, __fmul_rn(c, c));
    }
    lut[e] = __fadd_rn(__fsub_rn(qq, __fmul_rn(2.0f, dot)), cc);
  }
  __syncthreads();

  // 2. score every lane; histogram of the top key byte
  for (int c = tid; c < C; c += THREADS) {
    const int id = cand_row[c];
    uint32_t key = INF_KEY;
    if (id >= 0) {
      const uint8_t* code = codes + (long long)id * m;
      float adc = 0.0f;
      for (int mi = 0; mi < m; ++mi)
        adc = __fadd_rn(adc, lut[(mi << 8) + code[mi]]);
      key = orderable(adc);
    }
    keys[c] = key;
    atomicAdd(&hist[key >> 24], 1u);
  }
  if (tid == 0) { prefix = 0u; mask = 0u; need = n_cand; }
  __syncthreads();

  // 3. radix select of the n_cand-th smallest key, 8 bits a pass
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    if (pass > 0) {
      for (int i = tid; i < 256; i += THREADS) hist[i] = 0;
      __syncthreads();
      const uint32_t p = prefix, mk = mask;
      for (int c = tid; c < C; c += THREADS) {
        const uint32_t key = keys[c];
        if ((key & mk) == p) atomicAdd(&hist[(key >> shift) & 255u], 1u);
      }
      __syncthreads();
    }
    if (tid == 0) {
      int below = 0, d = 0;
      for (; d < 255; ++d) {
        if (below + (int)hist[d] >= need) break;
        below += (int)hist[d];
      }
      need -= below;
      prefix |= (uint32_t)d << shift;
      mask |= 255u << shift;
    }
    __syncthreads();
  }

  // 4. collect keys < T (any order) and the lowest lanes of keys == T
  const uint32_t T = prefix;
  const int take_ties = need;
  if (tid == 0) { n_lt = 0; tie_base = 0; }
  __syncthreads();
  const int lt_slots = n_cand - take_ties;
  for (int base = 0; base < C; base += THREADS) {
    const int c = base + tid;
    const uint32_t key = c < C ? keys[c] : 0xFFFFFFFFu;
    const bool lt = c < C && key < T;
    const bool eq = c < C && key == T;
    const unsigned bal = __ballot_sync(0xFFFFFFFFu, eq);
    if (lane_id == 0) warp_tot[warp] = __popc(bal);
    __syncthreads();
    int rank = tie_base + __popc(bal & ((1u << lane_id) - 1u));
    int total = 0;
    for (int w = 0; w < WARPS; ++w) {
      if (w < warp) rank += warp_tot[w];
      total += warp_tot[w];
    }
    const unsigned long long lane_bits = (unsigned long long)(uint32_t)c;
    if (lt) {
      const int slot = atomicAdd(&n_lt, 1);
      sortbuf[slot] = ((unsigned long long)key << 32) | lane_bits;
    } else if (eq && rank < take_ties) {
      sortbuf[lt_slots + rank] = ((unsigned long long)key << 32) | lane_bits;
    }
    __syncthreads();
    if (tid == 0) tie_base += total;
  }
  for (int i = n_cand + tid; i < sort_n; i += THREADS) sortbuf[i] = ~0ULL;
  __syncthreads();

  // 5. bitonic sort of the selected keys, then write the ids in order
  for (int k = 2; k <= sort_n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < sort_n; i += THREADS) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long a = sortbuf[i], b = sortbuf[ixj];
          const bool up = (i & k) == 0;
          if ((a > b) == up) { sortbuf[i] = b; sortbuf[ixj] = a; }
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < n_cand; i += THREADS)
    out[row * n_cand + i] = cand_row[(uint32_t)(sortbuf[i] & 0xFFFFFFFFull)];
}

int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA.
size_t adc_rank_smem_bytes(int m, int seg, int n_cand) {
  const int sort_n = next_pow2(n_cand < 2 ? 2 : n_cand);
  const int region = (sort_n * 2 > m * 256) ? sort_n * 2 : m * 256;
  return (size_t)(region + m * seg + 256 + WARPS) * 4;
}

// q f32 [b, m*seg], codebooks f32 [m, 256, seg], cand int32 [b, C] (-1
// padded, live ids < n), codes uint8 [n, m], out int32 [b, n_cand],
// scratch uint32 [b, C]; all contiguous device memory, 1 <= n_cand <= C.
// Launches on `stream` and returns the cudaError_t of the launch.
int adc_rank(const float* q, const float* codebooks, const int* cand,
             const uint8_t* codes, int* out, uint32_t* scratch, int b, int C,
             int m, int seg, int n_cand, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b <= 0 || n_cand <= 0) return 0;
  const int sort_n = next_pow2(n_cand < 2 ? 2 : n_cand);
  const size_t smem = adc_rank_smem_bytes(m, seg, n_cand);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(adc_rank_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  adc_rank_kernel<<<b, THREADS, smem, (cudaStream_t)stream>>>(
      q, codebooks, cand, codes, out, scratch, C, m, seg, n_cand, sort_n);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
