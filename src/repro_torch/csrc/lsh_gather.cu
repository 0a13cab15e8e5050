// LSH member-table bucket gather with multiprobe dedup, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/lsh_gather.py::
// lsh_bucket_gather_pallas (pl.pallas_call at :121, body _kernel at :80):
//   out[q, t, j*cap + c] = tables[t, pb[q, t, j], c]       int32
// except that a probe j whose bucket id equals an earlier probe j' < j of
// the same (q, t) pair writes a block of -1 (the empty-slot sentinel), as
// lsh_probe_dup_mask (:55) defines. Integers only: the output is
// bit-identical to the plain gather.
//
// The TPU kernel gathers rows with a one-hot MXU product over 16-bit
// halves of the ids, because Pallas on a TPU has no gather. That is a TPU
// workaround and is not carried over: here each bucket row is `cap`
// contiguous int32 and is copied directly.
//
// Bound on this card: bytes. Per (q, t, j) it reads one probe id and one
// bucket row and writes one row: 4 * q * l * p * (1 + 2 * cap) bytes,
// ~16 MB at q 4096, l 10, p 4, cap 12, i.e. ~5 us at 3.35 TB/s. At that
// size a launch (~3-5 us) is as long as the work: expect it to be
// launch-bound.
//
// Design. One thread per output id, THREADS per CTA, so a CTA owns a
// contiguous run of (query, table) pairs. Consecutive threads write
// consecutive output ids and read consecutive ids of one bucket row, so
// both the row reads and the writes are coalesced; the probe ids of a
// pair are read by every thread of its run and hit L1. Each thread
// compares its probe with the earlier probes of its pair (p compares at
// most), so any l, B, cap and p work, including the re-bucketed path
// where p is n_probes * fanout.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
lsh_bucket_gather_kernel(const int* __restrict__ tables,
                         const int* __restrict__ pb, int* __restrict__ out,
                         long long total, int l, int nb, int cap, int p) {
  const long long width = (long long)p * cap;          // ids per (q, t)
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long o = (long long)blockIdx.x * THREADS + threadIdx.x; o < total;
       o += stride) {
    const long long pair = o / width;                  // q * l + t
    const int rem = (int)(o - pair * width);
    const int j = rem / cap;
    const int c = rem - j * cap;
    const int t = (int)(pair % l);
    const int* probes = pb + pair * p;
    const int bucket = probes[j];
    bool dup = false;
    for (int jp = 0; jp < j; ++jp) dup |= (probes[jp] == bucket);
    out[o] = dup ? -1 : tables[((long long)t * nb + bucket) * cap + c];
  }
}

}  // namespace

extern "C" {

// tables int32 [l, nb, cap], pb int32 [q, l, p] with 0 <= pb < nb,
// out int32 [q, l * p * cap]; all contiguous device memory. Launches on
// `stream` and returns the cudaError_t of the launch.
int lsh_bucket_gather(const int* tables, const int* pb, int* out, int q,
                      int l, int nb, int cap, int p, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)q * l * p * cap;
  if (total <= 0) return 0;
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;        // grid-stride beyond
  lsh_bucket_gather_kernel<<<(unsigned)blocks, THREADS, 0,
                             (cudaStream_t)stream>>>(tables, pb, out, total,
                                                     l, nb, cap, p);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
