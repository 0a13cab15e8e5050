// Fused ReLU-MLP regressor forward (the Xling estimator), hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fused_mlp.py::
// mlp_forward_pallas (pl.pallas_call at :64, body _make_kernel at :24):
//   h_0 = x;  h_{l+1} = relu(h_l @ W_l + b_l);  out = h_L[:, 0]
// with no ReLU after the last layer (dout 1), every product in fp32 FMA.
//
// Bound on this card: at the estimator's widths (d0 -> 512 -> 512 -> 256
// -> 128 -> 1) a row costs 2 * (d0*512 + 512*512 + 512*256 + 256*128 + 128)
// fp32 operations against 4*(d0 + 1) bytes of its own input and output,
// so a batch of 8 192 rows at d0 = 201 is 8.7 GFLOP over 8.5 MB (weights
// included): operations bound (~0.13 ms at 67 TFLOP/s vs ~3 us of HBM).
//
// Design. One CTA owns BN rows (32, or 16 when the input is too wide)
// and carries them through every layer without leaving shared memory:
// the activations ping-pong between two buffers stored feature-major
// ([feature][row], stride BN + 4), so a thread reads the 16 rows it
// owns for one feature as four float4 broadcasts. Each thread computes
// work items of 16 rows x 1 output column: per input feature one
// coalesced weight load (all CTAs share the weights through L2 — the
// seven RMI sub-MLPs at d0 = 201 are ~15 MB against 50 MB of L2), four
// float4 loads and 16 FMAs. Bias and ReLU are fused into the store; the
// final 128 -> 1 layer is a per-row dot done by one warp, lane = row.
#include <cuda_runtime.h>

namespace {

constexpr int MAX_LAYERS = 8;
constexpr int THREADS = 256;
constexpr int RPT = 16;         // rows per work item

struct MlpArgs {
  const float* w[MAX_LAYERS];   // [din, dout] row-major (JAX layout)
  const float* b[MAX_LAYERS];   // [dout]
  int dims[MAX_LAYERS + 1];
  int n_layers;
};

__global__ void __launch_bounds__(THREADS)
mlp_forward_kernel(const float* __restrict__ x, float* __restrict__ out,
                   int n, int bn, int size0, MlpArgs args) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = bn + 4;
  float* buf[2] = {smem, smem + (size_t)size0 * ld};
  const int row0 = blockIdx.x * bn;
  const int tid = threadIdx.x;
  const int d0 = args.dims[0];

  for (int i = tid; i < bn * d0; i += THREADS) {
    const int rr = i / d0, k = i % d0, g = row0 + rr;
    buf[0][k * ld + rr] = g < n ? x[(size_t)g * d0 + k] : 0.f;
  }
  __syncthreads();

  for (int l = 0; l < args.n_layers; ++l) {
    const float* in = buf[l & 1];
    float* o = buf[(l + 1) & 1];
    const int din = args.dims[l], dout = args.dims[l + 1];
    const float* __restrict__ W = args.w[l];
    const float* __restrict__ B = args.b[l];
    if (l + 1 == args.n_layers) {
      // final layer (dout == 1): out[row] = h[row, :] . W[:, 0] + b
      if (tid < bn) {
        float s = 0.f;
        for (int k = 0; k < din; ++k) s = fmaf(in[k * ld + tid], __ldg(W + k), s);
        if (row0 + tid < n) out[row0 + tid] = s + __ldg(B);
      }
      break;
    }
    const int nrb = bn / RPT;
    for (int item = tid; item < dout * nrb; item += THREADS) {
      const int c = item % dout, rb = item / dout;
      float acc[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) acc[r] = 0.f;
      const float* col = in + rb * RPT;
      for (int k = 0; k < din; ++k) {
        const float w = __ldg(W + (size_t)k * dout + c);
        const float4* h = reinterpret_cast<const float4*>(col + k * ld);
#pragma unroll
        for (int v = 0; v < RPT / 4; ++v) {
          const float4 hv = h[v];
          acc[4 * v + 0] = fmaf(hv.x, w, acc[4 * v + 0]);
          acc[4 * v + 1] = fmaf(hv.y, w, acc[4 * v + 1]);
          acc[4 * v + 2] = fmaf(hv.z, w, acc[4 * v + 2]);
          acc[4 * v + 3] = fmaf(hv.w, w, acc[4 * v + 3]);
        }
      }
      const float bias = __ldg(B + c);
      float4* dst = reinterpret_cast<float4*>(o + c * ld + rb * RPT);
#pragma unroll
      for (int v = 0; v < RPT / 4; ++v)
        dst[v] = make_float4(fmaxf(acc[4 * v + 0] + bias, 0.f),
                             fmaxf(acc[4 * v + 1] + bias, 0.f),
                             fmaxf(acc[4 * v + 2] + bias, 0.f),
                             fmaxf(acc[4 * v + 3] + bias, 0.f));
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// x f32 [n, dims[0]]; w[l] f32 [dims[l], dims[l+1]], b[l] f32
// [dims[l+1]], dims[n_layers] == 1; out f32 [n]; all contiguous device
// memory. bn (16 or 32) rows per CTA; `size0`/`size1` feature rows of the
// two activation buffers. Launches on `stream`, returns its cudaError_t.
int mlp_forward(const float* x, float* out, const void* const* w,
                const void* const* b, const int* dims, int n_layers, int n,
                int bn, int size0, int size1, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_layers < 1 || n_layers > MAX_LAYERS || bn % RPT != 0 || bn > 32 ||
      dims[n_layers] != 1)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  MlpArgs args;
  for (int l = 0; l < n_layers; ++l) {
    args.w[l] = static_cast<const float*>(w[l]);
    args.b[l] = static_cast<const float*>(b[l]);
  }
  for (int l = 0; l <= n_layers; ++l) args.dims[l] = dims[l];
  args.n_layers = n_layers;
  const size_t smem = (size_t)(size0 + size1) * (bn + 4) * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(mlp_forward_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((n + bn - 1) / bn);
  mlp_forward_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, out, n, bn, size0, args);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
