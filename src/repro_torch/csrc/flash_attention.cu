// Causal / GQA flash-attention forward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_pallas (pl.pallas_call at :121, body _kernel at :36-90):
//   s = (q . k) * scale in f32, scale = 1/sqrt(Dk);
//   s = -1e30 where key >= kv_valid, or key > query when causal;
//   online softmax: m_new = max(m, max s), p = exp(s - m_new) (0 where
//   masked), alpha = exp(m - m_new), l = l*alpha + sum p,
//   acc = acc*alpha + p.astype(v.dtype) @ v (f32 accumulate);
//   out = acc / max(l, 1e-30) in q's dtype.
// q [B,S,H,Dk], k [B,T,K,Dk], v [B,T,K,Dv], read by strides (last dim
// contiguous); query head h reads kv head h / (H/K); out [B,S,H,Dv]
// contiguous. Any S and T: the ragged last query tile and the keys at or
// past kv_valid are masked here, so the caller pads nothing.
//
// Bound on this card: causal prefill does 4*B*H*Dk*S(S+1)/2 operations
// (two products, the causal half) against (q + k + v + out) bytes read
// and written once; at TinyLlama's layer (B 8, S 4096, H 32, K 4, D 64,
// bf16) that is 550 GFLOP over 302 MB: operations bound, 0.56 ms at
// 989 TFLOP/s bf16 against 0.09 ms of HBM traffic (the f32
// instantiation runs on the CUDA cores: 67 TFLOP/s).
//
// Design. The TPU grid (B*K, n_q, n_kv) carries m/l/acc in VMEM scratch
// across a sequential kv axis; CTAs on Hopper run in no order, so here
// one CTA owns one (b, h, query tile) and loops over the kv tiles itself,
// stopping at the last tile that a query of the tile can see (causal
// block skipping; tiles are issued heaviest first). The kv tile in shared
// memory is reread from L2 by the H/K query heads and the query tiles of
// one (b, kv head), which neighbouring CTAs share.
//  * bf16 (Dk = Dv in {16, 32, 64, 128}): 4 warps x 16 query rows = 64 rows,
//    64-key tiles, double-buffered: cp.async brings tile j + 1 into
//    shared memory while tile j computes. QK^T and PV run on the tensor
//    cores as mma.sync.m16n8k16 (bf16 in, f32 accumulate), operands read
//    from shared memory with ldmatrix (V transposed by ldmatrix.trans).
//    The score fragment stays in registers: its f32 values give m, p and
//    l, and p rounded to bf16 is the A operand of PV without leaving the
//    registers (the C layout of two 8-column tiles is the A layout of
//    one 16-deep step). Rows padded by 8 elements keep ldmatrix free of
//    bank conflicts. Only tiles that cross a warp's diagonal or kv_valid
//    are masked, and exp is the SFU's (__expf: ex2 of x log2 e, a few
//    ulps from expf, far inside bf16's rounding of p).
//  * f32 (any Dk, Dv <= 128): CUDA-core FMA, no TF32. 32 query rows x
//    32-key tiles, 4 threads per query row; scores and p go through a
//    small shared tile.
// wgmma, TMA and a producer warp are for a later kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_ss, q_sh;   // element strides of q over b, s, h
  long long k_sb, k_st, k_sk;
  long long v_sb, v_st, v_sk;
  int S, H, T, K, kv_valid, causal;
  float scale;
};

__device__ __forceinline__ bool live(int key, int qpos, int kv_valid,
                                     int causal) {
  return key < kv_valid && (!causal || key <= qpos);
}

// Keys of one query tile: all up to kv_valid, and for causal attention
// none past the tile's last query.
__device__ __forceinline__ int kv_end(const Args& a, int q0, int bq) {
  int end = a.kv_valid;
  if (a.causal) end = min(end, min(q0 + bq, a.S));
  return end;
}

// ------------------------------------------------ bf16: tensor cores
constexpr int BQ = 64, BKV = 64, THREADS = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  // 16 bytes global -> shared without the registers; 0 bytes read (the
  // chunk zero-filled) where !valid
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(smem)), "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// rows x D bf16 from global (row stride `ld_g` elements, 16-byte chunks)
// into shared memory at row stride `ld_s`, asynchronously; rows >= n_rows
// (n_rows >= 1) are zero.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int ld_s,
                                          const __nv_bfloat16* src,
                                          long long ld_g, int rows,
                                          int n_rows) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < rows * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = r < n_rows;
    cp_async16(dst + r * ld_s + c, src + (ok ? (long long)r * ld_g + c : 0), ok);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_bf16_kernel(Args a) {
  constexpr int LD = D + 8;
  extern __shared__ uint4 smem4[];
  // Q tile, then two (K, V) tile buffers: tile j + 1 loads while j computes
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* sKV = sQ + BQ * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;     // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.K);
  const int q0 = qt * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(a.q) +
                            b * a.q_sb + h * a.q_sh + (long long)q0 * a.q_ss;
  const __nv_bfloat16* kp =
      static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + kvh * a.k_sk;
  const __nv_bfloat16* vp =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + kvh * a.v_sk;

  const int n_tiles = (kv_end(a, q0, BQ) + BKV - 1) / BKV;
  load_tile<D>(sQ, LD, qp, a.q_ss, BQ, a.S - q0);
  if (n_tiles > 0) {
    load_tile<D>(sKV, LD, kp, a.k_st, BKV, a.kv_valid);
    load_tile<D>(sKV + BKV * LD, LD, vp, a.v_st, BKV, a.kv_valid);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // A fragments of this warp's 16 query rows, all D/16 depth steps
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(qf[kk], sQ + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                        kk * 16 + (lane >> 4) * 8);

  // this thread's rows: g and g + 8 of the warp's 16; columns 2t, 2t + 1
  const int g = lane >> 2, t = lane & 3;
  const int qpos0 = q0 + warp * 16 + g;
  float m_r[2] = {NEG, NEG}, l_r[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  const int wq0 = q0 + warp * 16;                  // this warp's first row
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BKV;
    const __nv_bfloat16* sK = sKV + (j & 1) * 2 * BKV * LD;
    const __nv_bfloat16* sV = sK + BKV * LD;
    if (j + 1 < n_tiles) {
      __nv_bfloat16* nK = sKV + ((j + 1) & 1) * 2 * BKV * LD;
      load_tile<D>(nK, LD, kp + (long long)(k0 + BKV) * a.k_st, a.k_st, BKV,
                   a.kv_valid - k0 - BKV);
      load_tile<D>(nK + BKV * LD, LD, vp + (long long)(k0 + BKV) * a.v_st,
                   a.v_st, BKV, a.kv_valid - k0 - BKV);
      cp_async_commit();
      cp_async_wait<1>();                          // tile j has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // a tile wholly below the warp's diagonal and inside kv_valid needs no
    // mask (warp-uniform)
    const bool need_mask =
        k0 + BKV > a.kv_valid || (a.causal && k0 + BKV - 1 > wq0);

    // s = q k^T: 16 rows x 64 keys, 8 column tiles of 8
    float s[BKV / 8][4];
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < BKV / 8; nt += 2) {
        uint32_t kb[4];
        ldsm_x4(kb, sK + ((nt + (lane >> 4)) * 8 + (lane & 7)) * LD + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        mma_bf16(s[nt], qf[kk], kb[0], kb[1]);
        mma_bf16(s[nt + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // scale, mask, running max (the 4 threads of a row are lanes 4g..4g+3)
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * t + (e & 1);
        const float x = s[nt][e] * a.scale;
        s[nt][e] = !need_mask || live(key, qpos0 + (e >> 1) * 8, a.kv_valid,
                                      a.causal) ? x : NEG;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) alpha[i] = __expf(m_r[i] - mx[i]);
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * t + (e & 1);
        const float p = !need_mask || live(key, qpos0 + (e >> 1) * 8,
                                           a.kv_valid, a.causal)
                            ? __expf(s[nt][e] - mx[e >> 1]) : 0.f;
        s[nt][e] = p;
        rs[e >> 1] += p;
      }
    }
    // l is kept per thread (its 16 columns) and summed over the row's four
    // threads at the end: the update is linear in l
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l_r[i] = l_r[i] * alpha[i] + rs[i];
      m_r[i] = mx[i];
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // acc += p (bf16) v: 16 keys a step; p's C fragments are the A operand
#pragma unroll
    for (int ks = 0; ks < BKV / 16; ++ks) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
      pa[1] = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
      pa[2] = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
      pa[3] = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
#pragma unroll
      for (int dt = 0; dt < D / 8; dt += 2) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, sV + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                              (dt + (lane >> 4)) * 8);
        mma_bf16(acc[dt], pa, vb[0], vb[1]);
        mma_bf16(acc[dt + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();                 // this buffer is refilled at tile j + 2
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    l_r[i] = fmaxf(l_r[i], 1e-30f);
  }
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.o);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = qpos0 + i * 8;
    if (row >= a.S) continue;
    __nv_bfloat16* orow = op + (((long long)b * a.S + row) * a.H + h) * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * t) =
          pack_bf16(acc[dt][2 * i] / l_r[i], acc[dt][2 * i + 1] / l_r[i]);
  }
}

// ------------------------------------------------- f32: CUDA-core FMA
constexpr int FBQ = 32, FBKV = 32, FTHREADS = 128, FMAXD = 128;

__global__ void __launch_bounds__(FTHREADS)
flash_fwd_f32_kernel(Args a, int Dk, int Dv) {
  extern __shared__ float fsm[];
  const int ldk = Dk + 1, ldv = Dv + 1, ldp = FBKV + 1;
  float* sQ = fsm;                     // FBQ x ldk
  float* sK = sQ + FBQ * ldk;          // FBKV x ldk
  float* sV = sK + FBKV * ldk;         // FBKV x ldv
  float* sP = sV + FBKV * ldv;         // FBQ x ldp

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.K);
  const int q0 = qt * FBQ;
  const int tid = threadIdx.x, r = tid >> 2, c4 = tid & 3;
  const float* qp = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sk;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sk;

  for (int i = tid; i < FBQ * Dk; i += FTHREADS) {
    const int rr = i / Dk, d = i % Dk;
    sQ[rr * ldk + d] = q0 + rr < a.S ? __ldg(qp + (long long)(q0 + rr) * a.q_ss + d) : 0.f;
  }
  const int qpos = q0 + r;
  float m = NEG, l = 0.f;
  float acc[FMAXD / 4];
#pragma unroll
  for (int i = 0; i < FMAXD / 4; ++i) acc[i] = 0.f;

  const int n_tiles = (kv_end(a, q0, FBQ) + FBKV - 1) / FBKV;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * FBKV;
    __syncthreads();
    for (int i = tid; i < FBKV * Dk; i += FTHREADS) {
      const int rr = i / Dk, d = i % Dk;
      sK[rr * ldk + d] = k0 + rr < a.kv_valid
                             ? __ldg(kp + (long long)(k0 + rr) * a.k_st + d) : 0.f;
    }
    for (int i = tid; i < FBKV * Dv; i += FTHREADS) {
      const int rr = i / Dv, d = i % Dv;
      sV[rr * ldv + d] = k0 + rr < a.kv_valid
                             ? __ldg(vp + (long long)(k0 + rr) * a.v_st + d) : 0.f;
    }
    __syncthreads();

    // this thread's keys: c4, c4 + 4, ..., c4 + 28 of the tile
    float s[FBKV / 4];
    float mx = m;
#pragma unroll
    for (int i = 0; i < FBKV / 4; ++i) {
      const int c = c4 + 4 * i;
      float x = 0.f;
      for (int d = 0; d < Dk; ++d) x = fmaf(sQ[r * ldk + d], sK[c * ldk + d], x);
      x *= a.scale;
      s[i] = live(k0 + c, qpos, a.kv_valid, a.causal) ? x : NEG;
      mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float alpha = expf(m - mx);
    float rs = 0.f;
#pragma unroll
    for (int i = 0; i < FBKV / 4; ++i) {
      const int c = c4 + 4 * i;
      const float p = live(k0 + c, qpos, a.kv_valid, a.causal) ? expf(s[i] - mx) : 0.f;
      sP[r * ldp + c] = p;
      rs += p;
    }
    l = l * alpha + rs;
    m = mx;
    __syncwarp();                      // a row's p comes from its own warp
    float pv[FMAXD / 4];
#pragma unroll
    for (int i = 0; i < FMAXD / 4; ++i) pv[i] = 0.f;
    for (int c = 0; c < FBKV; ++c) {
      const float p = sP[r * ldp + c];
#pragma unroll
      for (int i = 0; i < FMAXD / 4; ++i)
        if (c4 + 4 * i < Dv) pv[i] = fmaf(p, sV[c * ldv + c4 + 4 * i], pv[i]);
    }
#pragma unroll
    for (int i = 0; i < FMAXD / 4; ++i) acc[i] = acc[i] * alpha + pv[i];
  }

  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  l = fmaxf(l, 1e-30f);
  if (qpos < a.S) {
    float* orow = static_cast<float*>(a.o) + (((long long)b * a.S + qpos) * a.H + h) * Dv;
#pragma unroll
    for (int i = 0; i < FMAXD / 4; ++i)
      if (c4 + 4 * i < Dv) orow[c4 + 4 * i] = acc[i] / l;
  }
}

template <int D>
cudaError_t launch_bf16(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = (size_t)(BQ + 4 * BKV) * (D + 8) * sizeof(__nv_bfloat16);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.S + BQ - 1) / BQ, a.H, B);
  flash_fwd_bf16_kernel<D><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_f32(const Args& a, int B, int Dk, int Dv,
                       cudaStream_t stream) {
  const size_t smem =
      (size_t)((FBQ + FBKV) * (Dk + 1) + FBKV * (Dv + 1) + FBQ * (FBKV + 1)) *
      sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.S + FBQ - 1) / FBQ, a.H, B);
  flash_fwd_f32_kernel<<<grid, FTHREADS, smem, stream>>>(a, Dk, Dv);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B,S,H,Dk], k [B,T,K,Dk], v [B,T,K,Dv] device tensors with unit stride
// in the last dimension; strides[9] = their element strides over (b, s|t,
// h|k) in the order q, k, v. out [B,S,H,Dv] contiguous. dtype 0 = f32
// (Dk, Dv <= 128), 1 = bf16 (Dk == Dv in {16, 32, 64, 128}; strides multiples
// of 8 and 16-byte aligned pointers). 0 <= kv_valid <= T. Launches on
// `stream`, returns its cudaError_t.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                        const long long* strides, int B, int S, int H, int T,
                        int K, int Dk, int Dv, int kv_valid, int causal,
                        float scale, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (K <= 0 || H % K != 0 || kv_valid < 0 || kv_valid > T || H > 65535 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0 || H == 0) return 0;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = out;
  a.q_sb = strides[0]; a.q_ss = strides[1]; a.q_sh = strides[2];
  a.k_sb = strides[3]; a.k_st = strides[4]; a.k_sk = strides[5];
  a.v_sb = strides[6]; a.v_st = strides[7]; a.v_sk = strides[8];
  a.S = S; a.H = H; a.T = T; a.K = K;
  a.kv_valid = kv_valid; a.causal = causal; a.scale = scale;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    if (Dk < 1 || Dv < 1 || Dk > FMAXD || Dv > FMAXD)
      return (int)cudaErrorInvalidValue;
    return (int)launch_f32(a, B, Dk, Dv, st);
  }
  if (dtype != 1 || Dk != Dv) return (int)cudaErrorInvalidValue;
  switch (Dk) {
    case 16: return (int)launch_bf16<16>(a, B, st);
    case 32: return (int)launch_bf16<32>(a, B, st);
    case 64: return (int)launch_bf16<64>(a, B, st);
    case 128: return (int)launch_bf16<128>(a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
