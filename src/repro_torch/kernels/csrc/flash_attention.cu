// Flash attention (GQA, causal, sliding window), hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention.py::flash_attention_pallas (body
// _flash_kernel).  For q [B, Sq, H, D] and k, v [B, Sk, KV, D] (float32 or
// bfloat16, contiguous) it writes, in q's type,
//
//     out[b, i, h] = sum_j softmax_j(s[i, j]) v[b, j, h / G]
//     s[i, j]      = (q[b, i, h] * D^-1/2) . k[b, j, h / G]   (float32)
//
// over the keys j that the mask keeps: j < Sk, j <= i when causal and
// j > i - window with a window; G = H / KV query heads share one KV head
// (the head index h = kv * G + g, as the TPU kernel's flattened (b, kv, g)
// axis), read in place with no repeated K/V in memory.  The softmax is
// online, in float32, with the TPU kernel's masking constant -1e30 (not
// -inf): a row that meets a fully masked tile before its first valid key
// gathers finite garbage in l and acc that the first valid key wipes
// through corr = exp(-1e30 - m) = 0.  The output is acc / max(l, 1e-30).
// A row with no valid key at all gives 0 (the TPU kernel leaves a value
// that depends on its block size there).
//
// Layout: one CTA of 256 threads per (b * H + h, 64-query tile), the
// heaviest (last) query tiles launched first; a loop inside the CTA over
// 64-key tiles takes the place of the TPU kernel's sequential third grid
// axis.  The CTA skips the key tiles that its rows' mask removes whole (past
// the last query under causality, before the first query's window), which
// leaves every row with a valid key its valid keys.  The q tile (upcast,
// then scaled, as the TPU kernel does) and each K tile are staged
// transposed in shared memory as float32, the V tile row-major in the same
// buffer as K, the probabilities transposed.  Thread (ty, tx) of a 16 x 16
// grid owns query rows 4ty..4ty+3, score columns 4tx..4tx+3 and output
// dimensions 64c + 4tx..4tx+3: a 4 x 4 register tile of scores and a
// 4 x (D / 16) tile of the accumulator, fed by 128-bit shared-memory
// loads.  Row max and row sum are reduced over the 16 threads of a
// half-warp by shuffles.  Everything is float32 FFMA with the precise expf
// and IEEE division (no TF32: the float32 bound of 2e-5 rules it out); the
// ragged Sq / Sk edges are masked here, never padded in device memory.
//
// Bound on this card: operations.  A causal call does 4 * B * H * D *
// Sk(Sk + 1)/2 floating-point operations (q k and p v), e.g. 68.7 GFLOP at
// B = 2, S = 2048, H = 32, D = 128: 0.0695 ms at the bf16 tensor-core peak
// of 989 TFLOP/s, against 0.025 ms for its 84 MB of q, k, v and out at
// 3.35 TB/s.  This kernel runs on the FFMA units (67 TFLOP/s), so it can
// reach at best 15x that bound; wgmma with TMA-fed tiles for bf16 is the
// later redesign.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define BQ 64
#define BK 64
#define THREADS 256
#define PAD 4
#define NEG_INF (-1e30f)

struct F32 {
  typedef float store_t;
  static __device__ __forceinline__ float load(float x) { return x; }
  static __device__ __forceinline__ float store(float x) { return x; }
};

struct BF16 {
  typedef unsigned short store_t;  // raw bfloat16 bits
  static __device__ __forceinline__ float load(unsigned short b) {
    return __uint_as_float(((unsigned int)b) << 16);
  }
  static __device__ __forceinline__ unsigned short store(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};

template <int D>
static size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)D * (BQ + PAD) + (size_t)D * (BK + PAD) + BK * (BQ + PAD));
}

template <int D, typename Tr>
__global__ void __launch_bounds__(THREADS, 2)
    flash_kernel(const typename Tr::store_t* __restrict__ q,
                 const typename Tr::store_t* __restrict__ k,
                 const typename Tr::store_t* __restrict__ v,
                 typename Tr::store_t* __restrict__ out, int Sq, int Sk,
                 int H, int KV, float scale, int causal, int window) {
  typedef typename Tr::store_t T;
  constexpr int DV = D / 16;   // accumulator columns a thread owns
  constexpr int QS = BQ + PAD;  // row strides of the transposed tiles
  constexpr int KS = BK + PAD;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [D][QS]: q * scale
  float* KVs = Qs + D * QS;                     // [D][KS] K, or [BK][D] V
  float* Ps = KVs + D * KS;                     // [BK][QS]: p transposed

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const long long q_row = (long long)H * D;  // between positions
  const long long kv_row = (long long)KV * D;
  const T* qb = q + ((long long)b * Sq * H + h) * D;
  const T* kb = k + ((long long)b * Sk * KV + kvh) * D;
  const T* vb = v + ((long long)b * Sk * KV + kvh) * D;
  T* ob = out + ((long long)b * Sq * H + h) * D;

#pragma unroll 4
  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int s = q0 + r;
    Qs[d * QS + r] = s < Sq ? Tr::load(qb[s * q_row + d]) * scale : 0.0f;
  }

  // the key tiles some row of this query tile may attend to
  const int q_last = min(q0 + BQ, Sq) - 1;
  int kt_end = (Sk + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, q_last / BK + 1);
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / BK;

  float m[4], l[4], acc[4][DV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DV; ++c) acc[i][c] = 0.0f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's p v is done with KVs and Ps
#pragma unroll 4
    for (int i = tid; i < BK * D; i += THREADS) {
      const int c = i / D, d = i % D;
      const int s = k0 + c;
      KVs[d * KS + c] = s < Sk ? Tr::load(kb[s * kv_row + d]) : 0.0f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qs[d * QS + 4 * ty]);
      const float4 e = *reinterpret_cast<const float4*>(&KVs[d * KS + 4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float ev[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(av[i], ev[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * ty + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + 4 * tx + j;
        const bool ok = kp < Sk && (!causal || kp <= qp) &&
                        (window <= 0 || kp > qp - window);
        if (!ok) sc[i][j] = NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = expf(sc[i][j] - m_new);
        sum += sc[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DV; ++c) acc[i][c] *= corr;
    }

    __syncthreads();  // every thread is done reading K
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(4 * tx + j) * QS + 4 * ty + i] = sc[i][j];
#pragma unroll 4
    for (int i = tid; i < BK * D; i += THREADS) {
      const int c = i / D, d = i % D;
      const int s = k0 + c;
      // padded keys must be finite: p may be 1 on them before a valid key
      KVs[c * D + d] = s < Sk ? Tr::load(vb[s * kv_row + d]) : 0.0f;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(&Ps[c * QS + 4 * ty]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int part = 0; part < D / 64; ++part) {
        const float4 w =
            *reinterpret_cast<const float4*>(&KVs[c * D + 64 * part + 4 * tx]);
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][4 * part + j] = fmaf(pv[i], wv[j], acc[i][4 * part + j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + 4 * ty + i;
    if (s >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    const bool empty = m[i] == NEG_INF;  // no valid key in any tile
#pragma unroll
    for (int part = 0; part < D / 64; ++part)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ob[s * q_row + 64 * part + 4 * tx + j] =
            Tr::store(empty ? 0.0f : acc[i][4 * part + j] / denom);
  }
}

template <int D, typename Tr>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int B, int Sq, int Sk, int H, int KV, float scale,
                  int causal, int window, cudaStream_t stream) {
  typedef typename Tr::store_t T;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D, Tr>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(B * H), (unsigned)((Sq + BQ - 1) / BQ));
  flash_kernel<D, Tr><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Sq, Sk, H, KV, scale,
      causal, window);
  return (int)cudaGetLastError();
}

// q [B, Sq, H, D], k and v [B, Sk, KV, D], out [B, Sq, H, D], all
// contiguous and of one type (dtype 0 = float32, 1 = bfloat16); D = 64 or
// 128, H a multiple of KV; window <= 0 means none; scale = D^-1/2 as a
// float32.  Returns cudaGetLastError() (or cudaErrorInvalidValue for a
// shape the kernel does not take).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int Sq, int Sk, int H,
                               int KV, int D, int causal, int window,
                               float scale, int dtype, cudaStream_t stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (Sk <= 0 || KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  if ((Sq + BQ - 1) / BQ > 65535 || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (D == 64 && dtype == 0)
    return launch<64, F32>(q, k, v, out, B, Sq, Sk, H, KV, scale, causal,
                           window, stream);
  if (D == 64 && dtype == 1)
    return launch<64, BF16>(q, k, v, out, B, Sq, Sk, H, KV, scale, causal,
                            window, stream);
  if (D == 128 && dtype == 0)
    return launch<128, F32>(q, k, v, out, B, Sq, Sk, H, KV, scale, causal,
                            window, stream);
  if (D == 128 && dtype == 1)
    return launch<128, BF16>(q, k, v, out, B, Sq, Sk, H, KV, scale, causal,
                             window, stream);
  return (int)cudaErrorInvalidValue;
}
