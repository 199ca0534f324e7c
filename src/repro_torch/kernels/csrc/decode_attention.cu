// Decode attention (one query token against a KV cache, GQA), hand-written
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/decode_attention.py::decode_attention_pallas (body
// _decode_kernel).  For q [B, 1, H, D] (contiguous) and the caches
// k, v [B, S, KV, D] (read in place through their batch and row strides;
// each row's [KV, D] dense), float32 or bfloat16, it writes, in q's type,
//
//     out[b, 0, h] = sum_j softmax_j(s[j]) v[b, j, kv]      (j < len_b)
//     s[j]         = (q[b, 0, h] * D^-1/2) . k[b, j, kv]     (float32)
//
// with h = kv * G + g (G = H / KV query heads share KV head kv) and
// len_b = clamp(lengths[b] or the scalar length, 0, S).  q is upcast and
// then scaled, as the TPU kernel does.  The softmax is online, in float32,
// with the TPU kernel's masking constant -1e30 (not -inf); the output is
// acc / max(l, 1e-30), so a row with len_b = 0 gives 0 (the TPU kernel's
// value there, a uniform mean over its padded tiles, is not kept).
//
// Layout: one CTA of 256 threads per (b, kv).  The G query rows of the KV
// head are staged once in shared memory as float32 and stay resident.  A
// loop inside the CTA walks the cache in 64-row tiles (the TPU kernel's
// sequential grid axis) and stops at the last tile holding a valid entry:
// tiles wholly at or past len_b are never read, and the rows of the last
// tile past len_b are zero-filled, not loaded.  Each thread loads its
// 16-byte chunks of a K and a V tile (coalesced along D) into registers
// and, once the CTA is done with the previous tile, stores them to shared
// memory as float32 (K with a padded row, so that the 32 lanes of a warp,
// one row each, hit 32 banks); the next tile's loads are issued before
// the current tile is computed, so they are in flight meanwhile.  Warp w
// owns query rows g = w, w + 8, ...: its lanes compute the scores of rows
// lane and lane + 32, reduce the max and the sum by shuffles and write p
// to shared memory.  The accumulator [G][D] lives in shared memory; thread
// t owns its elements e = t + 256 i (g = e / D, d = e % D, the same d for
// every i since D divides 256), rescales each by corr[g] and adds
// p[g][j] * v[j][d] over the tile's rows in a register.  G * D <= 6144
// (G <= 48 at D = 128, the MQA of granite-34b) bounds shared memory.
// Precise expf and IEEE division (no fast math).
//
// Bound on this card: bytes.  The kernel must read the valid cache rows
// once, 2 * sum_b len_b * KV * D elements, and q and out once; it does 4
// FLOP per cached element and head of the group, far below the card's
// rate per byte.  At decode_32k's per-layer shape (B = 128, len = S =
// 8,192, KV = 8, D = 128, bf16) that is 4.29 GB: 1.282 ms at 3.35 TB/s.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define BS 64
#define THREADS 256
#define WARPS (THREADS / 32)
#define MAX_GD 6144  // G * D: the accumulator's shared memory
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
static size_t smem_bytes(int G) {
  return sizeof(float) * (2 * (size_t)G * D + (size_t)BS * (D + 1) +
                          (size_t)BS * D + (size_t)G * BS + 3 * (size_t)G);
}

template <int D, typename Tr>
__global__ void __launch_bounds__(THREADS)
    decode_kernel(const typename Tr::store_t* __restrict__ q,
                  const typename Tr::store_t* __restrict__ k,
                  const typename Tr::store_t* __restrict__ v,
                  typename Tr::store_t* __restrict__ out,
                  const int* __restrict__ lengths, int length, int S, int H,
                  int KV, long long k_sb, long long k_ss, long long v_sb,
                  long long v_ss, float scale) {
  typedef typename Tr::store_t T;
  constexpr int KS = D + 1;              // padded K row
  constexpr int VEC = 16 / sizeof(T);    // elements per 16-byte chunk
  constexpr int ROW = D / VEC;           // chunks per cache row
  constexpr int CPT = BS * ROW / THREADS;  // chunks a thread loads a tile
  extern __shared__ float4 smem4[];
  const int G = H / KV;
  const int GD = G * D;
  float* Qs = reinterpret_cast<float*>(smem4);  // [G][D]: q * scale
  float* Acc = Qs + GD;                         // [G][D]
  float* Ks = Acc + GD;                         // [BS][KS]
  float* Vs = Ks + BS * KS;                     // [BS][D]
  float* Ps = Vs + BS * D;                      // [G][BS]
  float* ms = Ps + G * BS;                      // [G] running max
  float* ls = ms + G;                           // [G] running sum
  float* cs = ls + G;                           // [G] this tile's rescale

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int kvh = blockIdx.x % KV, b = blockIdx.x / KV;
  const T* qb = q + ((long long)b * H + (long long)kvh * G) * D;
  T* ob = out + ((long long)b * H + (long long)kvh * G) * D;
  const T* kb = k + b * k_sb + (long long)kvh * D;
  const T* vb = v + b * v_sb + (long long)kvh * D;

  int len = lengths != nullptr ? lengths[b] : length;
  len = min(max(len, 0), S);

  for (int i = tid; i < GD; i += THREADS) {
    Qs[i] = Tr::load(qb[i]) * scale;
    Acc[i] = 0.0f;
  }
  for (int g = tid; g < G; g += THREADS) {
    ms[g] = NEG_INF;
    ls[g] = 0.0f;
  }

  // this thread's chunks of one K and one V tile, in flight in registers
  uint4 kr[CPT], vr[CPT];
  auto fetch = [&](int s0) {
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = tid + i * THREADS;
      const int s = s0 + c / ROW, d0 = (c % ROW) * VEC;
      if (s < len) {
        kr[i] = *reinterpret_cast<const uint4*>(kb + s * k_ss + d0);
        vr[i] = *reinterpret_cast<const uint4*>(vb + s * v_ss + d0);
      } else {
        kr[i] = vr[i] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };

  const int n_tiles = (len + BS - 1) / BS;
  const int d = tid % D;  // a thread's accumulator column
  if (n_tiles > 0) fetch(0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s0 = t * BS;
    __syncthreads();  // the previous tile is done with Ks, Vs and Ps
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / ROW, d0 = (c % ROW) * VEC;
      const T* ke = reinterpret_cast<const T*>(&kr[i]);
      const T* ve = reinterpret_cast<const T*>(&vr[i]);
#pragma unroll
      for (int u = 0; u < VEC; ++u) {
        Ks[r * KS + d0 + u] = Tr::load(ke[u]);
        Vs[r * D + d0 + u] = Tr::load(ve[u]);
      }
    }
    __syncthreads();
    if (t + 1 < n_tiles) fetch(s0 + BS);  // in flight during this tile

    for (int g = warp; g < G; g += WARPS) {
      const float* qg = Qs + g * D;
      float s_a = 0.0f, s_b = 0.0f;
#pragma unroll 8
      for (int dd = 0; dd < D; ++dd) {
        const float qd = qg[dd];
        s_a = fmaf(qd, Ks[lane * KS + dd], s_a);
        s_b = fmaf(qd, Ks[(lane + 32) * KS + dd], s_b);
      }
      if (s0 + lane >= len) s_a = NEG_INF;
      if (s0 + lane + 32 >= len) s_b = NEG_INF;
      float mx = fmaxf(s_a, s_b);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, mx);
      const float p_a = expf(s_a - m_new), p_b = expf(s_b - m_new);
      float sum = p_a + p_b;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      Ps[g * BS + lane] = p_a;
      Ps[g * BS + lane + 32] = p_b;
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        cs[g] = corr;
        ls[g] = ls[g] * corr + sum;
        ms[g] = m_new;
      }
    }
    __syncthreads();

    const int rows = min(BS, len - s0);
    for (int e = tid; e < GD; e += THREADS) {
      const int g = e / D;
      const float* pg = Ps + g * BS;
      float a = Acc[e] * cs[g];
#pragma unroll 8
      for (int j = 0; j < rows; ++j) a = fmaf(pg[j], Vs[j * D + d], a);
      Acc[e] = a;
    }
  }

  __syncthreads();  // ls is final (and set, if no tile was visited)
  for (int e = tid; e < GD; e += THREADS)
    ob[e] = Tr::store(Acc[e] / fmaxf(ls[e / D], 1e-30f));
}

template <int D, typename Tr>
static int launch(const void* q, const void* k, const void* v, void* out,
                  const int* lengths, int length, int B, int S, int H,
                  int KV, long long k_sb, long long k_ss, long long v_sb,
                  long long v_ss, float scale, cudaStream_t stream) {
  typedef typename Tr::store_t T;
  const size_t smem = smem_bytes<D>(H / KV);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<D, Tr>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_kernel<D, Tr><<<(unsigned)(B * KV), THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, lengths, length, S, H,
      KV, k_sb, k_ss, v_sb, v_ss, scale);
  return (int)cudaGetLastError();
}

// q [B, 1, H, D] and out [B, 1, H, D] contiguous; k and v [B, S, KV, D]
// with batch strides k_sb, v_sb and row strides k_ss, v_ss in elements
// (the [KV, D] of a row dense), every row 16-byte aligned; lengths an
// int32 [B] on the device, or null to use the scalar length; dtype 0 =
// float32, 1 = bfloat16 for all four; D = 64 or 128; H a multiple of KV
// with (H / KV) * D <= 6144; scale = D^-1/2 as a float32.  Returns
// cudaGetLastError() (or cudaErrorInvalidValue for a shape the kernel does
// not take).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                void* out, const int* lengths, int length,
                                int B, int S, int H, int KV, int D,
                                long long k_sb, long long k_ss,
                                long long v_sb, long long v_ss, float scale,
                                int dtype, cudaStream_t stream) {
  if (B <= 0 || H <= 0) return 0;
  if (S <= 0 || KV <= 0 || H % KV != 0 || (H / KV) * D > MAX_GD ||
      (long long)B * KV > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (D == 64 && dtype == 0)
    return launch<64, F32>(q, k, v, out, lengths, length, B, S, H, KV, k_sb,
                           k_ss, v_sb, v_ss, scale, stream);
  if (D == 64 && dtype == 1)
    return launch<64, BF16>(q, k, v, out, lengths, length, B, S, H, KV, k_sb,
                            k_ss, v_sb, v_ss, scale, stream);
  if (D == 128 && dtype == 0)
    return launch<128, F32>(q, k, v, out, lengths, length, B, S, H, KV, k_sb,
                            k_ss, v_sb, v_ss, scale, stream);
  if (D == 128 && dtype == 1)
    return launch<128, BF16>(q, k, v, out, lengths, length, B, S, H, KV,
                             k_sb, k_ss, v_sb, v_ss, scale, stream);
  return (int)cudaErrorInvalidValue;
}
