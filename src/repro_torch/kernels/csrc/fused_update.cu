// The fused Generalized-AsyncSGD server update, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/fused_update.py::fused_async_update_flat (body
// _update_kernel).  For each lane l of L stacked flat parameter vectors:
//
//     out[l, i]        = (w[l, i] - scale[l] * g[l, i])   in float32,
//                        cast to the parameter type
//     partial[l, b]    = sum of g[l, i]^2 over block b of 4096 elements,
//                        in float32
//     sumsq[l]         = sum over b of partial[l, b], in block order
//
// float32 and bfloat16 parameters.  L = 1 is the reference's flat form; the
// lane axis is what the reference computes under the trainer's vmap.
//
// Layout: one CTA of 256 threads per (4096-element block, lane), grid
// (n_blocks, L).  Thread t owns the 16-byte chunks k * 256 + t of its block
// (k = 0 .. 4096 / (256 * VEC) - 1, VEC = 16 / sizeof(T) elements a chunk)
// and loads each as one 128-bit vector when the row is 16-byte aligned,
// element by element at a ragged or misaligned edge.  The reduction order
// depends on element indices only, never on how they were loaded: each
// thread sums its elements in index order, a warp folds its 32 sums by an
// xor butterfly, thread 0 adds the 8 warp sums in warp order, and a second
// one-thread-per-lane pass adds the partials in block order.  The same
// inputs therefore give the same bits on every run.  The file is built with
// -fmad=false and the update uses __fmul_rn / __fsub_rn, so out equals
// PyTorch's `w - scale * g` (a rounded multiply, then a rounded subtract)
// bit for bit.
//
// Bound: bytes — w and g read once and out written once (12 B a float32
// parameter, 6 B a bfloat16 one), the partials and scales are negligible;
// two float32 operations per element for the update and two for the norm.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define BLOCK 4096
#define THREADS 256

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

template <typename Tr>
__global__ void fused_update_kernel(
    const typename Tr::store_t* __restrict__ w,
    const typename Tr::store_t* __restrict__ g,
    const float* __restrict__ scale, typename Tr::store_t* __restrict__ out,
    float* __restrict__ partial, long long N, int n_blocks, int vec_ok) {
  typedef typename Tr::store_t T;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = BLOCK / (THREADS * VEC);
  union Vec {
    uint4 u;
    T t[VEC];
  };
  const int lane = blockIdx.y;
  const long long row = (long long)lane * N;
  const long long base = (long long)blockIdx.x * BLOCK;
  const float s = scale[lane];
  float acc = 0.0f;
  for (int k = 0; k < CHUNKS; ++k) {
    const long long i0 = base + ((long long)k * THREADS + threadIdx.x) * VEC;
    if (i0 >= N) break;
    Vec wv, gv, ov;
    const bool full = vec_ok && i0 + VEC <= N;
    if (full) {
      wv.u = *reinterpret_cast<const uint4*>(w + row + i0);
      gv.u = *reinterpret_cast<const uint4*>(g + row + i0);
    } else {
      for (int e = 0; e < VEC; ++e) {
        const bool in = i0 + e < N;
        wv.t[e] = in ? w[row + i0 + e] : T(0);
        gv.t[e] = in ? g[row + i0 + e] : T(0);
      }
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float gf = Tr::load(gv.t[e]);
      const float wf = Tr::load(wv.t[e]);
      ov.t[e] = Tr::store(__fsub_rn(wf, __fmul_rn(s, gf)));
      // padding elements are zero: they add +0.0 to the sum
      acc = __fadd_rn(acc, __fmul_rn(gf, gf));
    }
    if (full) {
      *reinterpret_cast<uint4*>(out + row + i0) = ov.u;
    } else {
      for (int e = 0; e < VEC; ++e)
        if (i0 + e < N) out[row + i0 + e] = ov.t[e];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  __shared__ float warp_sum[THREADS / 32];
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int i = 0; i < THREADS / 32; ++i)
      total = __fadd_rn(total, warp_sum[i]);
    partial[(long long)lane * n_blocks + blockIdx.x] = total;
  }
}

__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    float* __restrict__ sumsq, int L,
                                    int n_blocks) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  float total = 0.0f;
  for (int b = 0; b < n_blocks; ++b)
    total = __fadd_rn(total, partial[(long long)lane * n_blocks + b]);
  sumsq[lane] = total;
}

template <typename Tr>
static void launch(const void* w, const void* g, const float* scale,
                   void* out, float* partial, long long L, long long N,
                   int n_blocks, cudaStream_t stream) {
  typedef typename Tr::store_t T;
  const int vec = 16 / sizeof(T);
  const int vec_ok = (N % vec == 0) && ((uintptr_t)w % 16 == 0) &&
                     ((uintptr_t)g % 16 == 0) && ((uintptr_t)out % 16 == 0);
  dim3 grid(n_blocks, (unsigned)L);
  fused_update_kernel<Tr><<<grid, THREADS, 0, stream>>>(
      (const T*)w, (const T*)g, scale, (T*)out, partial, N, n_blocks, vec_ok);
}

// dtype: 0 = float32, 1 = bfloat16.  partial is [L, n_blocks] and sumsq
// [L], both float32; n_blocks = ceil(N / 4096).  Returns cudaGetLastError().
extern "C" int fused_update(const void* w, const void* g, const float* scale,
                            void* out, float* partial, float* sumsq,
                            long long L, long long N, int dtype,
                            cudaStream_t stream) {
  if (L <= 0) return 0;
  if (L > 65535) return (int)cudaErrorInvalidValue;
  const long long nb = (N + BLOCK - 1) / BLOCK;
  if (nb > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int n_blocks = (int)nb;
  if (n_blocks > 0) {
    if (dtype == 0)
      launch<F32>(w, g, scale, out, partial, L, N, n_blocks, stream);
    else if (dtype == 1)
      launch<BF16>(w, g, scale, out, partial, L, N, n_blocks, stream);
    else
      return (int)cudaErrorInvalidValue;
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const int threads = 128;
  sum_partials_kernel<<<(int)((L + threads - 1) / threads), threads, 0,
                        stream>>>(partial, sumsq, (int)L, n_blocks);
  return (int)cudaGetLastError();
}
