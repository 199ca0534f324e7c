// Flash attention (GQA, causal, sliding window), hand-written for Hopper
// (sm_90a): bfloat16 on the tensor cores (wgmma on TMA-fed tiles), float32
// on the FFMA units.
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention.py::flash_attention_pallas (body
// _flash_kernel).  For q [B, Sq, H, D] and k, v [B, Sk, KV, D] (float32 or
// bfloat16, contiguous) it writes, in q's type,
//
//     out[b, i, h] = sum_j softmax_j(s[i, j]) v[b, j, h / G]
//     s[i, j]      = q[b, i, h] . k[b, j, h / G] * D^-1/2   (float32)
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
// that depends on its block size there).  Both paths take the heaviest
// (last) query tiles first and skip the key tiles that their rows' mask
// removes whole (past the last query under causality, before the first
// query's window), which leaves every row with a valid key its valid keys.
//
// Bound on this card: operations.  A causal call does 4 * B * H * D *
// Sk(Sk + 1)/2 floating-point operations (q k and p v), e.g. 68.7 GFLOP at
// B = 2, S = 2048, H = 32, D = 128: 0.0695 ms at the bf16 tensor-core peak
// of 989 TFLOP/s, against 0.025 ms for its 84 MB of q, k, v and out at
// 3.35 TB/s.
//
// bfloat16 path (flash_wgmma_kernel).  Persistent: one CTA of three
// warpgroups per SM walks the work items (b * H + h, 128-query tile),
// heaviest first, in a zigzag over the CTAs that balances the causal
// tiles' unequal work.  Warpgroup 0 is the producer: one thread loads an
// item's q tile (once q's "empty" mbarrier says the previous item's last
// scores are in) and then each 128-key K and V tile by TMA
// (cp.async.bulk.tensor over 4-D maps (D, heads, S, B) of q, k and v as
// they lie, 64-column boxes with the 128-byte swizzle, rows past Sq and Sk
// zero-filled by the hardware, so padded V rows are finite) into a ring of
// 3 shared-memory stages (at D = 128: 32 KB of q + 3 x 64 KB of K and V),
// each signalled by a "full" mbarrier with its byte count and released by
// an "empty" mbarrier that all 256 consumer threads arrive on; the ring's
// stages and phases run on across items, so the next item's q and first
// tiles load under this item's last products and epilogue.  setmaxnreg
// hands the producer's registers to warpgroups 1 and 2, the consumers,
// which own 64 query rows each and per key tile:
//   - S = q k^T: D / 16 wgmma m64n128k16 with both operands in shared
//     memory (the K tile [128, D], D contiguous, is K-major as B: no
//     transpose), float32 accumulators in registers;
//   - the softmax on the accumulator fragment in float32: the mask only on
//     tiles that cross the diagonal, the window's edge or Sk, the row max
//     of the raw scores over the quad of threads that holds a row (two
//     shfl_xor steps), p = 2^(s c - m c) with c = D^-1/2 log2(e), one FFMA
//     and one ex2.approx.ftz per score (the scale on the float32 scores,
//     not on q: a few float32 ulps from the TPU kernel's order);
//   - O += P V: p rounded to bfloat16 in registers is wgmma's register A
//     operand (the float32 S fragment maps onto the bf16 A fragment with
//     no shuffle), V the B operand from shared memory with the transpose
//     bit (the V tile [128, D] is MN-major for this product): 8 wgmma
//     m64nDk16.  l sums the float32 p (before the rounding), per thread,
//     and the quad's partial sums are added in the epilogue.
// Two overlaps keep the tensor cores fed: inside a warpgroup, tile j's
// scores are issued with tile j - 1's P V, and tile j's softmax runs
// while that P V finishes (so a consumer holds two stages, hence 3); and
// the two warpgroups take turns to issue their products (named barriers),
// so that one's softmax runs while the other's products hold the tensor
// cores.  The epilogue of an item multiplies by 1 / max(l, 1e-30), rounds to
// bfloat16 and stores the rows below Sq.  Traps: the tiles' shared-memory
// bases are 1024-byte aligned (the swizzle's period); the wgmma
// descriptors use the same 128-byte swizzle (K-major q and K: +32 bytes
// per 16-column step inside a 64-column box, the next box 16 KB on;
// MN-major V: 1 KB per 8 keys, the second 64-column box 16 KB on); a
// register A operand and the accumulator must stay untouched until the
// wgmma reading them has been waited on, and p is packed after the second
// wait, O corrected between the two issues (packing p and correcting O
// between the two waits made ptxas serialize the wgmmas, C7513); q, k, v
// and out must be 16-byte aligned (TMA), which the wrapper checks.
//
// float32 path (flash_kernel<D, F32>): the 2e-5 bound rules out TF32 and
// bf16 tensor cores.  One CTA of 256 threads per (b * H + h, 64-query
// tile), a loop over 64-key tiles.  The q tile (upcast, then scaled, as
// the TPU kernel does) and each K tile are staged transposed in shared
// memory, the V tile row-major in the same buffer as K, the probabilities
// transposed.  Thread (ty, tx) of a 16 x 16 grid owns query rows
// 4ty..4ty+3, score columns 4tx..4tx+3 and output dimensions
// 64c + 4tx..4tx+3: a 4 x 4 register tile of scores and a 4 x (D / 16)
// tile of the accumulator, fed by 128-bit shared-memory loads.  Row max
// and row sum are reduced over the 16 threads of a half-warp by shuffles.
// Everything is float32 FFMA with the precise expf and IEEE division; the
// ragged Sq / Sk edges are masked here, never padded in device memory.
// It runs on the FFMA units (67 TFLOP/s), so it can reach at best 15x the
// bound above.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

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

// ---------------------------------------------------------------------------
// bfloat16: wgmma on TMA-fed tiles
// ---------------------------------------------------------------------------

namespace wg {

constexpr int BM = 128;               // query rows per CTA
constexpr int BN = 128;               // keys per tile
constexpr int NTHREADS = 384;         // producer + two consumer warpgroups
constexpr int CONSUMERS = 256;        // threads that arrive on "empty"
constexpr int BOX = BN * 64 * 2;      // one 128-row x 64-column bf16 box
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int STAGES = 3;
  static constexpr int TILE = (D / 64) * BOX;  // a 128 x D tile (q, K or V)
  // q, then per stage K and V, then the barriers: full[S], empty[S] and
  // q's full and empty
  static constexpr int SMEM = TILE + 2 * STAGES * TILE + 8 * (2 * STAGES + 2)
                              + 1024;  // slack to align the base to 1024
};

// a wgmma shared-memory descriptor with the 128-byte swizzle; lbo and sbo
// in bytes
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// wait until at most N of this warpgroup's committed groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keep the compiler from moving accesses of an accumulator across the
// asynchronous wgmma that writes it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// keep a register A operand alive (unchanged) until the wgmma reading it
// has been waited on
__device__ __forceinline__ void keep_regs(const uint32_t (&a)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" ::"r"(a[i]) : "memory");
}

#define ACC4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define ACC16(d, i) ACC4(d, i), ACC4(d, i + 4), ACC4(d, i + 8), ACC4(d, i + 12)
#define ACC32(d, i) ACC16(d, i), ACC16(d, i + 16)

// S[64 x 128] (+)= A[64 x 16] B[16 x 128]^T, both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : ACC32(d, 0), ACC32(d, 32)
      : "l"(da), "l"(db), "r"(accumulate));
}

// O[64 x 128] += P[64 x 16] V[16 x 128]: P in registers (bf16x2), V
// MN-major in shared memory (the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : ACC32(d, 0), ACC32(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O[64 x 64] += P[64 x 16] V[16 x 64], as above at D = 64
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : ACC32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo, low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// S = q K^T for one key tile: D / 16 wgmma with both operands in shared
// memory, committed as one group and not waited on
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t qa,
                                         uint32_t sk) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
    wgmma_ss_n128(sc, desc(qa + off, 16, 1024), desc(sk + off, 16, 1024),
                  kk > 0);
  }
  wgmma_commit();
}

// O += P V for one key tile: the A fragment of keys 16kk..16kk+15 is
// p[4kk..4kk+3]; committed as one group and not waited on
template <int N>
__device__ __forceinline__ void issue_pv(float (&o)[N],
                                         const uint32_t (&p)[32],
                                         uint32_t sv) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_rs(o, &p[4 * kk], desc(sv + kk * 2048, BOX, 1024));
  wgmma_commit();
}

// where a consumer thread's scores lie and what masks them
struct Rows {
  int r0, r1;       // the two rows the thread holds in every fragment
  int cq;           // its first column inside each 8-column chunk
  int first, last;  // the warpgroup's first and last row below Sq
  int Sk, causal, window;
  float scale_log2;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the online softmax of one tile of raw scores q.k, in place, in float32:
// m is the row max of the raw scores, and p = 2^(s * D^-1/2 log2 e - m
// D^-1/2 log2 e), one FFMA and one ex2 per score (the scale on the float32
// scores, not on q: a few float32 ulps from the TPU kernel's order).  A
// row that has met only masked keys (m = -1e30) takes 0 as its shift, so
// its p are 2^(-1e30 scale) = 0: finite garbage, wiped by the first valid
// key's correction 2^((-1e30 - m) scale) = 0 all the same.  Leaves p in
// sc and the accumulator's correction in c; updates m and l.
__device__ __forceinline__ void softmax(float (&sc)[64], float (&m)[2],
                                        float (&l)[2], float (&c)[2],
                                        const Rows& R, int k0) {
  constexpr float NEG = -1e30f;
  const bool edge = k0 + BN > R.Sk || (R.causal && k0 + BN - 1 > R.first) ||
                    (R.window > 0 && k0 <= R.last - R.window);
  if (edge) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int col = k0 + 8 * (i >> 2) + R.cq + (i & 1);
      const int row = (i & 2) ? R.r1 : R.r0;
      const bool ok = col < R.Sk && (!R.causal || col <= row) &&
                      (R.window <= 0 || col > row - R.window);
      if (!ok) sc[i] = NEG;
    }
  }
  float mx0 = m[0], mx1 = m[1];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {  // over the quad of a row
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float k = R.scale_log2;
  c[0] = ex2((m[0] - mx0) * k);
  c[1] = ex2((m[1] - mx1) * k);
  m[0] = mx0;
  m[1] = mx1;
  const float sh0 = mx0 == NEG ? 0.0f : mx0 * k;
  const float sh1 = mx1 == NEG ? 0.0f : mx1 * k;
  // l sums these float32 p (this thread's columns; the quad's partial
  // sums are added in the epilogue); the product with V takes them
  // rounded to bf16
  float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    sc[4 * j] = ex2(fmaf(sc[4 * j], k, -sh0));
    sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], k, -sh0));
    sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], k, -sh1));
    sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], k, -sh1));
    sum0 += sc[4 * j] + sc[4 * j + 1];
    sum1 += sc[4 * j + 2] + sc[4 * j + 3];
  }
  l[0] = l[0] * c[0] + sum0;
  l[1] = l[1] * c[1] + sum1;
}

// p rounded to bf16 pairs: the A fragment of O += P V (the accumulator's
// fragment layout is the A operand's, with no shuffle)
__device__ __forceinline__ void pack_p(const float (&sc)[64],
                                       uint32_t (&p)[32]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    p[2 * j] = pack_bf16(sc[4 * j], sc[4 * j + 1]);  // row r0, 8j + cq + 0, 1
    p[2 * j + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);  // row r1
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&c)[2]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    o[4 * j] *= c[0];
    o[4 * j + 1] *= c[0];
    o[4 * j + 2] *= c[1];
    o[4 * j + 3] *= c[1];
  }
}

// one work item: a (b, h) pair and a 128-query tile, with the key tiles
// some row of it may attend to
struct Item {
  int b, h, kvh, q0, kt_begin, n_tiles;
};

__device__ __forceinline__ Item describe(int w, int BH, int nq, int H,
                                         int KV, int Sq, int Sk, int causal,
                                         int window) {
  Item I;
  const int bh = w % BH;
  I.b = bh / H;
  I.h = bh % H;
  I.kvh = I.h / (H / KV);
  I.q0 = (nq - 1 - w / BH) * BM;  // heaviest (last) query tiles first
  const int q_last = min(I.q0 + BM, Sq) - 1;
  int kt_end = (Sk + BN - 1) / BN;
  if (causal) kt_end = min(kt_end, q_last / BN + 1);
  I.kt_begin = 0;
  if (window > 0 && I.q0 - window + 1 > 0)
    I.kt_begin = (I.q0 - window + 1) / BN;
  I.n_tiles = max(kt_end - I.kt_begin, 0);
  return I;
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ out, int B, int Sq, int Sk,
                       int H, int KV, float scale_log2, int causal,
                       int window) {
  typedef Cfg<D> C;
  constexpr int STAGES = C::STAGES, TILE = C::TILE;
  constexpr float NEG = -1e30f;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t sq = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t skv = sq + TILE;  // stage s: K at skv + 2 s TILE, V after
  // full[s] at bars + 8 s, empty[s] at bars + 8 (S + s), then q's full
  // and empty barriers
  const uint32_t bars = skv + 2 * STAGES * TILE;
  const uint32_t qfull = bars + 16 * STAGES, qempty = qfull + 8;

  // persistent: this CTA's work items are k G + c on even passes k and
  // k G + G - 1 - c on odd ones (a zigzag over the heaviest-first order,
  // which balances the causal tiles' unequal work across the CTAs)
  const int BH = B * H, nq = (Sq + BM - 1) / BM, n_work = BH * nq;
  const int G = gridDim.x, c = blockIdx.x;
  auto item = [&](int k) { return k * G + ((k & 1) ? G - 1 - c : c); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (STAGES + s), CONSUMERS);
    }
    mbar_init(qfull, 1);
    mbar_init(qempty, CONSUMERS);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      int g = 0;  // key tiles loaded so far, over all items
      for (int k = 0; item(k) < n_work; ++k) {
        const Item I = describe(item(k), BH, nq, H, KV, Sq, Sk, causal,
                                window);
        mbar_wait(qempty, (k & 1) ^ 1);
        mbar_expect_tx(qfull, TILE);
        for (int d = 0; d < D / 64; ++d)
          tma_load(sq + d * BOX, &tq, qfull, 64 * d, I.h, I.q0, I.b);
        for (int it = 0; it < I.n_tiles; ++it, ++g) {
          const int s = g % STAGES;
          mbar_wait(bars + 8 * (STAGES + s), ((g / STAGES) & 1) ^ 1);
          const uint32_t full = bars + 8 * s;
          const uint32_t sk = skv + 2 * s * TILE;
          const int k0 = (I.kt_begin + it) * BN;
          mbar_expect_tx(full, 2 * TILE);
          for (int d = 0; d < D / 64; ++d) {
            tma_load(sk + d * BOX, &tk, full, 64 * d, I.kvh, k0, I.b);
            tma_load(sk + TILE + d * BOX, &tv, full, 64 * d, I.kvh, k0, I.b);
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int cw = threadIdx.x / 128 - 1;
    const int t = threadIdx.x & 127, lane = t & 31;
    const uint32_t qa = sq + cw * 64 * 128;  // 64 rows of 128 bytes on

    // ping-pong: the two consumer warpgroups take turns to issue their
    // products (named barriers 1 and 2), so that one's softmax runs while
    // the other's products hold the tensor cores.  An item of n key tiles
    // has n + 1 turns: the first tile's scores, then the scores of tile j
    // with P V of tile j - 1, then the last P V.  Warpgroup 0 starts, and
    // takes warpgroup 1's last arrival at the end, so every barrier
    // completes.
    int turn = 0;
    auto turn_begin = [&]() {
      if (!(cw == 0 && turn == 0))
        asm volatile("bar.sync %0, 256;" ::"r"(1 + cw) : "memory");
    };
    auto turn_end = [&]() {
      asm volatile("bar.arrive %0, 256;" ::"r"(2 - cw) : "memory");
      ++turn;
    };

    int g = 0;  // key tiles consumed so far, over all items
    for (int k = 0; item(k) < n_work; ++k) {
      const Item I = describe(item(k), BH, nq, H, KV, Sq, Sk, causal,
                              window);
      const int n = I.n_tiles, kb = I.kt_begin;
      Rows R;
      R.first = I.q0 + 64 * cw;
      R.last = min(R.first + 63, Sq - 1);
      R.r0 = R.first + 16 * (t >> 5) + (lane >> 2);
      R.r1 = R.r0 + 8;
      R.cq = 2 * (lane & 3);
      R.Sk = Sk;
      R.causal = causal;
      R.window = window;
      R.scale_log2 = scale_log2;

      float o[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
      float m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f}, cr[2];
      uint32_t p[32];  // the previous tile's p, for its product with V
      mbar_wait(qfull, k & 1);
      // q is free for the next item once the last scores are in
      if (n == 0) mbar_arrive(qempty);

      // the first tile's scores and softmax
      if (n > 0) {
        mbar_wait(bars + 8 * (g % STAGES), (g / STAGES) & 1);
        float sc[64];
        turn_begin();
        wgmma_fence();
        issue_qk<D>(sc, qa, skv + 2 * (g % STAGES) * TILE);
        turn_end();
        wgmma_wait<0>();
        fence_regs(sc);
        if (n == 1) mbar_arrive(qempty);
        softmax(sc, m, l, cr, R, kb * BN);
        pack_p(sc, p);
      }
      // then per tile: its scores on the tensor cores while O is
      // corrected, then the previous tile's P V; its softmax while P V
      // runs on
      for (int it = 1; it < n; ++it) {
        const int s = (g + it) % STAGES, sp = (g + it - 1) % STAGES;
        mbar_wait(bars + 8 * s, ((g + it) / STAGES) & 1);
        float sc[64];
        turn_begin();
        wgmma_fence();
        issue_qk<D>(sc, qa, skv + 2 * s * TILE);
        rescale(o, cr);
        wgmma_fence();
        issue_pv(o, p, skv + (2 * sp + 1) * TILE);
        turn_end();
        wgmma_wait<1>();  // the scores are in
        fence_regs(sc);
        if (it == n - 1) mbar_arrive(qempty);
        softmax(sc, m, l, cr, R, (kb + it) * BN);
        wgmma_wait<0>();  // P V of the previous tile is done
        fence_regs(o);
        keep_regs(p);
        mbar_arrive(bars + 8 * (STAGES + sp));  // its stage is free again
        pack_p(sc, p);
      }
      if (n > 0) {  // the last tile's P V
        const int s = (g + n - 1) % STAGES;
        rescale(o, cr);
        turn_begin();
        wgmma_fence();
        issue_pv(o, p, skv + (2 * s + 1) * TILE);
        turn_end();
        wgmma_wait<0>();
        fence_regs(o);
        keep_regs(p);
        mbar_arrive(bars + 8 * (STAGES + s));
      }
      g += n;

      float l0 = l[0], l1 = l[1];
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      // acc / max(l, 1e-30), as a product with the reciprocal; 0 for a
      // row with no valid key at all
      const float i0 = m[0] == NEG ? 0.0f : 1.0f / fmaxf(l0, 1e-30f);
      const float i1 = m[1] == NEG ? 0.0f : 1.0f / fmaxf(l1, 1e-30f);
      const long long row = (long long)H * D;
      __nv_bfloat16* ob = out + ((long long)I.b * Sq * H + I.h) * D + R.cq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        if (R.r0 < Sq)
          *reinterpret_cast<uint32_t*>(ob + R.r0 * row + 8 * j) =
              pack_bf16(o[4 * j] * i0, o[4 * j + 1] * i0);
        if (R.r1 < Sq)
          *reinterpret_cast<uint32_t*>(ob + R.r1 * row + 8 * j) =
              pack_bf16(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
      }
    }
    if (cw == 0 && turn > 0)  // warpgroup 1's last arrival
      asm volatile("bar.sync 1, 256;" ::: "memory");
  }
}

// a 4-D map (D, heads, S, batch) over a contiguous bf16 [batch, S, heads,
// D] tensor, boxes of 64 x 1 x 128 x 1 with the 128-byte swizzle; rows
// past S read as zeros
static bool tensor_map(EncodeTiled enc, CUtensorMap* map, const void* ptr,
                       int batch, int S, int heads, int D) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)BN, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int B, int Sq, int Sk, int H, int KV, float scale,
                  int causal, int window, cudaStream_t stream) {
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) & 15)
    return (int)cudaErrorMisalignedAddress;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(enc, &tq, q, B, Sq, H, D) ||
      !tensor_map(enc, &tk, k, B, Sk, KV, D) ||
      !tensor_map(enc, &tv, v, B, Sk, KV, D))
    return (int)cudaErrorInvalidValue;
  const int smem = Cfg<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return (int)err;
  const long long work = (long long)B * H * ((Sq + BM - 1) / BM);
  if (work > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned ctas = (unsigned)(work < sms ? work : sms);  // persistent
  flash_wgmma_kernel<D><<<ctas, NTHREADS, smem, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)out, B, Sq, Sk, H, KV, scale * LOG2E,
      causal, window);
  return (int)cudaGetLastError();
}

}  // namespace wg

// ---------------------------------------------------------------------------
// entry point
// ---------------------------------------------------------------------------

// q [B, Sq, H, D], k and v [B, Sk, KV, D], out [B, Sq, H, D], all
// contiguous and of one type (dtype 0 = float32: the FFMA kernel, 1 =
// bfloat16: the wgmma kernel, whose pointers must be 16-byte aligned);
// D = 64 or 128, H a multiple of KV; window <= 0 means none; scale =
// D^-1/2 as a float32.  Returns cudaGetLastError() (or an error code for a
// shape, pointer or map the kernel does not take).
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
  if (D == 128 && dtype == 0)
    return launch<128, F32>(q, k, v, out, B, Sq, Sk, H, KV, scale, causal,
                            window, stream);
  if (D == 64 && dtype == 1)
    return wg::launch<64>(q, k, v, out, B, Sq, Sk, H, KV, scale, causal,
                          window, stream);
  if (D == 128 && dtype == 1)
    return wg::launch<128>(q, k, v, out, B, Sq, Sk, H, KV, scale, causal,
                           window, stream);
  return (int)cudaErrorInvalidValue;
}
