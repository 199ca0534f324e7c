// Decode attention (one query token against a KV cache, GQA), hand-written
// for Hopper (sm_90a): bfloat16 on the tensor cores (mma.sync on a TMA-fed
// ring), float32 on the FFMA units.
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
// len_b = clamp(lengths[b] or the scalar length, 0, S).  The softmax is
// online, in float32, with the TPU kernel's masking constant -1e30 (not
// -inf); the output is acc / max(l, 1e-30), so a row with len_b = 0 gives
// 0 (the TPU kernel's value there, a uniform mean over its padded tiles,
// is not kept).  Cache tiles wholly at or past len_b are never read.
//
// Bound on this card: bytes.  The kernel must read the valid cache rows
// once, 2 * sum_b len_b * KV * D elements, and q and out once; it does 4
// FLOP per cached element and head of the group, far below the card's
// rate per byte.  At decode_32k's per-layer shape (B = 128, len = S =
// 8,192, KV = 8, D = 128, bf16) that is 4.29 GB: 1.282 ms at 3.35 TB/s.
// What holds such a kernel back is bytes in flight: an SM's share of 3.35
// TB/s is about 25 KB a microsecond, so every SM must keep tens of KB of
// loads outstanding all the time.
//
// bfloat16 path (decode_mma_kernel<D, MT>, and decode_combine_kernel when
// the cache is split).  One CTA per (b, kv) and part of the cache: one
// producer warp and MT * KS consumer warps.  The G query rows of the KV
// head, padded to 16, are the M dimension of mma.sync m16n8k16 (bf16 in,
// float32 accumulators): MT = ceil(G / 16) m-tiles, 3 at G = 48.
//  - The ring.  One producer thread copies each 64-row K and V tile by TMA
//    (4-D maps (D, KV, S, B) over the caches as they lie, with their own
//    batch and row strides; 64-column boxes with the 128-byte swizzle; rows
//    past S zero-filled) into a ring of `stages` shared-memory stages of
//    bf16 (32 KB a stage at D = 128), each signalled by a "full" mbarrier
//    with its byte count and released by an "empty" mbarrier on which
//    every consumer warp arrives.  The producer waits only for a free
//    stage.  No CTA-wide barrier fences a tile, and no float32 copy of a
//    tile is stored.
//  - The consumers.  Warp w takes m-tile w / KS and, of every tile, the
//    keys of slice w % KS (KS = 4 slices of 16 keys at MT = 1, 2 of 32 at
//    MT = 2, one of 64 beyond).  Its q rows are loaded once into A
//    fragments (rows past G zero).  S = q K^T with the K fragments by
//    ldmatrix from the swizzled tile (a K row holds D contiguous values,
//    B's column as mma wants it); the float32 scores are scaled by D^-1/2
//    (q stays the exact bf16 input: a few float32 ulps from the TPU
//    kernel's order), masked, and go through the online softmax with the
//    precise expf (m the row max, shared by the quad of lanes that holds a
//    row; l summed per lane and over the quad at the end).  O += P V with
//    p rounded to bf16 as the A fragment (the score fragment's layout is
//    the A operand's) and V by ldmatrix.trans.  Each warp keeps its own m,
//    l and O; they are merged once, at the end, in shared memory laid over
//    the ring.
//  - The trap of TMA here.  It zero-fills only rows past S, so the last
//    tile's rows in [len_b, S) arrive holding whatever the cache holds
//    (stale rows, or NaN in a buffer never written).  Their scores are set
//    to -1e30 by a select, never an add, and their V values are zeroed in
//    the B fragments before P V (0 * NaN is NaN).  A warp that has met only
//    such keys (its slice of a part's only tile lies past len_b) has m =
//    -1e30 and finite garbage in l: the merge weighs it by exp(-1e30 - M)
//    = 0.
//  - Split-KV.  When B * KV leaves SMs idle, the wrapper cuts each (b, kv)'s
//    tiles into `parts` contiguous ranges of `tiles_per_part` (grid y).  A
//    part writes float32 (acc[G][D], m, l) to a workspace [parts][B][H]
//    (all acc, then all m, then all l), and decode_combine_kernel merges
//    the parts in split order (no atomics: deterministic) into the output
//    in q's type.  A part whose range lies wholly past len_b reads nothing
//    and writes (0, -1e30, 0), which the merge weighs by 0 (or, when len_b
//    = 0, by 1 with l = 0: the output is 0).  With one part the CTA writes
//    the output itself, and there is no workspace and no second launch.
//
// float32 path (decode_kernel<D, F32>): the 2e-5 bound rules out TF32 on the
// tensor cores.  One CTA of 256 threads per (b, kv).  The G query rows of
// the KV head are staged once in shared memory as float32 and stay
// resident.  A loop inside the CTA walks the cache in 64-row tiles (the TPU
// kernel's sequential grid axis) and stops at the last tile holding a valid
// entry: tiles wholly at or past len_b are never read, and the rows of the
// last tile past len_b are zero-filled, not loaded.  Each thread loads its
// 16-byte chunks of a K and a V tile (coalesced along D) into registers and,
// once the CTA is done with the previous tile, stores them to shared memory
// as float32 (K with a padded row, so that the 32 lanes of a warp, one row
// each, hit 32 banks); the next tile's loads are issued before the current
// tile is computed, so they are in flight meanwhile.  Warp w owns query rows
// g = w, w + 8, ...: its lanes compute the scores of rows lane and lane +
// 32, reduce the max and the sum by shuffles and write p to shared memory.
// The accumulator [G][D] lives in shared memory; thread t owns its elements
// e = t + 256 i (g = e / D, d = e % D, the same d for every i since D
// divides 256), rescales each by corr[g] and adds p[g][j] * v[j][d] over the
// tile's rows in a register.  G * D <= 6144 (G <= 48 at D = 128, the MQA of
// granite-34b) bounds shared memory.  Precise expf and IEEE division (no
// fast math).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

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

// ---------------------------------------------------------------------------
// bfloat16: mma.sync on a TMA-fed ring
// ---------------------------------------------------------------------------

namespace mma {

constexpr int ROWS = 64;          // cache rows per tile: a TMA box's rows
constexpr int BOX = ROWS * 128;   // one 64-row x 64-column bf16 box: 8 KB
constexpr float NEG = -1e30f;

template <int D, int MT>
struct Cfg {
  static constexpr int KS = MT == 1 ? 4 : MT == 2 ? 2 : 1;  // key slices
  static constexpr int CW = MT * KS;             // consumer warps
  static constexpr int NTHREADS = 32 * (CW + 1);  // and the producer
  // at MT <= 2, registers for two CTAs an SM (the kernel takes 147 a
  // thread at D = 128; a bound of three CTAs caps it at 128 and spills);
  // beyond, whatever the kernel needs
  static constexpr int MIN_CTAS = MT <= 2 ? 2 : 1;
  static constexpr int R = ROWS / KS;            // a consumer's keys a tile
  static constexpr int TILE = (D / 64) * BOX;    // a 64 x D tile of K or V
  static constexpr int OS = D + 8;               // the merge's row stride
  // the merge's floats per consumer warp: O [16][OS], m [16], l [16]
  static constexpr int WARP_MERGE = 16 * OS + 32;
  static constexpr int MERGE = CW * WARP_MERGE * 4;  // bytes
};

// the ring, or the merge laid over it, then the 2 * stages mbarriers
template <int D, int MT>
__host__ __device__ __forceinline__ size_t ring_bytes(int stages) {
  const size_t ring = (size_t)stages * 2 * Cfg<D, MT>::TILE;
  return ring > (size_t)Cfg<D, MT>::MERGE ? ring : (size_t)Cfg<D, MT>::MERGE;
}

template <int D, int MT>
static size_t smem_bytes(int stages) {
  return ring_bytes<D, MT>(stages) + 16 * (size_t)stages +
         1024;  // slack to align the base to 1024 (the swizzle's period)
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a b for one m16n8k16 tile: bf16 in, float32 accumulators
__device__ __forceinline__ void mma16816(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo, low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// the shared-memory address of 16-byte chunk `chunk` (of D / 8) of row
// `row` of a tile that TMA wrote as 64-column boxes with the 128-byte
// swizzle (chunk c of a 128-byte row lies at c ^ (row % 8))
__device__ __forceinline__ uint32_t swizzled(uint32_t tile, int row,
                                             int chunk) {
  return tile + (chunk >> 3) * BOX + row * 128 +
         (((chunk & 7) ^ (row & 7)) << 4);
}

template <int D, int MT>
__global__ void __launch_bounds__(Cfg<D, MT>::NTHREADS,
                                  Cfg<D, MT>::MIN_CTAS)
    decode_mma_kernel(const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const unsigned short* __restrict__ q,
                      __nv_bfloat16* __restrict__ out, float* __restrict__ ws,
                      const int* __restrict__ lengths, int length, int B,
                      int S, int H, int KV, int tiles_per_part, int stages,
                      float scale) {
  typedef Cfg<D, MT> C;
  constexpr int KS = C::KS, CW = C::CW, R = C::R, TILE = C::TILE;
  constexpr int OS = C::OS, WM = C::WARP_MERGE;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = smem_addr(smem_raw);
  const uint32_t ring = (base + 1023) & ~1023u;  // stage s: K, then V
  // full[s] at bars + 8 s, empty[s] at bars + 8 (stages + s)
  const uint32_t bars = ring + (uint32_t)ring_bytes<D, MT>(stages);
  float* merge = reinterpret_cast<float*>(smem_raw + (ring - base));

  const int part = blockIdx.y, parts = gridDim.y;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV, G = H / KV;
  int len = lengths != nullptr ? lengths[b] : length;
  len = min(max(len, 0), S);
  // this part's tiles: [t0, t0 + tiles_per_part), cut at the last one
  // holding a valid entry
  const int t0 = part * tiles_per_part;
  const int n_tiles =
      max(min(t0 + tiles_per_part, (len + ROWS - 1) / ROWS) - t0, 0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (stages + s), CW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // a consumer lane's part of the result: rows r0 = 16 mt + lane / 4 and
  // r0 + 8 of its m-tile, columns 8 n + 2 (lane % 4) + {0, 1} of O
  float m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f};
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;

  if (warp == CW) {
    // ---- producer: one thread keeps the ring full ----
    if (lane == 0) {
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % stages;
        mbar_wait(bars + 8 * (stages + s), ((i / stages) & 1) ^ 1);
        const uint32_t full = bars + 8 * s, kt = ring + 2 * s * TILE;
        const int s0 = (t0 + i) * ROWS;
        mbar_expect_tx(full, 2 * TILE);
        for (int c = 0; c < D / 64; ++c) {
          tma_load(kt + c * BOX, &tk, full, 64 * c, kvh, s0, b);
          tma_load(kt + TILE + c * BOX, &tv, full, 64 * c, kvh, s0, b);
        }
      }
    }
  } else {
    // ---- consumers: m-tile warp / KS, key slice warp % KS ----
    const int mt = warp / KS, row0 = (warp % KS) * R;
    const int tq = lane & 3;
    const int r0 = 16 * mt + (lane >> 2), r1 = r0 + 8;
    const unsigned short* qb = q + ((long long)b * H + (long long)kvh * G) * D;
    auto q2 = [&](int r, int d) -> uint32_t {  // q[r][d], q[r][d + 1]
      if (r >= G) return 0u;
      return (uint32_t)qb[r * D + d] | ((uint32_t)qb[r * D + d + 1] << 16);
    };
    uint32_t qa[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int d = 16 * kk + 2 * tq;
      qa[kk][0] = q2(r0, d);
      qa[kk][1] = q2(r1, d);
      qa[kk][2] = q2(r0, d + 8);
      qa[kk][3] = q2(r1, d + 8);
    }

    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % stages;
      mbar_wait(bars + 8 * s, (i / stages) & 1);
      const uint32_t kt = ring + 2 * s * TILE, vt = kt + TILE;
      const int k0 = (t0 + i) * ROWS + row0;  // the slice's first position
      const bool edge = k0 + R > len;  // the slice holds rows past len_b

      // S = q K^T over the slice's R keys
      float sc[R / 8][4];
#pragma unroll
      for (int j = 0; j < R / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
        const int row = row0 + 8 * j + (lane & 7);
#pragma unroll
        for (int kk = 0; kk < D / 32; ++kk) {
          uint32_t kb[4];  // two k-steps of 16 columns of D
          ldsm4(kb, swizzled(kt, row, 4 * kk + (lane >> 3)));
          mma16816(sc[j], qa[2 * kk], kb[0], kb[1]);
          mma16816(sc[j], qa[2 * kk + 1], kb[2], kb[3]);
        }
      }

      // the online softmax, in float32: scale, mask by a select, row max
      // over the quad of lanes holding a row, the precise expf
      float mx0 = m[0], mx1 = m[1];
#pragma unroll
      for (int j = 0; j < R / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = sc[j][e] * scale;
          sc[j][e] = !edge || k0 + 8 * j + 2 * tq + (e & 1) < len ? x : NEG;
        }
        mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
        mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float c0 = expf(m[0] - mx0), c1 = expf(m[1] - mx1);
      m[0] = mx0;
      m[1] = mx1;
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int j = 0; j < R / 8; ++j) {
        sc[j][0] = expf(sc[j][0] - mx0);
        sc[j][1] = expf(sc[j][1] - mx0);
        sc[j][2] = expf(sc[j][2] - mx1);
        sc[j][3] = expf(sc[j][3] - mx1);
        sum0 += sc[j][0] + sc[j][1];
        sum1 += sc[j][2] + sc[j][3];
      }
      l[0] = l[0] * c0 + sum0;
      l[1] = l[1] * c1 + sum1;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][0] *= c0;
        o[n][1] *= c0;
        o[n][2] *= c1;
        o[n][3] *= c1;
      }

      // O += P V, 16 keys a step; V values of rows past len_b are zeroed
      // in the fragments (a lane's B values are keys 2 tq, 2 tq + 1 and
      // those + 8 of the step)
#pragma unroll
      for (int kv = 0; kv < R / 16; ++kv) {
        const uint32_t pa[4] = {
            pack_bf16(sc[2 * kv][0], sc[2 * kv][1]),
            pack_bf16(sc[2 * kv][2], sc[2 * kv][3]),
            pack_bf16(sc[2 * kv + 1][0], sc[2 * kv + 1][1]),
            pack_bf16(sc[2 * kv + 1][2], sc[2 * kv + 1][3])};
        uint32_t lo = 0xffffffffu, hi = 0xffffffffu;
        if (edge) {
          const int key = k0 + 16 * kv + 2 * tq;
          lo = (key < len ? 0xffffu : 0u) | (key + 1 < len ? 0xffff0000u : 0u);
          hi = (key + 8 < len ? 0xffffu : 0u) |
               (key + 9 < len ? 0xffff0000u : 0u);
        }
        const int row = row0 + 16 * kv + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int c = 0; c < D / 16; ++c) {
          uint32_t vb[4];  // two 8-column tiles of D
          ldsm4_t(vb, swizzled(vt, row, 2 * c + (lane >> 4)));
          mma16816(o[2 * c], pa, vb[0] & lo, vb[1] & hi);
          mma16816(o[2 * c + 1], pa, vb[2] & lo, vb[3] & hi);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (stages + s));  // stage free
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l[0] += __shfl_xor_sync(0xffffffffu, l[0], off);
      l[1] += __shfl_xor_sync(0xffffffffu, l[1], off);
    }
  }

  __syncthreads();  // every tile is consumed: the merge takes the ring
  if (warp < CW) {
    float* mw = merge + warp * WM;
    const int g = lane >> 2, c = 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      mw[g * OS + 8 * n + c] = o[n][0];
      mw[g * OS + 8 * n + c + 1] = o[n][1];
      mw[(g + 8) * OS + 8 * n + c] = o[n][2];
      mw[(g + 8) * OS + 8 * n + c + 1] = o[n][3];
    }
    if (c == 0) {
      mw[16 * OS + g] = m[0];
      mw[16 * OS + g + 8] = m[1];
      mw[16 * OS + 16 + g] = l[0];
      mw[16 * OS + 24 + g] = l[1];
    }
  }
  __syncthreads();

  // the KS slices of each row, merged: out = acc / max(l, 1e-30) with one
  // part, else (acc, m, l) into this part's workspace rows
  const long long bh0 = (long long)b * H + (long long)kvh * G;
  const long long n_rows = (long long)parts * B * H;
  for (int e = threadIdx.x; e < G * D; e += C::NTHREADS) {
    const int row = e / D, d = e % D;
    const float* mw = merge + (row >> 4) * KS * WM;
    const int rr = row & 15;
    float M = NEG;
#pragma unroll
    for (int k = 0; k < KS; ++k) M = fmaxf(M, mw[k * WM + 16 * OS + rr]);
    float L = 0.0f, A = 0.0f;
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      const float w = expf(mw[k * WM + 16 * OS + rr] - M);
      L += mw[k * WM + 16 * OS + 16 + rr] * w;
      A += mw[k * WM + rr * OS + d] * w;
    }
    if (parts == 1) {
      out[(bh0 + row) * D + d] = __float2bfloat16_rn(A / fmaxf(L, 1e-30f));
    } else {
      const long long pr = part * (long long)B * H + bh0 + row;
      ws[pr * D + d] = A;
      if (d == 0) {
        ws[n_rows * D + pr] = M;
        ws[n_rows * (D + 1) + pr] = L;
      }
    }
  }
}

// the parts of each (b, h) row merged in split order: one CTA per row,
// one thread per column of D
__global__ void decode_combine_kernel(const float* __restrict__ ws,
                                      __nv_bfloat16* __restrict__ out,
                                      int parts, int BH, int D) {
  const long long n_rows = (long long)parts * BH;
  const float* wm = ws + n_rows * D;
  const float* wl = wm + n_rows;
  const int bh = blockIdx.x;
  float M = NEG;
  for (int p = 0; p < parts; ++p) M = fmaxf(M, wm[(long long)p * BH + bh]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float L = 0.0f, A = 0.0f;
    for (int p = 0; p < parts; ++p) {
      const long long pr = (long long)p * BH + bh;
      const float w = expf(wm[pr] - M);
      L += wl[pr] * w;
      A += ws[pr * D + d] * w;
    }
    out[(long long)bh * D + d] = __float2bfloat16_rn(A / fmaxf(L, 1e-30f));
  }
}

// a 4-D map (D, KV, S, B) over a bf16 cache [B, S, KV, D] read through its
// batch and row strides (in elements; each row's [KV, D] dense), boxes of
// 64 x 1 x 64 x 1 with the 128-byte swizzle; rows past S read as zeros
static bool cache_map(EncodeTiled enc, CUtensorMap* map, const void* ptr,
                      int B, int S, int KV, int D, long long sb,
                      long long ss) {
  // the stride of an extent-1 dimension is never used: give it one that
  // TMA takes
  if (S == 1) ss = (long long)KV * D;
  if (B == 1) sb = ss * S;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)KV, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)ROWS, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int MT>
static int launch(const CUtensorMap& tk, const CUtensorMap& tv,
                  const void* q, void* out, float* ws, const int* lengths,
                  int length, int B, int S, int H, int KV, int parts,
                  int tiles_per_part, int stages, float scale,
                  cudaStream_t stream) {
  const size_t smem = smem_bytes<D, MT>(stages);
  cudaError_t err = cudaFuncSetAttribute(
      decode_mma_kernel<D, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_mma_kernel<D, MT>
      <<<dim3((unsigned)(B * KV), (unsigned)parts), Cfg<D, MT>::NTHREADS,
         smem, stream>>>(tk, tv, (const unsigned short*)q,
                         (__nv_bfloat16*)out, ws, lengths, length, B, S, H,
                         KV, tiles_per_part, stages, scale);
  return (int)cudaGetLastError();
}

}  // namespace mma

// ---------------------------------------------------------------------------
// entry points
// ---------------------------------------------------------------------------

// float32.  q [B, 1, H, D] and out [B, 1, H, D] contiguous; k and v
// [B, S, KV, D] with batch strides k_sb, v_sb and row strides k_ss, v_ss in
// elements (the [KV, D] of a row dense), every row 16-byte aligned; lengths
// an int32 [B] on the device, or null to use the scalar length; D = 64 or
// 128; H a multiple of KV with (H / KV) * D <= 6144; scale = D^-1/2 as a
// float32.  Returns cudaGetLastError() (or cudaErrorInvalidValue for a
// shape the kernel does not take).
extern "C" int decode_attention_f32(const void* q, const void* k,
                                    const void* v, void* out,
                                    const int* lengths, int length, int B,
                                    int S, int H, int KV, int D,
                                    long long k_sb, long long k_ss,
                                    long long v_sb, long long v_ss,
                                    float scale, cudaStream_t stream) {
  if (B <= 0 || H <= 0) return 0;
  if (S <= 0 || KV <= 0 || H % KV != 0 || (H / KV) * D > MAX_GD ||
      (long long)B * KV > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (D == 64)
    return launch<64, F32>(q, k, v, out, lengths, length, B, S, H, KV, k_sb,
                           k_ss, v_sb, v_ss, scale, stream);
  if (D == 128)
    return launch<128, F32>(q, k, v, out, lengths, length, B, S, H, KV, k_sb,
                            k_ss, v_sb, v_ss, scale, stream);
  return (int)cudaErrorInvalidValue;
}

// bfloat16.  The same arguments (k and v 16-byte aligned, as TMA needs),
// and the split: each (b, kv)'s 64-row tiles cut into `parts` ranges of
// `tiles_per_part` (parts * tiles_per_part covering the tiles of S, or of
// the scalar length), a ring of `stages` stages; with parts > 1, ws is a
// float32 workspace of parts * B * H * (D + 2) and decode_attention_combine
// must follow on the same stream.
extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, void* out, float* ws,
                                     const int* lengths, int length, int B,
                                     int S, int H, int KV, int D,
                                     long long k_sb, long long k_ss,
                                     long long v_sb, long long v_ss,
                                     float scale, int parts,
                                     int tiles_per_part, int stages,
                                     cudaStream_t stream) {
  if (B <= 0 || H <= 0) return 0;
  if (S <= 0 || KV <= 0 || H % KV != 0 || (D != 64 && D != 128) ||
      (H / KV) * D > MAX_GD || (long long)B * KV > 0x7fffffffLL ||
      parts < 1 || parts > 65535 || tiles_per_part < 1 || stages < 1 ||
      (parts > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)k | (uintptr_t)v) & 15)
    return (int)cudaErrorMisalignedAddress;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tk, tv;
  if (!mma::cache_map(enc, &tk, k, B, S, KV, D, k_sb, k_ss) ||
      !mma::cache_map(enc, &tv, v, B, S, KV, D, v_sb, v_ss))
    return (int)cudaErrorInvalidValue;
  const int MT = (H / KV + 15) / 16;  // 1 to 3 at D = 128, to 6 at 64
#define DECODE_MMA(d, mt)                                                   \
  if (D == d && MT == mt)                                                   \
    return mma::launch<d, mt>(tk, tv, q, out, ws, lengths, length, B, S, H, \
                              KV, parts, tiles_per_part, stages, scale,     \
                              stream);
  DECODE_MMA(128, 1)
  DECODE_MMA(128, 2)
  DECODE_MMA(128, 3)
  DECODE_MMA(64, 1)
  DECODE_MMA(64, 2)
  DECODE_MMA(64, 3)
  DECODE_MMA(64, 4)
  DECODE_MMA(64, 5)
  DECODE_MMA(64, 6)
#undef DECODE_MMA
  return (int)cudaErrorInvalidValue;
}

// the second pass of a split bf16 call: ws as decode_attention_bf16 wrote
// it, out [B, 1, H, D] bfloat16.
extern "C" int decode_attention_combine(const float* ws, void* out,
                                        int parts, int B, int H, int D,
                                        cudaStream_t stream) {
  if (B <= 0 || H <= 0) return 0;
  if (parts < 1 || D <= 0 || D > 1024 || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  mma::decode_combine_kernel<<<(unsigned)(B * H), D, 0, stream>>>(
      ws, (__nv_bfloat16*)out, parts, B * H, D);
  return (int)cudaGetLastError();
}
