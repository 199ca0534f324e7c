// The key chain of the counter-based random numbers, hand-written for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: the JAX package reaches XLA's threefry2x32
// (jax._src.prng.threefry2x32_p) through jax.random, and its event engines
// draw a block of events by a scan over a serial chain of keys,
//
//     k_{i+1} = split(k_i)[0] = threefry2x32(k_i, (0, 0)),
//
// then hash each event's subkeys split(k_i)[s] = threefry2x32(k_i, (0, s))
// and the words drawn from them (repro/core/events.py::draw_event_blocks,
// repro/fl/engine.py's per-round split of the data key).  Only the chain is
// serial; everything drawn from a chain key is independent.  In PyTorch on
// the card each chain step is a hundred launches, so this kernel walks the
// chain and draws every word of a block of events for all lanes in one
// launch.
//
// Inputs: keys [L, 2] (the key before the block's first event), n events,
// and P paths [P, 4] int32: a path (s, c1, c2, c3) is the subkey s of the
// event's key, then the hashes of the counters (0, c1), (0, c2), (0, c3)
// in turn (a counter of -1 ends the path).  A draw of shape () from a key
// hashes the counter (0, 0); a 2-way split of it gives the keys at (0, 0)
// and (0, 1); so every word of JAX's block draws is one path.
// Outputs: chain [L, n, 2], the key after event i (JAX's chain[i]), and
// words [L, n, P, 2], path p's two output words for event i.  Words are
// 32-bit values carried in int64, as PyTorch holds them.
//
// Layout: one CTA of 256 threads per lane.  Thread 0 walks the lane's
// chain with the key in registers and writes each key to `chain` (global
// memory, so n is not bounded by shared memory); after __syncthreads, which
// makes those writes visible to the CTA, the threads stride over the n * P
// (event, path) pairs.
//
// Bound: operations, and of those the chain's latency.  One threefry2x32
// is 20 rounds of a dependent add, rotate and xor plus 5 key injections,
// about 70 dependent integer operations; n of them in a row on one thread
// are the floor of a block, whatever the number of lanes.  The n * P path
// hashes are independent and spread over the CTA.
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t c0, uint32_t c1,
                                             uint32_t* o0, uint32_t* o1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  *o0 = x0;
  *o1 = x1;
}

__global__ void threefry_chain_kernel(const long long* __restrict__ keys,
                                      const int* __restrict__ paths, int n,
                                      int P, long long* __restrict__ chain,
                                      long long* __restrict__ words) {
  const int lane = blockIdx.x;
  const long long* k_in = keys + 2 * lane;
  long long* ch = chain + 2LL * lane * n;
  if (threadIdx.x == 0) {
    uint32_t k0 = (uint32_t)k_in[0], k1 = (uint32_t)k_in[1];
    for (int i = 0; i < n; ++i) {
      threefry2x32(k0, k1, 0u, 0u, &k0, &k1);
      ch[2 * i] = k0;
      ch[2 * i + 1] = k1;
    }
  }
  __syncthreads();
  long long* out = words + 2LL * lane * n * P;
  const long long total = (long long)n * P;
  for (long long t = threadIdx.x; t < total; t += THREADS) {
    const int i = (int)(t / P), p = (int)(t % P);
    const long long* k = i == 0 ? k_in : ch + 2 * (i - 1);
    const int* path = paths + 4 * p;
    uint32_t w0, w1;
    threefry2x32((uint32_t)k[0], (uint32_t)k[1], 0u, (uint32_t)path[0], &w0,
                 &w1);
    for (int d = 1; d < 4 && path[d] >= 0; ++d)
      threefry2x32(w0, w1, 0u, (uint32_t)path[d], &w0, &w1);
    out[2 * t] = w0;
    out[2 * t + 1] = w1;
  }
}

extern "C" int threefry_chain(const void* keys, const void* paths, int L,
                              int n, int P, void* chain, void* words,
                              void* stream) {
  if (L > 0 && n > 0)
    threefry_chain_kernel<<<L, THREADS, 0, (cudaStream_t)stream>>>(
        (const long long*)keys, (const int*)paths, n, P, (long long*)chain,
        (long long*)words);
  return (int)cudaGetLastError();
}
