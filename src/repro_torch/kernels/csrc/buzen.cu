// Buzen's log-space DP for a batch of closed networks, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/buzen.py::buzen_pallas_batched
// (body _buzen_kernel).  For each batch row b the running log-constant row
// U[0..m_max] starts from the aggregated infinite-server Poisson row
// init[b, :] and folds S single-server stations in order:
//
//     U'[m] = logsumexp_{k <= m} (k * log_rho[b, s] + U[m - k])
//
// in float32, masked terms (k > m) entering as NEG_INF exactly as the TPU
// kernel's (m_pad x m_pad) masked reduction does.
//
// Layout: one CTA per batch row; the station loop runs inside the block
// (the TPU's sequential grid axis).  U lives in shared memory, double
// buffered with one __syncthreads() per station, so no thread overwrites U
// while another still reads U[m - k].  Each thread owns the m of its index
// (strided by blockDim) and takes the logsumexp in two passes, max then
// sum, as the TPU kernel does.
//
// Bound: operations — about B * S * (m+1)(m+2)/2 terms, each a multiply-add,
// a max, a subtract, an exp and an add in float32; the bytes moved (the
// [B, S] loads, the [B, m+1] init and output rows) are negligible.  This
// first version is latency-bound: one block of ceil((m+1)/32) warps per
// row, and the work per thread grows with its m.
#include <cuda_runtime.h>
#include <math.h>

#define NEG_INF_F (-1e30f)

__global__ void buzen_kernel(const float* __restrict__ log_rho,
                             const float* __restrict__ init,
                             float* __restrict__ out, int S, int m_pad) {
  extern __shared__ float smem[];
  float* u = smem;
  float* v = smem + m_pad;
  const int b = blockIdx.x;
  for (int m = threadIdx.x; m < m_pad; m += blockDim.x)
    u[m] = init[(size_t)b * m_pad + m];
  __syncthreads();
  for (int s = 0; s < S; ++s) {
    const float lr = log_rho[(size_t)b * S + s];
    for (int m = threadIdx.x; m < m_pad; m += blockDim.x) {
      // masked terms (k > m) are NEG_INF: they take part in the max and
      // add exp(NEG_INF - max) each to the sum, as in the TPU kernel
      const int n_masked = m_pad - 1 - m;
      float mx = n_masked > 0 ? NEG_INF_F : -INFINITY;
      for (int k = 0; k <= m; ++k) {
        const float t = (float)k * lr + u[m - k];
        mx = fmaxf(mx, t);
      }
      float sum = n_masked > 0 ? (float)n_masked * expf(NEG_INF_F - mx)
                               : 0.0f;
      for (int k = 0; k <= m; ++k) {
        const float t = (float)k * lr + u[m - k];
        sum += expf(t - mx);
      }
      v[m] = mx + logf(sum);
    }
    __syncthreads();
    float* tmp = u;
    u = v;
    v = tmp;
  }
  for (int m = threadIdx.x; m < m_pad; m += blockDim.x)
    out[(size_t)b * m_pad + m] = u[m];
}

extern "C" int buzen_forward(const float* log_rho, const float* init,
                             float* out, int B, int S, int m_pad,
                             cudaStream_t stream) {
  int threads = ((m_pad + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  const size_t smem = 2 * (size_t)m_pad * sizeof(float);
  if (B > 0)
    buzen_kernel<<<B, threads, smem, stream>>>(log_rho, init, out, S, m_pad);
  return (int)cudaGetLastError();
}
