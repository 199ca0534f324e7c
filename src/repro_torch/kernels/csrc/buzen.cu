// Buzen's log-space DP for a batch of closed networks, hand-written for
// Hopper (sm_90a).  Two kernels share one per-m body:
//
//   buzen_kernel          replaces repro/kernels/buzen.py::buzen_pallas_batched
//                         (body _buzen_kernel): S single-server stations,
//                         the geometric series k * log_rho[b, s];
//   buzen_classes_kernel  replaces repro/kernels/buzen.py::
//                         buzen_classes_pallas_batched (body
//                         _buzen_classes_kernel): S client classes, each a
//                         precomputed negative-binomial series
//                         series[b, s, 0..m_max] (built on the host in
//                         float64 and rounded once to float32).
//
// For each batch row b the running log-constant row U[0..m_max] starts from
// the aggregated infinite-server Poisson row init[b, :] and folds the S
// columns in order:
//
//     U'[m] = logsumexp_{k <= m} (term_s(k) + U[m - k])
//
// in float32, masked terms (k > m) entering as NEG_INF exactly as the TPU
// kernels' (m_pad x m_pad) masked reductions do: they take part in the max
// and add exp(NEG_INF - max) each to the sum.
//
// Layout: one CTA per batch row; the column loop runs inside the block (the
// TPU's sequential grid axis).  U lives in shared memory, double buffered
// with one __syncthreads() per column, so no thread overwrites U while
// another still reads U[m - k].  The class kernel stages each class's
// series into a third shared row before that column's barrier, so the
// inner loop reads shared memory only.  Each thread owns the m of its index
// (strided by blockDim) and takes the logsumexp in two passes, max then
// sum, as the TPU kernels do.
//
// Bound: operations — about B * S * (m+1)(m+2)/2 terms, each an add (or a
// multiply-add), a max, a subtract, an exp and an add in float32; the bytes
// moved (the [B, S] loads or the [B, S, m+1] series, the [B, m+1] init and
// output rows) are small beside them.  This first version is
// latency-bound: one block of ceil((m+1)/32) warps per row, and the work
// per thread grows with its m.
#include <cuda_runtime.h>
#include <math.h>

#define NEG_INF_F (-1e30f)

// the per-client station's term: k * log_rho + U[m - k]
struct GeometricTerm {
  float lr;
  const float* u;
  __device__ __forceinline__ float operator()(int m, int k) const {
    return (float)k * lr + u[m - k];
  }
};

// a class's term: series[k] + U[m - k], the series in shared memory
struct SeriesTerm {
  const float* series;
  const float* u;
  __device__ __forceinline__ float operator()(int m, int k) const {
    return series[k] + u[m - k];
  }
};

// logsumexp over k = 0..m_pad-1 of the masked terms of row m: term(m, k)
// for k <= m, NEG_INF for the m_pad - 1 - m masked ones
template <typename Term>
__device__ __forceinline__ float masked_logsumexp(const Term& term, int m,
                                                  int m_pad) {
  const int n_masked = m_pad - 1 - m;
  float mx = n_masked > 0 ? NEG_INF_F : -INFINITY;
  for (int k = 0; k <= m; ++k) mx = fmaxf(mx, term(m, k));
  float sum = n_masked > 0 ? (float)n_masked * expf(NEG_INF_F - mx) : 0.0f;
  for (int k = 0; k <= m; ++k) sum += expf(term(m, k) - mx);
  return mx + logf(sum);
}

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
    const GeometricTerm term{log_rho[(size_t)b * S + s], u};
    for (int m = threadIdx.x; m < m_pad; m += blockDim.x)
      v[m] = masked_logsumexp(term, m, m_pad);
    __syncthreads();
    float* tmp = u;
    u = v;
    v = tmp;
  }
  for (int m = threadIdx.x; m < m_pad; m += blockDim.x)
    out[(size_t)b * m_pad + m] = u[m];
}

__global__ void buzen_classes_kernel(const float* __restrict__ series,
                                     const float* __restrict__ init,
                                     float* __restrict__ out, int S,
                                     int m_pad) {
  extern __shared__ float smem[];
  float* u = smem;
  float* v = smem + m_pad;
  float* w = smem + 2 * m_pad;  // the current class's series
  const int b = blockIdx.x;
  for (int m = threadIdx.x; m < m_pad; m += blockDim.x)
    u[m] = init[(size_t)b * m_pad + m];
  for (int s = 0; s < S; ++s) {
    // every thread passed the previous column's barrier, so no one still
    // reads w: stage this class's series, then one barrier covers it and
    // the previous column's writes of u
    const float* row = series + ((size_t)b * S + s) * m_pad;
    for (int m = threadIdx.x; m < m_pad; m += blockDim.x) w[m] = row[m];
    __syncthreads();
    const SeriesTerm term{w, u};
    for (int m = threadIdx.x; m < m_pad; m += blockDim.x)
      v[m] = masked_logsumexp(term, m, m_pad);
    __syncthreads();
    float* tmp = u;
    u = v;
    v = tmp;
  }
  __syncthreads();
  for (int m = threadIdx.x; m < m_pad; m += blockDim.x)
    out[(size_t)b * m_pad + m] = u[m];
}

static int threads_for(int m_pad) {
  int threads = ((m_pad + 31) / 32) * 32;
  return threads > 256 ? 256 : threads;
}

extern "C" int buzen_forward(const float* log_rho, const float* init,
                             float* out, int B, int S, int m_pad,
                             cudaStream_t stream) {
  const size_t smem = 2 * (size_t)m_pad * sizeof(float);
  if (B > 0)
    buzen_kernel<<<B, threads_for(m_pad), smem, stream>>>(log_rho, init, out,
                                                          S, m_pad);
  return (int)cudaGetLastError();
}

extern "C" int buzen_classes_forward(const float* series, const float* init,
                                     float* out, int B, int S, int m_pad,
                                     cudaStream_t stream) {
  const size_t smem = 3 * (size_t)m_pad * sizeof(float);
  if (B > 0)
    buzen_classes_kernel<<<B, threads_for(m_pad), smem, stream>>>(
        series, init, out, S, m_pad);
  return (int)cudaGetLastError();
}
