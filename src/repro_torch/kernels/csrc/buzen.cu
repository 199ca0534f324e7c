// Buzen's log-space DP for a batch of closed networks, hand-written for
// Hopper (sm_90a).  Three kernels:
//
//   buzen_kernel           replaces repro/kernels/buzen.py::
//                          buzen_pallas_batched (body _buzen_kernel): S
//                          single-server stations, the geometric series
//                          k * log_rho[b, s];
//   buzen_backward_kernel  replaces no Pallas kernel: it replaces the
//                          float64 VJP of repro/kernels/buzen.py::
//                          _buzen_log_Z_bwd (jax.vjp of _reference_log_Z),
//                          which the port ran as PyTorch autograd over the
//                          float64 DP at every Adam step of the sweep;
//   buzen_classes_kernel   replaces repro/kernels/buzen.py::
//                          buzen_classes_pallas_batched (body
//                          _buzen_classes_kernel): S client classes, each a
//                          precomputed negative-binomial series
//                          series[b, s, 0..m_max] (built on the host in
//                          float64 and rounded once to float32).
//
// For each batch row b the running log-constant row U[0..m_max] starts from
// the aggregated infinite-server Poisson row init[b, :] and folds the S
// columns in order:
//
//     U'[m] = logsumexp_{k <= m} (term_s(k) + U[m - k])
//
// with masked terms (k > m) entering as NEG_INF, as the TPU kernels'
// (m_pad x m_pad) masked reductions do: they take part in the max and add
// exp(NEG_INF - max) each to the sum.
//
// Every kernel runs one CTA per batch row; the column loop runs inside the
// block (the TPU's sequential grid axis), the running row double-buffered
// in shared memory with one __syncthreads() per column.
//
// buzen_kernel (the forward).  Bound by operations: B * S * (m+1)(m+2)/2
// terms, each an exp.  Every exp goes to the MUFU unit (ex2.approx.f32, 16
// results per clock per SM), which sets the floor: the kernel keeps the
// other work per term to a few float32 adds and one shared-memory read.
// Design, in log2 units (U2 = U log2 e, lr2 = lr log2 e):
//   * the terms of row m are k lr2 + U2[m - k] = m lr2 + Y[j], j = m - k,
//     with Y[j] = U2[j] - j lr2 formed once per element and column in
//     float64, so row m's max is m lr2 + max_{j <= m} Y[j] and a term's
//     shifted exponent is Y[j] - max Y;
//   * Y is stored split into float32 hi and lo parts (hi = Y rounded, lo =
//     Y - hi rounded), and the exponent is (Yh[j] - Rh) + Yl[j] with Rh the
//     row's largest Yh: the hi difference is exact (Sterbenz) wherever the
//     term matters and lo carries what rounding Y to float32 drops, so the
//     exponent is as good as one formed in float64, without a float64
//     operation or a float64-to-float32 conversion per term.  ex2.approx
//     takes it, the sum is float32, and the row is m lr2 + Rh + log2(sum)
//     in float64; U2 stays float64 and is rounded to float32 (natural
//     units) only at the output.  Rounding U to float32 at every column
//     was the float32 kernel's main error (|U| reaches 183 at the sweep's
//     shape, where a float32 ulp is 1.5e-5);
//   * the (m+1)(m+2)/2 terms of a column are spread evenly over the CTA: a
//     group of GROUP lanes takes rows m and m_pad - 1 - m together (m+1 and
//     m_pad - m terms: m_pad + 1 for every pair), its lanes over j, and
//     reduces both rows by shuffles: one pass for the max of Yh, one for
//     the sum.  A warp's four groups take consecutive pairs, so their reads
//     of Y overlap (broadcast) and their loops run the same length;
//   * a padded (load-0) station, log_rho clamped to NEG_INF, is not
//     computed: the TPU kernel's arithmetic gives it exactly U (its k = 0
//     term U[m] is the max, every k >= 1 term adds exp(~-1e30) = 0.0 and
//     the row is U[m] + log(1)); the next station's Y is formed from the
//     unchanged row as it would be from a computed one, so a padded run
//     equals the unpadded run, bitwise;
//   * the masked terms are left out of the loops: each would add
//     exp(NEG_INF - max), exactly 0 whenever some valid term is above
//     NEG_INF + 104, which holds for every row that starts from a finite
//     init row.  They are still counted once per row (n_masked * exp(
//     NEG_INF - max), and NEG_INF in the max), so a degenerate row, every
//     valid term near NEG_INF, comes out as the TPU kernel gives it.
//
// buzen_backward_kernel (the float64 adjoint).  With U_0 the Poisson row,
// U_s[m] = logsumexp_{k <= m} (U_{s-1}[k] + (m - k) lr_s) and g_S = g:
//
//     P_s[m, k]  = exp(U_{s-1}[k] + (m - k) lr_s - U_s[m])   (k <= m, <= 1)
//     g_{s-1}[k] = sum_{m >= k} g_s[m] P_s[m, k]
//     d/d lr_s   = sum_m sum_{k <= m} g_s[m] (m - k) P_s[m, k]
//     d/d lg     = sum_k k g_0[k]      (k = 0 is pinned in the Poisson row)
//
// Phase A recomputes U_1..U_S in float64 (exp and log in float64) into a
// [B, S+1, m_pad] scratch that stays in L2; phase B walks the stations
// back, a group of lanes per column pair (k, m_pad - 1 - k), its lanes over
// m, d/d lr_s reduced over the block once per station, in a fixed order (a
// row's partials never depend on the batch around it).  Every exponent is
// <= 0: P is never factored into exp(U_{s-1}[k] - k lr) exp(m lr - U_s[m]),
// whose factors overflow float64 at |k lr| ~ 900.  A non-finite lr_s is an
// explicit identity (rows and g pass through, its partial is 0), so the
// real columns' partials equal the unpadded run's bitwise.  Bound by
// operations: 2 * B * S * (m+1)(m+2)/2 float64 terms (one phase each), each
// an exp; a float64 exp is a software routine of some twenty float64
// instructions on this card, so the kernel runs far from a bound that
// counts it as one operation.
#include <cuda_runtime.h>
#include <math.h>

#define NEG_INF_F (-1e30f)
#define NEG_INF_D (-1e30)
#define LOG2E_D 1.4426950408889634
#define LN2_D 0.6931471805599453
// the masked term in log2 units
#define NEG_INF_2 (NEG_INF_D * LOG2E_D)

// lanes that share one pair of rows (forward, phase A) or of columns
// (phase B); a shuffle by xor of 4, 2, 1 stays inside the aligned group
constexpr int GROUP = 8;
constexpr int MAX_THREADS = 1024;
// the backward's float64 exp needs more than the 64 registers a thread of
// a 1024-thread block may have
constexpr int BWD_THREADS = 768;

// a class's term: series[k] + U[m - k], the series in shared memory
struct SeriesTerm {
  const float* series;
  const float* u;
  __device__ __forceinline__ float operator()(int m, int k) const {
    return series[k] + u[m - k];
  }
};

// logsumexp over k = 0..m_pad-1 of the masked terms of row m: term(m, k)
// for k <= m, NEG_INF for the m_pad - 1 - m masked ones (the class
// kernel's per-m body: each thread owns the m of its index and takes the
// logsumexp in two passes, max then sum, as the TPU kernel does)
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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T>
__device__ __forceinline__ T group_sum(T v) {
  for (int o = GROUP / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;  // the same bits on every lane: each step adds a commuted pair
}

__device__ __forceinline__ double group_max(double v) {
  for (int o = GROUP / 2; o > 0; o >>= 1)
    v = fmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One pair of a column's rows (or of the adjoint's columns) for a group:
// unit a < units takes a and m_pad - 1 - a (only a when they meet); the
// group's lane l takes the pair's concatenated positions l, l + GROUP, ...,
// so the first index of each is l in the first and first_b in the second.
struct Pair {
  int a, b;         // the two indices; -1 when absent
  int first_b;      // lane's first offset into the second
  __device__ __forceinline__ Pair(int unit, int units, int m_pad,
                                  int n_first, int lane) {
    const bool live = unit < units;
    a = live ? unit : -1;
    b = live && m_pad - 1 - unit != unit ? m_pad - 1 - unit : -1;
    first_b = ((lane - n_first) % GROUP + GROUP) % GROUP;
  }
};

// row m's terms k * lr + u[m - k] for k = k0, k0 + GROUP, ... <= m: their
// max, and the sum of their exponentials shifted by mx
__device__ __forceinline__ double row_max(const double* u, double lr, int m,
                                          int k0) {
  double mx = -INFINITY;
  double kd = (double)k0;
#pragma unroll 4
  for (int j = m - k0; j >= 0; j -= GROUP, kd += GROUP)
    mx = fmax(mx, fma(kd, lr, u[j]));
  return mx;
}

// float64 exp (natural units)
__device__ __forceinline__ double row_sum_exp(const double* u, double lr,
                                              int m, int k0, double mx) {
  double s = 0.0;
  double kd = (double)k0;
#pragma unroll 4
  for (int j = m - k0; j >= 0; j -= GROUP, kd += GROUP)
    s += exp(fma(kd, lr, u[j]) - mx);
  return s;
}

// the forward's row m over j = m - k0, m - k0 - GROUP, ... >= 0: the max
// of Yh, and the sum of exp2((Yh - rh) + Yl)
__device__ __forceinline__ float row_max_y(const float* yh, int m, int k0) {
  float mx = -INFINITY;
#pragma unroll 4
  for (int j = m - k0; j >= 0; j -= GROUP) mx = fmaxf(mx, yh[j]);
  return mx;
}

__device__ __forceinline__ float row_sum_y(const float2* y, int m, int k0,
                                           float rh) {
  float s = 0.0f;
#pragma unroll 4
  for (int j = m - k0; j >= 0; j -= GROUP) {
    const float2 v = y[j];
    s += ex2((v.x - rh) + v.y);
  }
  return s;
}

__device__ __forceinline__ float group_max_f(float v) {
  for (int o = GROUP / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Y = U2[j] - j lr2 of the column to come, split into its hi and lo parts
__device__ __forceinline__ void store_y(float2* y, float* yh, int j,
                                        double u2, double lr2) {
  const double v = fma(-(double)j, lr2, u2);
  const float hi = __double2float_rn(v);
  y[j] = make_float2(hi, __double2float_rn(v - (double)hi));
  yh[j] = hi;
}

// max + log2(sum) of a row whose n_masked masked terms (NEG_INF each,
// NEG_INF_2 in log2 units) the loops left out
__device__ __forceinline__ double finish_row_ex2(double mx, float s,
                                                 int n_masked) {
  if (n_masked > 0) {
    if (NEG_INF_2 > mx) {  // degenerate: a masked term is the max
      s *= ex2(__double2float_rn(mx - NEG_INF_2));
      mx = NEG_INF_2;
    }
    s += (float)n_masked * ex2(__double2float_rn(NEG_INF_2 - mx));
  }
  return mx + (double)log2f(s);
}

__device__ __forceinline__ double finish_row_exp(double mx, double s,
                                                 int n_masked) {
  if (n_masked > 0) {
    if (NEG_INF_D > mx) {
      s *= exp(mx - NEG_INF_D);
      mx = NEG_INF_D;
    }
    s += (double)n_masked * exp(NEG_INF_D - mx);
  }
  return mx + log(s);
}

// One column of the float64 DP over the CTA (the backward's phase A):
// v[m] = logsumexp_k (k lr + u[m - k]) for every m, the rows in pairs over
// the groups, float64 exp; every thread of the block must call it (the
// groups shuffle)
__device__ __forceinline__ void fold_column_f64(const double* u, double* v,
                                                double* global_row,
                                                double lr, int m_pad) {
  const int lane = threadIdx.x % GROUP;
  const int groups = blockDim.x / GROUP;
  const int units = (m_pad + 1) / 2;
  for (int r = 0; r * groups < units; ++r) {
    const int unit = threadIdx.x / GROUP + r * groups;
    const Pair p(unit, units, m_pad, unit + 1, lane);
    const double ma = group_max(row_max(u, lr, p.a, lane));
    const double mb = group_max(row_max(u, lr, p.b, p.first_b));
    const double va = finish_row_exp(
        ma, group_sum(row_sum_exp(u, lr, p.a, lane, ma)), m_pad - 1 - p.a);
    const double vb = finish_row_exp(
        mb, group_sum(row_sum_exp(u, lr, p.b, p.first_b, mb)),
        m_pad - 1 - p.b);
    if (lane == 0 && p.a >= 0) v[p.a] = global_row[p.a] = va;
    if (lane == 1 && p.b >= 0) v[p.b] = global_row[p.b] = vb;
  }
}

// a padded (load-0) station: log_rho clamped to NEG_INF
__device__ __forceinline__ bool padded(double lr) { return lr <= NEG_INF_D; }

__global__ void __launch_bounds__(MAX_THREADS)
    buzen_kernel(const double* __restrict__ log_rho,
                 const double* __restrict__ init, float* __restrict__ out,
                 int S, int m_pad) {
  // the row U2 (float64, log2 units); two (hi, lo) Y rows; two hi copies.
  // Buffers are picked by offsets from the shared base, so the compiler
  // keeps every read a shared-memory load
  extern __shared__ double dsmem[];
  double* u2 = dsmem;
  float2* y_base = reinterpret_cast<float2*>(dsmem + m_pad);
  float* yh_base = reinterpret_cast<float*>(dsmem + 3 * m_pad);
  const int b = blockIdx.x;
  const int lane = threadIdx.x % GROUP;
  const int groups = blockDim.x / GROUP;
  const int units = (m_pad + 1) / 2;
  const double* lrow = log_rho + (size_t)b * S;
  for (int m = threadIdx.x; m < m_pad; m += blockDim.x) {
    const double x = init[(size_t)b * m_pad + m] * LOG2E_D;
    u2[m] = x;
    if (S > 0) store_y(y_base, yh_base, m, x, lrow[0] * LOG2E_D);
  }
  __syncthreads();
  for (int s = 0; s < S; ++s) {
    const double lr = lrow[s];
    const double lr2 = lr * LOG2E_D;
    const bool has_next = s + 1 < S;
    const double lr2_next = has_next ? lrow[s + 1] * LOG2E_D : 0.0;
    const int cur = s & 1;
    const float2* y = y_base + cur * m_pad;
    const float* yh = yh_base + cur * m_pad;
    float2* y_next = y_base + (cur ^ 1) * m_pad;
    float* yh_next = yh_base + (cur ^ 1) * m_pad;
    if (!padded(lr)) {
      for (int r = 0; r * groups < units; ++r) {
        const int unit = threadIdx.x / GROUP + r * groups;
        const Pair p(unit, units, m_pad, unit + 1, lane);
        const float ra = group_max_f(row_max_y(yh, p.a, lane));
        const float rb = group_max_f(row_max_y(yh, p.b, p.first_b));
        const float sa = group_sum(row_sum_y(y, p.a, lane, ra));
        const float sb = group_sum(row_sum_y(y, p.b, p.first_b, rb));
        const int m = lane == 0 ? p.a : p.b;
        if (lane < 2 && m >= 0) {
          const double v = finish_row_ex2(
              fma((double)m, lr2, (double)(lane == 0 ? ra : rb)),
              lane == 0 ? sa : sb, m_pad - 1 - m);
          u2[m] = v;
          if (has_next) store_y(y_next, yh_next, m, v, lr2_next);
        }
      }
    } else if (has_next) {  // the identity: Y of the next station from U2
      for (int m = threadIdx.x; m < m_pad; m += blockDim.x)
        store_y(y_next, yh_next, m, u2[m], lr2_next);
    }
    __syncthreads();
  }
  for (int m = threadIdx.x; m < m_pad; m += blockDim.x)
    out[(size_t)b * m_pad + m] = __double2float_rn(u2[m] * LN2_D);
}

// column k of the adjoint for m = k + q0, k + q0 + GROUP, ... < m_pad:
// adds sum g[m] P[m, k] to acc and sum (m - k) g[m] P[m, k] to lacc
__device__ __forceinline__ void column_terms(const double* ucur,
                                             const double* g, double up,
                                             double lr, int k, int q0,
                                             int m_pad, double& acc,
                                             double& lacc) {
  if (k < 0) return;
  double qd = (double)q0;
#pragma unroll 2
  for (int m = k + q0; m < m_pad; m += GROUP, qd += GROUP) {
    const double gp = g[m] * exp(fma(qd, lr, up) - ucur[m]);
    acc += gp;
    lacc = fma(qd, gp, lacc);
  }
}

__global__ void __launch_bounds__(BWD_THREADS)
    buzen_backward_kernel(const double* __restrict__ log_rho,
                          const double* __restrict__ init,
                          const double* __restrict__ g_in,
                          double* __restrict__ rows,
                          double* __restrict__ g_lr,
                          double* __restrict__ g_lg, int S, int m_pad) {
  extern __shared__ double dsmem[];
  double* ubuf = dsmem;  // U_s at ubuf + (s & 1) * m_pad
  double* gcur = dsmem + 2 * m_pad;
  double* gnext = dsmem + 3 * m_pad;
  double* partial = dsmem + 4 * m_pad;  // [2][32]: per warp, by parity
  const int b = blockIdx.x;
  const int lane = threadIdx.x % GROUP;
  const int warp = threadIdx.x / 32;
  const int groups = blockDim.x / GROUP;
  const int units = (m_pad + 1) / 2;
  const double* lrow = log_rho + (size_t)b * S;
  double* my_rows = rows + (size_t)b * (S + 1) * m_pad;

  // phase A: U_0..U_S, U_s in ubuf[s & 1] and in rows[b, s]
  for (int m = threadIdx.x; m < m_pad; m += blockDim.x) {
    const double x = init[(size_t)b * m_pad + m];
    ubuf[m] = x;
    my_rows[m] = x;
    gcur[m] = g_in[(size_t)b * m_pad + m];
  }
  __syncthreads();
  for (int s = 1; s <= S; ++s) {
    const double lr = lrow[s - 1];
    const double* u = ubuf + ((s - 1) & 1) * m_pad;
    double* v = ubuf + (s & 1) * m_pad;
    double* row = my_rows + (size_t)s * m_pad;
    if (isfinite(lr)) {
      fold_column_f64(u, v, row, lr, m_pad);
    } else {  // a padded station: the identity
      for (int m = threadIdx.x; m < m_pad; m += blockDim.x) {
        v[m] = u[m];
        row[m] = u[m];
      }
    }
    __syncthreads();
  }

  // phase B: stations S..1, U_s in ubuf[s & 1]
  for (int s = S; s >= 1; --s) {
    const double lr = lrow[s - 1];
    const bool live = isfinite(lr);
    const double* ucur = ubuf + (s & 1) * m_pad;
    const double* uprev = my_rows + (size_t)(s - 1) * m_pad;
    if (s > 1) {  // U_{s-1}, the next station's ucur, into the free buffer
      double* next = ubuf + ((s - 1) & 1) * m_pad;
      for (int m = threadIdx.x; m < m_pad; m += blockDim.x) next[m] = uprev[m];
    }
    double lacc = 0.0;
    if (live) {
      for (int r = 0; r * groups < units; ++r) {
        const int unit = threadIdx.x / GROUP + r * groups;
        // column a has m_pad - a terms, its partner a + 1
        const Pair p(unit, units, m_pad, m_pad - unit, lane);
        double acc_a = 0.0, acc_b = 0.0;
        column_terms(ucur, gcur, p.a >= 0 ? uprev[p.a] : 0.0, lr, p.a, lane,
                     m_pad, acc_a, lacc);
        column_terms(ucur, gcur, p.b >= 0 ? uprev[p.b] : 0.0, lr, p.b,
                     p.first_b, m_pad, acc_b, lacc);
        acc_a = group_sum(acc_a);
        acc_b = group_sum(acc_b);
        if (lane == 0 && p.a >= 0) gnext[p.a] = acc_a;
        if (lane == 1 && p.b >= 0) gnext[p.b] = acc_b;
      }
    } else {  // a padded station: g passes through
      for (int m = threadIdx.x; m < m_pad; m += blockDim.x) gnext[m] = gcur[m];
    }
    for (int o = 16; o > 0; o >>= 1)
      lacc += __shfl_xor_sync(0xffffffffu, lacc, o);
    if (threadIdx.x % 32 == 0) partial[(s & 1) * 32 + warp] = lacc;
    __syncthreads();
    if (threadIdx.x == 0) {  // the warps' partials in a fixed order
      double t = 0.0;
      for (int w = 0; w < (int)(blockDim.x / 32); ++w)
        t += partial[(s & 1) * 32 + w];
      g_lr[(size_t)b * S + s - 1] = live ? t : 0.0;
    }
    double* tmp = gcur;
    gcur = gnext;
    gnext = tmp;
  }
  // d/d log_gamma_total = sum_k k g_0[k] (k = 0 is pinned in the Poisson
  // row), summed here in a fixed order so that a row's partials never
  // depend on the batch around it
  double acc = 0.0;
  for (int m = threadIdx.x; m < m_pad; m += blockDim.x) acc += m * gcur[m];
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (threadIdx.x % 32 == 0) partial[warp] = acc;  // slot 0: free by now
  __syncthreads();
  if (threadIdx.x == 0) {
    double t = 0.0;
    for (int w = 0; w < (int)(blockDim.x / 32); ++w) t += partial[w];
    g_lg[b] = t;
  }
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

// a group per pair of rows, as many groups as pairs up to max_threads, in
// whole warps
static int pair_threads(int m_pad, int max_threads) {
  const int units = (m_pad + 1) / 2;
  const int groups =
      units < max_threads / GROUP ? units : max_threads / GROUP;
  return ((groups * GROUP + 31) / 32) * 32;
}

// above 48 KB a block's shared memory must be asked for
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

extern "C" int buzen_forward(const double* log_rho, const double* init,
                             float* out, int B, int S, int m_pad,
                             cudaStream_t stream) {
  // the float64 row, two (hi, lo) Y rows and two hi copies
  const size_t smem = 4 * (size_t)m_pad * sizeof(double);
  cudaError_t err = allow_smem(buzen_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0)
    buzen_kernel<<<B, pair_threads(m_pad, MAX_THREADS), smem, stream>>>(
        log_rho, init, out, S, m_pad);
  return (int)cudaGetLastError();
}

extern "C" int buzen_backward(const double* log_rho, const double* init,
                              const double* g, double* rows, double* g_lr,
                              double* g_lg, int B, int S, int m_pad,
                              cudaStream_t stream) {
  const size_t smem = (4 * (size_t)m_pad + 64) * sizeof(double);
  cudaError_t err = allow_smem(buzen_backward_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0)
    buzen_backward_kernel<<<B, pair_threads(m_pad, BWD_THREADS), smem,
                            stream>>>(
        log_rho, init, g, rows, g_lr, g_lg, S, m_pad);
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
