// Buzen's log-space DP for a batch of closed networks, hand-written for
// Hopper (sm_90a).  Four kernels:
//
//   buzen_kernel                  replaces repro/kernels/buzen.py::
//                                 buzen_pallas_batched (body _buzen_kernel):
//                                 S single-server stations, the geometric
//                                 series k * log_rho[b, s];
//   buzen_backward_kernel<false>  replaces no Pallas kernel: it replaces the
//                                 float64 VJP of repro/kernels/buzen.py::
//                                 _buzen_log_Z_bwd (jax.vjp of
//                                 _reference_log_Z), which the port ran as
//                                 PyTorch autograd over the float64 DP at
//                                 every Adam step of the sweep;
//   buzen_classes_kernel          replaces repro/kernels/buzen.py::
//                                 buzen_classes_pallas_batched (body
//                                 _buzen_classes_kernel): S client classes,
//                                 each a negative-binomial series, built
//                                 here in float64;
//   buzen_backward_kernel<true>   replaces no Pallas kernel: it replaces the
//                                 float64 VJP of repro/kernels/buzen.py::
//                                 _buzen_classes_log_Z_bwd (jax.vjp of
//                                 _reference_class_log_Z), which the port
//                                 ran as autograd over the float64 class DP
//                                 at every Adam step of the class sweep.
//
// For each batch row b the running log-constant row U[0..m_max] starts from
// the aggregated infinite-server Poisson row (m lg - lgamma(m + 1), lg =
// log_gamma_total[b]) and folds the S columns in order:
//
//     U'[m] = logsumexp_{k <= m} (term_s(k) + U[m - k])
//
// with masked terms (k > m) entering as NEG_INF, as the TPU kernels'
// (m_pad x m_pad) masked reductions do: they take part in the max and add
// exp(NEG_INF - max) each to the sum.  term_s is the column's series: k
// lr_s for a station, a class's negative-binomial series (below).
//
// Every kernel runs one CTA per batch row; the column loop runs inside the
// block (the TPU's sequential grid axis), the running row double-buffered
// in shared memory.  The (m+1)(m+2)/2 terms of a column are spread evenly
// over the CTA: a group of GROUP lanes takes rows m and m_pad - 1 - m
// together (m+1 and m_pad - m terms: m_pad + 1 for every pair), its lanes
// over k, and reduces both rows by shuffles.
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
//   * a group reduces its two rows by shuffles: one pass for the max of Yh,
//     one for the sum.  A warp's four groups take consecutive pairs, so
//     their reads of Y overlap (broadcast) and their loops run the same
//     length;
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
// buzen_classes_kernel (the class forward).  A class of count c identical
// stations of per-member log-load lr folds as one column whose series is
//
//     w[k] = ((k lr + lgamma(k + c)) - lgamma(k + 1)) - lgamma(c)
//
// (k = 0 pinned to 0, clamped below at NEG_INF).  Everything is built in
// the kernel, in float64, from log_rho [B, S], counts [B, S] and
// log_gamma_total [B], into shared memory: lgamma(k + 1) (the Poisson row
// and every series use it) and the series of as many columns as fit beside
// the rows (all of them at the sweep's shape), with the card's double
// lgamma, in _class_series's order with intrinsics that are never
// contracted into FMAs.  A double lgamma is a called routine with a long
// latency: one pass spread over the whole block makes every lgamma of a
// chunk of columns at once (the block takes enough threads for one round),
// where building each column just before its fold paid two such latencies
// a column.  At c = 4e5 (Table 1 at n = 1e6) lgamma(k + c) -
// lgamma(c) cancels two terms of about 4.7e6: in float64 that leaves about
// 1e-9 of absolute error, where the TPU kernel's float32 build loses about
// 0.1 in log Z.  The fold is the forward's pair layout with a float64 term
// w2[k] + U2[m - k] (log2 units; this series is not geometric, so kernel
// 1's Y split does not apply): the row's max in float64, the shifted
// exponent rounded to float32 into ex2.approx, the sum in float32, the row
// max + log2(sum) in float64, rounded to float32 only at the output.  A
// column whose count is not positive or whose log_rho is not finite above
// NEG_INF (a padded class) is skipped, as in the forward above, by the
// whole CTA alike (every thread reads the same two values); the TPU
// kernel's arithmetic gives it exactly U.  Bound by operations: B * S *
// (m+1)(m+2)/2 terms, 5 float32 operations each counted in the bound (add,
// max, subtract, exp, sum); the kernel does its adds and subtracts in
// float64 and converts each exponent (F2F), and at one CTA a row (its 67
// row pairs on 67 groups of 8 lanes at the sweep's shape) each column's
// fold is latency-bound.  A padded column costs nothing.
//
// buzen_backward_kernel<CLASSES> (the float64 adjoint).  With U_0 the
// Poisson row, U_s[m] = logsumexp_{k <= m} (U_{s-1}[k] + w_s[m - k]) and
// g_S = g, where w_s[q] = q lr_s for a station and the class series for a
// class (d w_s[q] / d lr_s = q for both):
//
//     P_s[m, k]  = exp(U_{s-1}[k] + w_s[m - k] - U_s[m])   (k <= m, <= 1)
//     g_{s-1}[k] = sum_{m >= k} g_s[m] P_s[m, k]
//     d/d lr_s   = sum_m sum_{k <= m} g_s[m] (m - k) P_s[m, k]
//     d/d lg     = sum_k k g_0[k]      (k = 0 is pinned in the Poisson row)
//
// Phase A recomputes U_1..U_S in float64 (exp and log in float64) into a
// [B, S+1, m_pad] scratch that stays in L2; phase B walks the columns
// back, a group of lanes per column pair (k, m_pad - 1 - k), its lanes over
// m, d/d lr_s reduced over the block once per column, in a fixed order (a
// row's partials never depend on the batch around it).  The two phases and
// the fold are templates on the term (Geometric, Series); a class's series
// is built into shared memory by the forward's routines (natural units), a
// chunk of columns at a time, in both phases.  Every exponent is <= 0: P
// is never factored into exp(U_{s-1}[k] - k lr) exp(m lr - U_s[m]), whose
// factors overflow float64 at |k lr| ~ 900.  A padded column (a
// non-finite lr_s; for a class also a count that is not positive) is an
// explicit identity (rows and g pass through, its partial is 0), so the
// real columns' partials equal the unpadded run's bitwise; counts take no
// gradient.  Bound by
// operations: 2 * B * S * (m+1)(m+2)/2 float64 terms (one phase each), each
// an exp; a float64 exp is a software routine of some twenty float64
// instructions on this card, so the kernel runs far from a bound that
// counts it as one operation.
#include <cuda_runtime.h>
#include <math.h>

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

// A column's term, the series at q (k in the fold, m - k in the adjoint)
// plus a row value u: q lr (one mul-add) for a per-client station, the
// series in shared memory for a class.
struct Geometric {
  double lr;
  __device__ __forceinline__ double at(int, double qd, double u) const {
    return fma(qd, lr, u);
  }
};

struct Series {
  const double* w;
  __device__ __forceinline__ double at(int q, double, double u) const {
    return w[q] + u;
  }
};

// row m's terms at(k, u[m - k]) for k = k0, k0 + GROUP, ... <= m: their
// max, and the sum of their exponentials shifted by mx
template <typename Term>
__device__ __forceinline__ double row_max(const Term& t, const double* u,
                                          int m, int k0) {
  double mx = -INFINITY;
  double kd = (double)k0;
  int k = k0;
#pragma unroll 4
  for (int j = m - k0; j >= 0; j -= GROUP, k += GROUP, kd += GROUP)
    mx = fmax(mx, t.at(k, kd, u[j]));
  return mx;
}

// float64 exp (natural units)
template <typename Term>
__device__ __forceinline__ double row_sum_exp(const Term& t, const double* u,
                                              int m, int k0, double mx) {
  double s = 0.0;
  double kd = (double)k0;
  int k = k0;
#pragma unroll 4
  for (int j = m - k0; j >= 0; j -= GROUP, k += GROUP, kd += GROUP)
    s += exp(t.at(k, kd, u[j]) - mx);
  return s;
}

// float32 ex2 of the float64 shifted exponent rounded to float32 (log2
// units)
template <typename Term>
__device__ __forceinline__ float row_sum_ex2(const Term& t, const double* u,
                                             int m, int k0, double mx) {
  float s = 0.0f;
  double kd = (double)k0;
  int k = k0;
#pragma unroll 4
  for (int j = m - k0; j >= 0; j -= GROUP, k += GROUP, kd += GROUP)
    s += ex2(__double2float_rn(t.at(k, kd, u[j]) - mx));
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

// One column of a DP over the CTA: v[m] = logsumexp_k t.at(k, u[m - k]) for
// every m, the rows in pairs over the groups.  F64: float64 exp in natural
// units, each row also written to global_row (the backward's phase A);
// otherwise the float32 ex2 of float64 exponents in log2 units (the class
// forward).  Every thread of the block must call it (the groups shuffle).
template <bool F64, typename Term>
__device__ __forceinline__ void fold_column(const Term& t, const double* u,
                                            double* v, double* global_row,
                                            int m_pad) {
  const int lane = threadIdx.x % GROUP;
  const int groups = blockDim.x / GROUP;
  const int units = (m_pad + 1) / 2;
  for (int r = 0; r * groups < units; ++r) {
    const int unit = threadIdx.x / GROUP + r * groups;
    const Pair p(unit, units, m_pad, unit + 1, lane);
    const double ma = group_max(row_max(t, u, p.a, lane));
    const double mb = group_max(row_max(t, u, p.b, p.first_b));
    double va, vb;
    if constexpr (F64) {
      va = finish_row_exp(ma, group_sum(row_sum_exp(t, u, p.a, lane, ma)),
                          m_pad - 1 - p.a);
      vb = finish_row_exp(
          mb, group_sum(row_sum_exp(t, u, p.b, p.first_b, mb)),
          m_pad - 1 - p.b);
    } else {
      va = finish_row_ex2(ma, group_sum(row_sum_ex2(t, u, p.a, lane, ma)),
                          m_pad - 1 - p.a);
      vb = finish_row_ex2(
          mb, group_sum(row_sum_ex2(t, u, p.b, p.first_b, mb)),
          m_pad - 1 - p.b);
    }
    if (lane == 0 && p.a >= 0) {
      v[p.a] = va;
      if constexpr (F64) global_row[p.a] = va;
    }
    if (lane == 1 && p.b >= 0) {
      v[p.b] = vb;
      if constexpr (F64) global_row[p.b] = vb;
    }
  }
}

// a padded (load-0) station: log_rho clamped to NEG_INF
__device__ __forceinline__ bool padded(double lr) { return lr <= NEG_INF_D; }

// a padded class: a count that is not positive, or a log_rho that is not
// finite above NEG_INF; every thread reads the same two values, so the
// whole CTA decides alike
__device__ __forceinline__ bool class_live(double lr, double cnt) {
  return cnt > 0.0 && lr > NEG_INF_D && lr < INFINITY;
}

// the Poisson row U_0[m] = m lg - lgamma(m + 1), m = 0 pinned to 0, as
// _poisson_series forms it (lgm1 = lgamma(m + 1))
__device__ __forceinline__ double poisson(int m, double lg, double lgm1) {
  return m == 0 ? 0.0 : __dsub_rn(__dmul_rn((double)m, lg), lgm1);
}

// The series of class columns s0 .. s0 + n - 1 into ws[i * m_pad + k], i
// < n, as _class_series forms them: ((k lr + lgamma(k + cnt)) - lgamma(k +
// 1)) - lgamma(cnt), clamped below at NEG_INF, k = 0 pinned to 0, times
// scale (1 for natural units, log2 e for log2 units); a padded column's
// slots are left as they are.  Two passes, each spread over the whole
// block, a barrier between them that the caller places: lgamma_pass makes
// every double lgamma the chunk needs (lgamma(k + cnt) into ws,
// lgamma(cnt) into lgc[i], and with lgk1_too lgamma(k + 1) into lgk1) at
// once, so its latency is paid about once for the chunk and not twice a
// column; series_pass combines them.  The _rn intrinsics are never
// contracted into FMAs, so each step rounds as PyTorch's operations do.
__device__ __forceinline__ void lgamma_pass(double* ws, double* lgc,
                                            double* lgk1, bool lgk1_too,
                                            const double* lrow,
                                            const double* crow, int s0,
                                            int n, int m_pad) {
  const int first = lgk1_too ? m_pad : 0;
  const int total = first + n * (m_pad + 1);
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    if (i < first) {
      lgk1[i] = lgamma((double)i + 1.0);
      continue;
    }
    const int c = (i - first) / (m_pad + 1);
    const int k = (i - first) % (m_pad + 1);
    const double cnt = crow[s0 + c];
    if (!class_live(lrow[s0 + c], cnt)) continue;
    if (k < m_pad)
      ws[(size_t)c * m_pad + k] = lgamma((double)k + cnt);
    else
      lgc[c] = lgamma(cnt);
  }
}

__device__ __forceinline__ void series_pass(double* ws, const double* lgc,
                                            const double* lgk1,
                                            const double* lrow,
                                            const double* crow, int s0,
                                            int n, double scale, int m_pad) {
  for (int i = threadIdx.x; i < n * m_pad; i += blockDim.x) {
    const int c = i / m_pad;
    const int k = i % m_pad;
    const double lr = lrow[s0 + c];
    if (!class_live(lr, crow[s0 + c])) continue;
    const double t = __dsub_rn(
        __dsub_rn(__dadd_rn(__dmul_rn((double)k, lr), ws[i]), lgk1[k]),
        lgc[c]);
    ws[i] = k == 0 ? 0.0 : __dmul_rn(fmax(t, NEG_INF_D), scale);
  }
}

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

__global__ void __launch_bounds__(MAX_THREADS)
    buzen_classes_kernel(const double* __restrict__ log_rho,
                         const double* __restrict__ counts,
                         const double* __restrict__ log_gamma_total,
                         float* __restrict__ out, int S, int m_pad,
                         int chunk) {
  // the row U2 (float64, log2 units) at dsmem + cur * m_pad, cur = 0, 1;
  // lgamma(k + 1); the series of a chunk of columns (log2 units) and
  // their lgamma(count)
  extern __shared__ double dsmem[];
  double* lgk1 = dsmem + 2 * m_pad;
  double* ws = dsmem + 3 * m_pad;
  double* lgc = ws + (size_t)chunk * m_pad;
  const int b = blockIdx.x;
  const double* lrow = log_rho + (size_t)b * S;
  const double* crow = counts + (size_t)b * S;
  const double lg = log_gamma_total[b];
  int cur = 0;
  for (int s0 = 0; s0 < S || s0 == 0; s0 += chunk) {
    const int n = S - s0 < chunk ? S - s0 : chunk;
    // the last fold's reads of ws are done
    __syncthreads();
    lgamma_pass(ws, lgc, lgk1, s0 == 0, lrow, crow, s0, n, m_pad);
    __syncthreads();
    if (s0 == 0)
      for (int m = threadIdx.x; m < m_pad; m += blockDim.x)
        dsmem[m] = poisson(m, lg, lgk1[m]) * LOG2E_D;
    series_pass(ws, lgc, lgk1, lrow, crow, s0, n, LOG2E_D, m_pad);
    for (int c = 0; c < n; ++c) {
      // a padded class is the identity: U2 unchanged
      if (!class_live(lrow[s0 + c], crow[s0 + c])) continue;
      __syncthreads();
      fold_column<false>(Series{ws + (size_t)c * m_pad}, dsmem + cur * m_pad,
                         dsmem + (cur ^ 1) * m_pad, nullptr, m_pad);
      cur ^= 1;
    }
  }
  __syncthreads();
  for (int m = threadIdx.x; m < m_pad; m += blockDim.x)
    out[(size_t)b * m_pad + m] =
        __double2float_rn(dsmem[cur * m_pad + m] * LN2_D);
}

// column k of the adjoint for m = k + q0, k + q0 + GROUP, ... < m_pad:
// adds sum g[m] P[m, k] to acc and sum (m - k) g[m] P[m, k] to lacc
template <typename Term>
__device__ __forceinline__ void column_terms(const Term& t,
                                             const double* ucur,
                                             const double* g, double up,
                                             int k, int q0, int m_pad,
                                             double& acc, double& lacc) {
  if (k < 0) return;
  double qd = (double)q0;
  int q = q0;
#pragma unroll 2
  for (int m = k + q0; m < m_pad; m += GROUP, q += GROUP, qd += GROUP) {
    const double gp = g[m] * exp(t.at(q, qd, up) - ucur[m]);
    acc += gp;
    lacc = fma(qd, gp, lacc);
  }
}

// one column of phase B: gnext[k] = sum_m g[m] P[m, k] for every k, the
// columns in pairs over the groups; returns this thread's share of d/d lr
template <typename Term>
__device__ __forceinline__ double adjoint_column(const Term& t,
                                                 const double* ucur,
                                                 const double* uprev,
                                                 const double* g,
                                                 double* gnext, int m_pad) {
  const int lane = threadIdx.x % GROUP;
  const int groups = blockDim.x / GROUP;
  const int units = (m_pad + 1) / 2;
  double lacc = 0.0;
  for (int r = 0; r * groups < units; ++r) {
    const int unit = threadIdx.x / GROUP + r * groups;
    // column a has m_pad - a terms, its partner a + 1
    const Pair p(unit, units, m_pad, m_pad - unit, lane);
    double acc_a = 0.0, acc_b = 0.0;
    column_terms(t, ucur, g, p.a >= 0 ? uprev[p.a] : 0.0, p.a, lane, m_pad,
                 acc_a, lacc);
    column_terms(t, ucur, g, p.b >= 0 ? uprev[p.b] : 0.0, p.b, p.first_b,
                 m_pad, acc_b, lacc);
    acc_a = group_sum(acc_a);
    acc_b = group_sum(acc_b);
    if (lane == 0 && p.a >= 0) gnext[p.a] = acc_a;
    if (lane == 1 && p.b >= 0) gnext[p.b] = acc_b;
  }
  return lacc;
}

// Call fn(term) with column s's term and return true, or return false for
// a padded column; w is a class column's series (natural units).
template <bool CLASSES, typename Fn>
__device__ __forceinline__ bool with_column(const double* lrow,
                                            const double* crow, int s,
                                            const double* w, Fn fn) {
  const double lr = lrow[s];
  if constexpr (CLASSES) {
    if (!class_live(lr, crow[s])) return false;
    fn(Series{w});
  } else {
    if (!isfinite(lr)) return false;
    fn(Geometric{lr});
  }
  return true;
}

// Classes: the series of columns s0 .. s0 + n - 1 into ws (natural units),
// after a barrier that covers the last column's reads of ws, and a barrier
// after.  Every thread of the block must call it.
template <bool CLASSES>
__device__ __forceinline__ void build_chunk(double* ws, double* lgc,
                                            const double* lgk1,
                                            const double* lrow,
                                            const double* crow, int s0,
                                            int n, int m_pad) {
  if constexpr (CLASSES) {
    __syncthreads();
    lgamma_pass(ws, lgc, nullptr, false, lrow, crow, s0, n, m_pad);
    __syncthreads();
    series_pass(ws, lgc, lgk1, lrow, crow, s0, n, 1.0, m_pad);
    __syncthreads();
  }
}

template <bool CLASSES>
__global__ void __launch_bounds__(BWD_THREADS)
    buzen_backward_kernel(const double* __restrict__ log_rho,
                          const double* __restrict__ counts,
                          const double* __restrict__ log_gamma_total,
                          const double* __restrict__ g_in,
                          double* __restrict__ rows,
                          double* __restrict__ g_lr,
                          double* __restrict__ g_lg, int S, int m_pad,
                          int chunk) {
  extern __shared__ double dsmem[];
  double* ubuf = dsmem;  // U_s at ubuf + (s & 1) * m_pad
  double* gcur = dsmem + 2 * m_pad;
  double* gnext = dsmem + 3 * m_pad;
  double* partial = dsmem + 4 * m_pad;  // [2][32]: per warp, by parity
  double* lgk1 = partial + 64;          // classes: lgamma(k + 1)
  double* ws = lgk1 + m_pad;            // classes: a chunk's series
  double* lgc = ws + (size_t)chunk * m_pad;  // and their lgamma(count)
  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const double* lrow = log_rho + (size_t)b * S;
  const double* crow = CLASSES ? counts + (size_t)b * S : nullptr;
  const double lg = log_gamma_total[b];
  double* my_rows = rows + (size_t)b * (S + 1) * m_pad;

  // phase A: U_0..U_S, U_s in ubuf[s & 1] and in rows[b, s]
  for (int m = threadIdx.x; m < m_pad; m += blockDim.x) {
    const double l = lgamma((double)m + 1.0);
    if constexpr (CLASSES) lgk1[m] = l;
    const double x = poisson(m, lg, l);
    ubuf[m] = x;
    my_rows[m] = x;
    gcur[m] = g_in[(size_t)b * m_pad + m];
  }
  __syncthreads();
  for (int s0 = 0; s0 < S; s0 += chunk) {
    const int n = S - s0 < chunk ? S - s0 : chunk;
    build_chunk<CLASSES>(ws, lgc, lgk1, lrow, crow, s0, n, m_pad);
    for (int s = s0 + 1; s <= s0 + n; ++s) {
      const double* u = ubuf + ((s - 1) & 1) * m_pad;
      double* v = ubuf + (s & 1) * m_pad;
      double* row = my_rows + (size_t)s * m_pad;
      const bool live = with_column<CLASSES>(
          lrow, crow, s - 1, ws + (size_t)(s - 1 - s0) * m_pad,
          [&](const auto& t) { fold_column<true>(t, u, v, row, m_pad); });
      if (!live) {  // a padded column: the identity
        for (int m = threadIdx.x; m < m_pad; m += blockDim.x) {
          v[m] = u[m];
          row[m] = u[m];
        }
      }
      __syncthreads();
    }
  }

  // phase B: columns S..1, U_s in ubuf[s & 1], the chunks in reverse
  for (int s1 = S; s1 > 0; s1 -= chunk) {
    const int s0 = s1 > chunk ? s1 - chunk : 0;
    build_chunk<CLASSES>(ws, lgc, lgk1, lrow, crow, s0, s1 - s0, m_pad);
    for (int s = s1; s > s0; --s) {
      const double* ucur = ubuf + (s & 1) * m_pad;
      const double* uprev = my_rows + (size_t)(s - 1) * m_pad;
      if (s > 1) {  // U_{s-1}, the next column's ucur, into the free buffer
        double* next = ubuf + ((s - 1) & 1) * m_pad;
        for (int m = threadIdx.x; m < m_pad; m += blockDim.x)
          next[m] = uprev[m];
      }
      double lacc = 0.0;
      const bool live = with_column<CLASSES>(
          lrow, crow, s - 1, ws + (size_t)(s - 1 - s0) * m_pad,
          [&](const auto& t) {
            lacc = adjoint_column(t, ucur, uprev, gcur, gnext, m_pad);
          });
      if (!live) {  // a padded column: g passes through
        for (int m = threadIdx.x; m < m_pad; m += blockDim.x)
          gnext[m] = gcur[m];
      }
      for (int o = 16; o > 0; o >>= 1)
        lacc += __shfl_xor_sync(0xffffffffu, lacc, o);
      if (threadIdx.x % 32 == 0) partial[(s & 1) * 32 + warp] = lacc;
      __syncthreads();
      if (threadIdx.x == 0) {  // the warps' partials in a fixed order
        double t = 0.0;
        for (int i = 0; i < (int)(blockDim.x / 32); ++i)
          t += partial[(s & 1) * 32 + i];
        g_lr[(size_t)b * S + s - 1] = live ? t : 0.0;
      }
      double* tmp = gcur;
      gcur = gnext;
      gnext = tmp;
    }
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
    for (int i = 0; i < (int)(blockDim.x / 32); ++i) t += partial[i];
    g_lg[b] = t;
  }
}

// a group per pair of rows, as many groups as pairs up to max_threads, in
// whole warps
static int pair_threads(int m_pad, int max_threads) {
  const int units = (m_pad + 1) / 2;
  const int groups =
      units < max_threads / GROUP ? units : max_threads / GROUP;
  return ((groups * GROUP + 31) / 32) * 32;
}

// the class kernels' threads: pair_threads, or more, up to max_threads, so
// that a chunk's lgamma calls (items of them) take one round
static int class_threads(int m_pad, int items, int max_threads) {
  const int pairs = pair_threads(m_pad, max_threads);
  const int want = items < max_threads ? ((items + 31) / 32) * 32
                                       : max_threads;
  return want > pairs ? want : pairs;
}

// the dynamic shared memory a block may ask for on sm_90 (H100 and H200:
// 227 KB), in doubles
constexpr size_t SMEM_DOUBLES = 232448 / sizeof(double);

// the class columns whose series fit beside `fixed` doubles of a kernel's
// other rows: at least 1, at most S
static int class_chunk(int S, int m_pad, size_t fixed) {
  const size_t fit = fixed < SMEM_DOUBLES
                         ? (SMEM_DOUBLES - fixed) / ((size_t)m_pad + 1)
                         : 0;
  const size_t want = S > 1 ? (size_t)S : 1;
  return (int)(fit < 1 ? 1 : fit < want ? fit : want);
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

template <bool CLASSES>
static int launch_backward(const double* log_rho, const double* counts,
                           const double* log_gamma_total, const double* g,
                           double* rows, double* g_lr, double* g_lg, int B,
                           int S, int m_pad, cudaStream_t stream) {
  // two rows, g twice, the warps' partials; a class's lgamma(k + 1), a
  // chunk of series and their lgamma(count)
  const size_t fixed = 4 * (size_t)m_pad + 64 + (CLASSES ? m_pad : 0);
  const int chunk = CLASSES ? class_chunk(S, m_pad, fixed) : (S > 1 ? S : 1);
  const size_t smem =
      (fixed + (CLASSES ? (size_t)chunk * (m_pad + 1) : 0)) * sizeof(double);
  const int threads =
      CLASSES ? class_threads(m_pad, chunk * (m_pad + 1), BWD_THREADS)
              : pair_threads(m_pad, BWD_THREADS);
  cudaError_t err = allow_smem(buzen_backward_kernel<CLASSES>, smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0)
    buzen_backward_kernel<CLASSES><<<B, threads, smem, stream>>>(
        log_rho, counts, log_gamma_total, g, rows, g_lr, g_lg, S, m_pad,
        chunk);
  return (int)cudaGetLastError();
}

extern "C" int buzen_backward(const double* log_rho,
                              const double* log_gamma_total, const double* g,
                              double* rows, double* g_lr, double* g_lg, int B,
                              int S, int m_pad, cudaStream_t stream) {
  return launch_backward<false>(log_rho, nullptr, log_gamma_total, g, rows,
                                g_lr, g_lg, B, S, m_pad, stream);
}

extern "C" int buzen_classes_forward(const double* log_rho,
                                     const double* counts,
                                     const double* log_gamma_total,
                                     float* out, int B, int S, int m_pad,
                                     cudaStream_t stream) {
  // the float64 row twice, lgamma(k + 1); a chunk of series and their
  // lgamma(count)
  const size_t fixed = 3 * (size_t)m_pad;
  const int chunk = class_chunk(S, m_pad, fixed);
  const size_t smem = (fixed + (size_t)chunk * (m_pad + 1)) * sizeof(double);
  // the first pass also makes lgamma(k + 1)
  const int threads =
      class_threads(m_pad, m_pad + chunk * (m_pad + 1), MAX_THREADS);
  cudaError_t err = allow_smem(buzen_classes_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0)
    buzen_classes_kernel<<<B, threads, smem, stream>>>(
        log_rho, counts, log_gamma_total, out, S, m_pad, chunk);
  return (int)cudaGetLastError();
}

extern "C" int buzen_classes_backward(const double* log_rho,
                                      const double* counts,
                                      const double* log_gamma_total,
                                      const double* g, double* rows,
                                      double* g_lr, double* g_lg, int B,
                                      int S, int m_pad, cudaStream_t stream) {
  return launch_backward<true>(log_rho, counts, log_gamma_total, g, rows,
                               g_lr, g_lg, B, S, m_pad, stream);
}
