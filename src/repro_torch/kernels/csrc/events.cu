// The closed-network event engine, hand-written for Hopper (sm_90a).
//
// One kernel, lanes_kernel (at the end of this file), retires up to `chunk`
// events per lane in one launch, all through one per-event body,
// one_event().  Two instantiations:
//
//   * the table transition alone, the contract of the TPU kernels: one
//     event per lane (the entry point event_step) and up to `chunk` events
//     per lane (megastep);
//   * the main path's lane steps (the entry point lanes): the same
//     transitions together with everything the statistics replay
//     (repro_torch.core.events.replay_event) does for each kept event, on
//     the lane's whole EventState, so that one launch retires its events
//     and no PyTorch operation runs per event.
//
// Replaces the Pallas TPU kernels repro/kernels/events.py::event_step_tables
// (body _event_kernel / _one_event) and ::megastep_tables
// (_megastep_kernel); the lane steps also take over the jnp statistics
// that XLA fused around them (_lane_stats, the scan in
// megastep_event_pallas).  Each lane holds a task table of m_max slots:
// finish (f64, +inf when not in service), phase, client, seq and dispatch
// round (int32).  One event:
//
//   1. j = first index of min(finish): the completing slot (t_new its clock);
//   2. the fused phase promotion / routing of slot j (an update re-dispatches
//      slot j to the routed client c_new);
//   3. FIFO promotion at client c's compute station: the waiting slot of c
//      with the smallest seq (lowest index on ties) enters service if the
//      server is idle;
//   4. with a CS station, the same FIFO promotion at the CS.
//
// Ties go to the lowest index, the rule of the TPU kernel's
// _first_index_min; the deterministic law makes equal clocks common, so this
// rule decides trajectories.  The uplink and computation services arrive as
// the timing law's rate-free parts (per event [x_up, x_comp, svc_down,
// svc_cs], and for the H2 form the branch factors [f_up, f_comp] after
// them) and the completing client's rate is applied here, in the law's form
// (repro_torch.scenario.laws.apply_rate), a template parameter:
//
//   * LAW_SCALE (exponential, deterministic; the TPU kernels' contract):
//     x / mu[c], x the variate at unit rate;
//   * LAW_H2 (hyperexponential): x / (f * mu[c]);
//   * LAW_LOGNORMAL: exp((x - log(mu[c])) - 0.5), x a standard normal, with
//     CUDA's double exp and log, the functions PyTorch's CUDA exp and log
//     call.
//
// Build with -fmad=false and IEEE division: the f64 results are then
// bitwise those of the plain PyTorch versions; the energy integral's three
// fused multiply-adds are explicit fma() calls, which Hopper's DFMA rounds
// once, as the plain version's emulation (repro_torch.core.numerics.fma)
// does.
//
// Layout of the transition: one warp per lane (the TPU's grid axis); slots
// are strided over the warp, and the argmin and both FIFO picks are warp
// reductions on (value, index) pairs.  The lane's rows are loaded into
// shared memory once, its events retired there, each event's time and
// descriptors written as it goes and the rows written back once at the end;
// `chunk` is a runtime argument, so the event loop is not unrolled.  At the
// main path's sizes (a few lanes of 132 slots) the launch, not the bytes,
// sets the time.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#define DOWN 0
#define COMP_WAIT 1
#define COMP_SERV 2
#define UP 3
#define CS_WAIT 4
#define CS_SERV 5

#define FULL 0xffffffffu

// the rate forms of the timing laws (repro_torch.scenario.laws.FORMS)
#define LAW_SCALE 0
#define LAW_H2 1
#define LAW_LOGNORMAL 2

// per-event scalars of a form: [x_up, x_comp, svc_down, svc_cs] and, for
// H2, [f_up, f_comp]
__host__ __device__ constexpr int law_width(int law) {
  return law == LAW_H2 ? 6 : 4;
}

// the completing client's rate applied to a rate-free part
template <int LAW>
__device__ __forceinline__ double apply_rate(double x, double f,
                                             double rate) {
  if (LAW == LAW_H2) return x / (f * rate);
  if (LAW == LAW_LOGNORMAL) return exp((x - log(rate)) - 0.5);
  return x / rate;
}

// (value, index) pair min with ties to the lowest index
__device__ __forceinline__ void min_pair_f64(double& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const double ov = __shfl_xor_sync(FULL, v, off);
    const int oi = __shfl_xor_sync(FULL, i, off);
    if (ov < v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

__device__ __forceinline__ void min_pair_i32(int& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const int ov = __shfl_xor_sync(FULL, v, off);
    const int oi = __shfl_xor_sync(FULL, i, off);
    if (ov < v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

// One event's outside-drawn scalars and counters (f_up and f_comp only
// for the H2 form).
struct EventIn {
  double x_up, x_comp, svc_down, svc_cs, f_up, f_comp;
  int c_new, seq_ctr, rnd;
};

// The transition's descriptors, the same in every thread of the warp.
struct EventDesc {
  double t_new;
  int j, c, is_update, delay, new_seq_ctr, new_round, ph, do_comp, do_cs;
};

// One event on one lane's rows, run by the whole warp.  Reads the rows
// fin..dis; when `write`, writes the new rows to o_fin..o_dis, which may be
// the same rows (the lane's shared memory): every read of another
// thread's slot comes before the first __syncwarp() below, and each thread
// then writes only its own slots.  mu_c/mu_u are the lane's rate rows, LAW
// the timing law's rate form.
template <int LAW>
__device__ EventDesc one_event(const double* fin, const int* pha,
                               const int* cli, const int* sq, const int* dis,
                               double* o_fin, int* o_pha, int* o_cli,
                               int* o_sq, int* o_dis, bool write,
                               const double* mu_c, const double* mu_u,
                               int m_max, int n, bool has_cs,
                               const EventIn& in) {
  const int lane = threadIdx.x;

  // -- 1. the completing slot: first-index argmin over the clocks ----------
  double t_new = INFINITY;
  int j = INT_MAX;
  for (int i = lane; i < m_max; i += 32) {
    const double v = fin[i];
    if (v < t_new || (v == t_new && i < j)) {
      t_new = v;
      j = i;
    }
  }
  min_pair_f64(t_new, j);

  const int c = cli[j];
  const int ph = pha[j];
  const int delay = in.rnd - dis[j];
  const bool is_down = ph == DOWN;
  const bool is_comp = ph == COMP_SERV;
  const bool is_up = ph == UP;
  const bool is_cs = ph == CS_SERV;
  const bool is_update = has_cs ? is_cs : is_up;
  const int new_round = in.rnd + (is_update ? 1 : 0);

  // rate gathers (a client outside [0, n) reads 0, as the TPU kernel's
  // one-hot gather does)
  const bool c_ok = c >= 0 && c < n;
  const double rate_u = c_ok ? mu_u[c] : 0.0;
  const double rate_c = c_ok ? mu_c[c] : 0.0;
  const double svc_up = apply_rate<LAW>(in.x_up, in.f_up, rate_u);
  const double svc_c = apply_rate<LAW>(in.x_comp, in.f_comp, rate_c);

  // -- 2. phase promotion / routing of slot j -------------------------------
  const int phase_j = is_down ? COMP_WAIT
                              : (is_comp ? UP : (is_update ? DOWN : CS_WAIT));
  const double finish_j =
      is_comp ? t_new + svc_up : (is_update ? t_new + in.svc_down : INFINITY);
  const bool joins_fifo = is_down || (is_up && has_cs);
  const int seq_j = joins_fifo ? in.seq_ctr : sq[j];
  const int new_seq_ctr = in.seq_ctr + (joins_fifo ? 1 : 0);
  const int client_j = is_update ? in.c_new : c;
  const int disp_j = is_update ? new_round : dis[j];

  // -- 3./4. FIFO picks on the post-transition table -------------------------
  bool serving_c = false, cs_busy = false;
  int w_seq = INT_MAX, w_idx = INT_MAX;   // compute FIFO of client c
  int cs_seq = INT_MAX, cs_idx = INT_MAX; // CS FIFO
  for (int i = lane; i < m_max; i += 32) {
    const int p_i = i == j ? phase_j : pha[i];
    const int c_i = i == j ? client_j : cli[i];
    const int s_i = i == j ? seq_j : sq[i];
    if (p_i == COMP_SERV && c_i == c) serving_c = true;
    if (p_i == COMP_WAIT && c_i == c &&
        (s_i < w_seq || (s_i == w_seq && i < w_idx))) {
      w_seq = s_i;
      w_idx = i;
    }
    if (p_i == CS_SERV) cs_busy = true;
    if (p_i == CS_WAIT && (s_i < cs_seq || (s_i == cs_seq && i < cs_idx))) {
      cs_seq = s_i;
      cs_idx = i;
    }
  }
  serving_c = __any_sync(FULL, serving_c);
  cs_busy = __any_sync(FULL, cs_busy);
  min_pair_i32(w_seq, w_idx);
  min_pair_i32(cs_seq, cs_idx);
  const bool do_comp = (is_down || is_comp) && !serving_c && w_idx != INT_MAX;
  const bool do_cs = has_cs && (is_up || is_cs) && !cs_busy &&
                     cs_idx != INT_MAX;

  if (write) {
    __syncwarp();
    for (int i = lane; i < m_max; i += 32) {
      int p_i = i == j ? phase_j : pha[i];
      double f_i = i == j ? finish_j : fin[i];
      if (do_comp && i == w_idx) {
        p_i = COMP_SERV;
        f_i = t_new + svc_c;
      }
      if (do_cs && i == cs_idx) {
        p_i = CS_SERV;
        f_i = t_new + in.svc_cs;
      }
      const int c_i = i == j ? client_j : cli[i];
      const int s_i = i == j ? seq_j : sq[i];
      const int d_i = i == j ? disp_j : dis[i];
      o_pha[i] = p_i;
      o_fin[i] = f_i;
      o_cli[i] = c_i;
      o_sq[i] = s_i;
      o_dis[i] = d_i;
    }
    __syncwarp();
  }

  EventDesc d;
  d.t_new = t_new;
  d.j = j;
  d.c = c;
  d.is_update = is_update ? 1 : 0;
  d.delay = delay;
  d.new_seq_ctr = new_seq_ctr;
  d.new_round = new_round;
  d.ph = ph;
  d.do_comp = do_comp ? 1 : 0;
  d.do_cs = do_cs ? 1 : 0;
  return d;
}

__device__ __forceinline__ void write_desc(int* d, const EventDesc& e) {
  d[0] = e.j;
  d[1] = e.c;
  d[2] = e.is_update;
  d[3] = e.delay;
  d[4] = e.new_seq_ctr;
  d[5] = e.new_round;
  d[6] = e.ph;
  d[7] = e.do_comp;
  d[8] = e.do_cs;
}


// ---------------------------------------------------------------------------
// The lane kernel: each kept event's transition, with or without its
// statistics
// ---------------------------------------------------------------------------
//
// lanes_kernel<SMEM, STATS, LAW>, one CTA per lane.  For each kept event, in
// order, warp 0 runs one_event() on the lane's task table, and with STATS
// the CTA then does replay_one, the statistics of
// repro_torch.core.events.replay_event (with _lane_stats), in its order
// and with its roundings:
//   - dt_eff from the state before the event; occ_int += dt_eff * occ over
//     the 3n + 1 stations (a multiply, then an add), all threads;
//   - with a power profile, p_w: the per-client terms
//     fma(P_d, occ_d, fma(P_u, occ_u, P_c * serving)) summed left to right
//     from 0.0, then + P_cs * cs_busy when P_cs is set, and
//     energy = fma(dt_eff, p_w, energy), on the statistics thread;
//   - the O(1) carries (occupancy +-1 at two stations, serving[c],
//     cs_busy, delay_sum[c], delay_cnt[c], t0, t1), the statistics thread
//     again; and t, round, seq_ctr.
// Event i is kept when i < rem and, with stop_on_update, no earlier kept
// event was an update; a masked event still writes its time and
// descriptors, and changes nothing.  With STATS and an event ring
// (LaneArgs::r_count set), thread 0 also writes each kept event's record,
// repro_torch.obs.rings' columns, at count % ring_cap of the lane's row and
// counts it; the ring is read by nothing else, so the state is bitwise
// that of a launch without it, and a launch without one skips the writes
// on a launch-wide flag (thread 0's branch, uniform across the launch).
//
// STATS = false is the transition alone, the contract of the TPU kernels
// (event_step, megastep below: tables in, tables and descriptors out), on
// one warp, in the LAW_SCALE form only.  With STATS every form is built,
// and the launch picks it from LaneArgs::law.  STATS = true is the main path's: a CTA of LANE_THREADS carries
// the lane's whole EventState, so that one launch retires its events and no
// PyTorch operation runs per event.  Its statistics thread sits outside
// warp 0: it takes the previous event's carries and this event's power sum
// (both read only the state before this event) while warp 0 runs this
// event's transition, so a kept event costs the transition, two barriers
// and the O(n) window update.
//
// Storage: the lane's five table rows, with STATS its statistics rows (occ,
// occ_int, serving, delay_sum, delay_cnt) and power rows, its rate rows and
// the events' inputs are staged in shared memory (SMEM: about 15 KB a lane
// at n = 100, m_max = 132, chunk 32) and written back once; a lane whose
// rows pass what a block may stage on the device (n above about 2,000 with
// STATS) is worked on in place in its output rows in global memory
// (L1-cached), by the same code.  The output state may alias the input
// state (the caller donates its buffers).
//
// Bound: bytes: each row read and written once, the power rows read once,
// one sector per rate gather, the events' inputs, times and descriptors;
// about 16 KB a lane at n = 100, so a few hundredths of a microsecond for
// the main path's 6 lanes.  A launch (a few microseconds) is the real floor,
// and within it the event chain: each event's argmin, FIFO picks and, with
// power, an n-long sequential sum, none of which can overlap the next event.

#define LANE_THREADS 256
#define STATS_THREAD 32  // the statistics' serial part, beside warp 0

// Pointers are [K, ...] row-major; the state's fields in EventState's order.
// The transition alone reads only the table rows, round, seq_ctr, the rates,
// the events and rem / keep, and writes only the table rows, the events'
// times and their descriptors; the other pointers are null.
struct LaneArgs {
  // the state in
  const double* t;
  const int* round;
  const int* seq_ctr;
  const int* client;
  const int* phase;
  const double* finish;
  const int* seq;
  const int* disp;
  const int* warmup;
  const int* cap;
  const double* t_cap;
  const double* t0;
  const double* t1;
  const double* delay_sum;
  const int* delay_cnt;
  const double* energy;
  const double* occ_int;
  const double* occ;
  const double* serving;
  const bool* cs_busy;
  // the state out (the same fields without warmup, cap and t_cap); may be
  // the state in
  double* o_t;
  int* o_round;
  int* o_seq_ctr;
  int* o_client;
  int* o_phase;
  double* o_finish;
  int* o_seq;
  int* o_disp;
  double* o_t0;
  double* o_t1;
  double* o_delay_sum;
  int* o_delay_cnt;
  double* o_energy;
  double* o_occ_int;
  double* o_occ;
  double* o_serving;
  bool* o_cs_busy;
  // rates [K, n]; power [K, n] (null without a profile), P_cs [K] (null
  // without one)
  const double* mu_c;
  const double* mu_u;
  const double* P_c;
  const double* P_u;
  const double* P_d;
  const double* P_cs;
  // the events: fs [K, chunk, law_width(law)] (a lane's row fs_stride
  // apart, each row contiguous), c_new [K, chunk] (rows cn_stride apart);
  // rem [K] (null: rem_all for every lane), keep [K] (null: every lane)
  const double* fs;
  const int* c_new;
  const int* rem;
  const bool* keep;
  // per event: the time [K, chunk] and desc_width descriptors [K, chunk,
  // desc_width] (the nine of one_event, then keep when desc_width is 10)
  double* ev_t;
  int* ev_int;
  // the event ring (repro_torch.obs.rings.EventRing; null without one):
  // eight columns [K, ring_cap] and count [K], the caller's own buffers,
  // written in place; each kept event goes at count % ring_cap
  double* r_time;
  int* r_station;
  int* r_station_to;
  int* r_kind;
  int* r_slot;
  int* r_client;
  int* r_delay;
  int* r_update;
  int* r_count;
  // round, seq_ctr and rem are sc_stride apart from lane to lane
  long long fs_stride, cn_stride, sc_stride;
  int K, m_max, n, has_cs, chunk, rem_all, stop_on_update, desc_width;
  int law;  // the rate form: LAW_SCALE, LAW_H2 or LAW_LOGNORMAL
  int ring_cap;
};

// torch.minimum: a NaN operand gives NaN
__device__ __forceinline__ double min_nan(double a, double b) {
  return (a < b || a != a) ? a : b;
}

// the row of the [3n+1] occupancy a task in (phase, client) counts in
__device__ __forceinline__ int station(int ph, int cl, int n) {
  return ph == DOWN ? cl
         : (ph == COMP_WAIT || ph == COMP_SERV) ? n + cl
         : ph == UP ? 2 * n + cl
                    : 3 * n;
}

// What the carries of one kept event need from it.
struct Kept {
  double t_new;
  int c, is_update, delay, new_round, ph, do_comp, do_cs, c_new;
  bool measure;
};

// replay_one's serial part, on the statistics thread: its registers and its
// two serial steps (the window update over the stations is inline below).
struct ReplayOne {
  double energy, t0, t1, p_w;
  bool cs_busy;

  // p_w over the state before the event: the fused per-client terms summed
  // left to right, then the CS term
  __device__ void power(const double* P_c, const double* P_u,
                        const double* P_d, const double* P_cs,
                        const double* occ, const double* srv, int n) {
    double acc = 0.0;
    for (int c = 0; c < n; ++c)
      acc = acc + fma(P_d[c], occ[c], fma(P_u[c], occ[2 * n + c],
                                          P_c[c] * srv[c]));
    if (P_cs != nullptr) acc = acc + *P_cs * (cs_busy ? 1.0 : 0.0);
    p_w = acc;
  }

  // the O(1) carries: slot j moved stations; the FIFO promotions stay in
  // theirs and only flip the busy indicators
  __device__ void carries(const Kept& e, double* occ, double* srv,
                          double* dsum, int* dcnt, int n, bool has_cs,
                          int warmup, int cap) {
    const bool is_down = e.ph == DOWN;
    const bool is_comp = e.ph == COMP_SERV;
    const bool is_cs = e.ph == CS_SERV;
    const int phase_j = is_down ? COMP_WAIT
                                : (is_comp ? UP : (e.is_update ? DOWN
                                                               : CS_WAIT));
    const int S = 3 * n + 1;
    const int s_in = station(phase_j, e.is_update ? e.c_new : e.c, n);
    const int s_out = station(e.ph, e.c, n);
    if (s_in >= 0 && s_in < S) occ[s_in] = occ[s_in] + 1.0;
    if (s_out >= 0 && s_out < S) occ[s_out] = occ[s_out] - 1.0;
    if (e.c >= 0 && e.c < n) {
      srv[e.c] = srv[e.c] + ((e.do_comp ? 1.0 : 0.0) - (is_comp ? 1.0 : 0.0));
      const bool counted = e.is_update && e.measure;
      dsum[e.c] = dsum[e.c] + (counted ? (double)e.delay : 0.0);
      dcnt[e.c] = dcnt[e.c] + (counted ? 1 : 0);
    }
    if (has_cs) cs_busy = (cs_busy && !is_cs) || e.do_cs;
    if (e.is_update && e.new_round == warmup) t0 = e.t_new;
    if (e.is_update && e.new_round == cap) t1 = e.t_new;
  }
};

template <typename T>
__device__ __forceinline__ void copy_row(T* dst, const T* src, int len) {
  if (dst != src)
    for (int i = threadIdx.x; i < len; i += blockDim.x) dst[i] = src[i];
}

// Dynamic shared memory of a staged lane: the f64 rows, then the int32 rows
// (`width` scalars an event).
static size_t lane_smem_bytes(int m_max, int n, int chunk, bool stats,
                              bool power, int width) {
  const size_t S = stats ? 3 * (size_t)n + 1 : 0;
  const size_t ns = stats ? (size_t)n : 0;
  return 8 * ((size_t)m_max + 2 * S + 2 * ns + 2 * (size_t)n +
              (power ? 3 * (size_t)n : 0) + (size_t)width * chunk) +
         4 * (4 * (size_t)m_max + ns + chunk);
}

template <bool SMEM, bool STATS, int LAW>
__device__ __forceinline__ void lane_events(const LaneArgs& a,
                                            double* smem) {
  constexpr int W = law_width(LAW);
  __shared__ double s_t;  // the kept event's clock and descriptors
  __shared__ int s_d[9];
  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const int M = a.m_max, n = a.n, S = 3 * n + 1, chunk = a.chunk;
  const bool power = STATS && a.P_c != nullptr;
  const size_t tr = (size_t)k * M, nr = (size_t)k * n, sr = (size_t)k * S;

  double *fin, *occ = nullptr, *occ_int = nullptr, *srv = nullptr,
               *dsum = nullptr;
  int *pha, *cli, *sq, *dis, *dcnt = nullptr;
  const double *muc, *muu, *fs;
  const double *pc = nullptr, *pu = nullptr, *pd = nullptr;
  const int* cn;
  if (SMEM) {
    const int Ss = STATS ? S : 0, ns = STATS ? n : 0;
    fin = smem;
    occ = fin + M;
    occ_int = occ + Ss;
    srv = occ_int + Ss;
    dsum = srv + ns;
    double* s_muc = dsum + ns;
    double* s_muu = s_muc + n;
    double* s_pw = s_muu + n;
    double* s_fs = s_pw + (power ? 3 * n : 0);
    pha = reinterpret_cast<int*>(s_fs + W * chunk);
    cli = pha + M;
    sq = cli + M;
    dis = sq + M;
    dcnt = dis + M;
    int* s_cn = dcnt + ns;
    for (int i = tid; i < M; i += blockDim.x) {
      fin[i] = a.finish[tr + i];
      pha[i] = a.phase[tr + i];
      cli[i] = a.client[tr + i];
      sq[i] = a.seq[tr + i];
      dis[i] = a.disp[tr + i];
    }
    if (STATS)
      for (int i = tid; i < S; i += blockDim.x) {
        occ[i] = a.occ[sr + i];
        occ_int[i] = a.occ_int[sr + i];
      }
    for (int i = tid; i < n; i += blockDim.x) {
      if (STATS) {
        srv[i] = a.serving[nr + i];
        dsum[i] = a.delay_sum[nr + i];
        dcnt[i] = a.delay_cnt[nr + i];
      }
      s_muc[i] = a.mu_c[nr + i];
      s_muu[i] = a.mu_u[nr + i];
      if (power) {
        s_pw[i] = a.P_c[nr + i];
        s_pw[n + i] = a.P_u[nr + i];
        s_pw[2 * n + i] = a.P_d[nr + i];
      }
    }
    for (int i = tid; i < W * chunk; i += blockDim.x)
      s_fs[i] = a.fs[k * a.fs_stride + i];
    for (int i = tid; i < chunk; i += blockDim.x)
      s_cn[i] = a.c_new[k * a.cn_stride + i];
    muc = s_muc;
    muu = s_muu;
    if (power) {
      pc = s_pw;
      pu = s_pw + n;
      pd = s_pw + 2 * n;
    }
    fs = s_fs;
    cn = s_cn;
  } else {
    fin = a.o_finish + tr;
    pha = a.o_phase + tr;
    cli = a.o_client + tr;
    sq = a.o_seq + tr;
    dis = a.o_disp + tr;
    copy_row(fin, a.finish + tr, M);
    copy_row(pha, a.phase + tr, M);
    copy_row(cli, a.client + tr, M);
    copy_row(sq, a.seq + tr, M);
    copy_row(dis, a.disp + tr, M);
    if (STATS) {
      occ = a.o_occ + sr;
      occ_int = a.o_occ_int + sr;
      srv = a.o_serving + nr;
      dsum = a.o_delay_sum + nr;
      dcnt = a.o_delay_cnt + nr;
      copy_row(occ, a.occ + sr, S);
      copy_row(occ_int, a.occ_int + sr, S);
      copy_row(srv, a.serving + nr, n);
      copy_row(dsum, a.delay_sum + nr, n);
      copy_row(dcnt, a.delay_cnt + nr, n);
    }
    muc = a.mu_c + nr;
    muu = a.mu_u + nr;
    if (power) {
      pc = a.P_c + nr;
      pu = a.P_u + nr;
      pd = a.P_d + nr;
    }
    fs = a.fs + k * a.fs_stride;
    cn = a.c_new + k * a.cn_stride;
  }

  // the lane's scalars: round in every thread (with STATS each thread
  // updates its copy alike; without, warp 0 is every thread), seq_ctr in
  // warp 0, t likewise, the rest in the statistics thread
  const long long sc = a.sc_stride;
  int rnd = a.round[k * sc];
  int seq_ctr = a.seq_ctr[k * sc];
  int rem = a.rem != nullptr ? a.rem[k * sc] : a.rem_all;
  if (a.keep != nullptr && !a.keep[k]) rem = 0;
  const bool has_cs = a.has_cs != 0;
  double t = 0.0, t_cap = 0.0;
  int warmup = 0, cap = 0;
  const double* P_cs = nullptr;
  ReplayOne st;
  if (STATS) {
    t = a.t[k];
    warmup = a.warmup[k];
    cap = a.cap[k];
    t_cap = a.t_cap[k];
    P_cs = a.P_cs != nullptr ? a.P_cs + k : nullptr;
    st.energy = a.energy[k];
    st.t0 = a.t0[k];
    st.t1 = a.t1[k];
    st.cs_busy = a.cs_busy[k];
    st.p_w = 0.0;
  }
  Kept prev;
  bool pending = false;  // the statistics thread owes prev its carries
  // the event ring: a launch-wide flag, its count in thread 0's register
  const bool ring = STATS && a.r_count != nullptr;
  int ring_count = 0;
  if (ring && tid == 0) ring_count = a.r_count[k];
  __syncthreads();

  bool done = false;
  for (int i = 0; i < chunk; ++i) {
    const bool keep = i < rem && !done;  // the same in every thread
    if (tid < 32) {
      EventIn in;
      in.x_up = fs[W * i + 0];
      in.x_comp = fs[W * i + 1];
      in.svc_down = fs[W * i + 2];
      in.svc_cs = fs[W * i + 3];
      in.f_up = W > 4 ? fs[W * i + 4] : 0.0;
      in.f_comp = W > 4 ? fs[W * i + 5] : 0.0;
      in.c_new = cn[i];
      in.seq_ctr = seq_ctr;
      in.rnd = rnd;
      const EventDesc d = one_event<LAW>(fin, pha, cli, sq, dis, fin, pha,
                                         cli, sq, dis, keep, muc, muu, M, n,
                                         has_cs, in);
      if (keep) seq_ctr = d.new_seq_ctr;
      if (!STATS && keep) {
        rnd = d.new_round;
        if (a.stop_on_update && d.is_update) done = true;
      }
      if (tid == 0) {
        a.ev_t[(size_t)k * chunk + i] = d.t_new;
        int* dst = a.ev_int + ((size_t)k * chunk + i) * a.desc_width;
        write_desc(dst, d);
        if (a.desc_width == 10) dst[9] = keep ? 1 : 0;
        if (STATS && keep) {
          s_t = d.t_new;
          s_d[0] = d.j;
          s_d[1] = d.c;
          s_d[2] = d.is_update;
          s_d[3] = d.delay;
          s_d[4] = d.new_seq_ctr;
          s_d[5] = d.new_round;
          s_d[6] = d.ph;
          s_d[7] = d.do_comp;
          s_d[8] = d.do_cs;
          if (ring) {
            // the record replay_one's carries move: slot j left (ph, c)
            // for phase_j, owned by c_new after an update
            const size_t at =
                (size_t)k * a.ring_cap + (size_t)(ring_count % a.ring_cap);
            const int phase_j =
                d.ph == DOWN ? COMP_WAIT
                             : (d.ph == COMP_SERV ? UP
                                                  : (d.is_update ? DOWN
                                                                 : CS_WAIT));
            a.r_time[at] = d.t_new;
            a.r_station[at] = station(d.ph, d.c, n);
            a.r_station_to[at] =
                station(phase_j, d.is_update ? in.c_new : d.c, n);
            a.r_kind[at] = d.ph;
            a.r_slot[at] = d.j;
            a.r_client[at] = d.c;
            a.r_delay[at] = d.delay;
            a.r_update[at] = d.is_update;
            ++ring_count;
          }
        }
      }
    } else if (STATS && tid == STATS_THREAD && keep) {
      if (pending) st.carries(prev, occ, srv, dsum, dcnt, n, has_cs, warmup,
                              cap);
      pending = false;
      if (power) st.power(pc, pu, pd, P_cs, occ, srv, n);
    }
    if (!STATS || !keep) continue;  // once masked, every later event is too
    __syncthreads();

    // the window over the sojourn that ends at this event
    const double t_new = s_t;
    const bool measure = rnd >= warmup && rnd < cap;
    double dt = 0.0;
    if (measure) {
      dt = min_nan(t_new, t_cap) - min_nan(t, t_cap);
      if (dt < 0.0) dt = 0.0;
    }
    for (int s = tid; s < S; s += blockDim.x)
      occ_int[s] = occ_int[s] + dt * occ[s];
    if (tid == STATS_THREAD) {
      if (power) st.energy = fma(dt, st.p_w, st.energy);
      prev.t_new = t_new;
      prev.c = s_d[1];
      prev.is_update = s_d[2];
      prev.delay = s_d[3];
      prev.new_round = s_d[5];
      prev.ph = s_d[6];
      prev.do_comp = s_d[7];
      prev.do_cs = s_d[8];
      prev.c_new = cn[i];
      prev.measure = measure;
      pending = true;
    }
    if (a.stop_on_update && s_d[2]) done = true;
    t = t_new;
    rnd = s_d[5];
    __syncthreads();
  }
  if (STATS && tid == STATS_THREAD && pending)
    st.carries(prev, occ, srv, dsum, dcnt, n, has_cs, warmup, cap);
  __syncthreads();

  if (SMEM) {
    for (int i = tid; i < M; i += blockDim.x) {
      a.o_finish[tr + i] = fin[i];
      a.o_phase[tr + i] = pha[i];
      a.o_client[tr + i] = cli[i];
      a.o_seq[tr + i] = sq[i];
      a.o_disp[tr + i] = dis[i];
    }
    if (STATS) {
      for (int i = tid; i < S; i += blockDim.x) {
        a.o_occ[sr + i] = occ[i];
        a.o_occ_int[sr + i] = occ_int[i];
      }
      for (int i = tid; i < n; i += blockDim.x) {
        a.o_serving[nr + i] = srv[i];
        a.o_delay_sum[nr + i] = dsum[i];
        a.o_delay_cnt[nr + i] = dcnt[i];
      }
    }
  }
  if (STATS && tid == 0) {
    a.o_t[k] = t;
    a.o_round[k] = rnd;
    a.o_seq_ctr[k] = seq_ctr;
  }
  if (ring && tid == 0) a.r_count[k] = ring_count;
  if (STATS && tid == STATS_THREAD) {
    a.o_energy[k] = st.energy;
    a.o_t0[k] = st.t0;
    a.o_t1[k] = st.t1;
    a.o_cs_busy[k] = st.cs_busy;
  }
}

template <bool SMEM, bool STATS, int LAW>
__global__ void __launch_bounds__(LANE_THREADS)
    lanes_kernel(const LaneArgs a) {
  extern __shared__ double lane_rows[];
  lane_events<SMEM, STATS, LAW>(a, lane_rows);
}

// The most dynamic shared memory one block of lanes_kernel<true, STATS, LAW>
// may take on the current device: the opt-in limit less the kernel's static
// shared memory (asked once per device and instantiation).
template <bool STATS, int LAW>
static cudaError_t stage_limit(size_t* limit) {
  static size_t known[64];  // by device; 0 until asked
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && known[dev] != 0) {
    *limit = known[dev];
    return cudaSuccess;
  }
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(
      &attr, reinterpret_cast<const void*>(lanes_kernel<true, STATS, LAW>));
  if (err != cudaSuccess) return err;
  *limit = (size_t)optin - attr.sharedSizeBytes;
  if (dev < 64) known[dev] = *limit;
  return cudaSuccess;
}

template <bool STATS, int LAW>
static int launch_lanes(const LaneArgs& a, cudaStream_t stream) {
  if (a.K <= 0) return 0;
  const int threads = STATS ? LANE_THREADS : 32;
  const size_t smem = lane_smem_bytes(a.m_max, a.n, a.chunk, STATS,
                                      STATS && a.P_c != nullptr,
                                      law_width(LAW));
  size_t limit = 0;
  cudaError_t err = stage_limit<STATS, LAW>(&limit);
  if (err != cudaSuccess) return (int)err;
  if (smem <= limit) {
    if (smem > 48 * 1024) {
      // above 48 KB a block's dynamic shared memory needs an opt-in
      err = cudaFuncSetAttribute(lanes_kernel<true, STATS, LAW>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    lanes_kernel<true, STATS, LAW><<<a.K, threads, smem, stream>>>(a);
  } else {
    lanes_kernel<false, STATS, LAW><<<a.K, threads, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// The transition alone, the TPU kernels' contract: one event per lane.
// fscal [K, 4] (e_up, e_comp, svc_down, svc_cs), iscal [K, 3] (c_new,
// seq_ctr, round); writes the five rows, o_t [K] and o_int [K, 9].
extern "C" int event_step(const double* finish, const int* phase,
                          const int* client, const int* seq, const int* disp,
                          const double* mu_c, const double* mu_u,
                          const double* fscal, const int* iscal,
                          double* o_finish, int* o_phase, int* o_client,
                          int* o_seq, int* o_disp, double* o_t, int* o_int,
                          int K, int m_max, int n, int has_cs,
                          cudaStream_t stream) {
  LaneArgs a = {};
  a.finish = finish;
  a.phase = phase;
  a.client = client;
  a.seq = seq;
  a.disp = disp;
  a.o_finish = o_finish;
  a.o_phase = o_phase;
  a.o_client = o_client;
  a.o_seq = o_seq;
  a.o_disp = o_disp;
  a.mu_c = mu_c;
  a.mu_u = mu_u;
  a.fs = fscal;
  a.fs_stride = 4;
  a.c_new = iscal;
  a.seq_ctr = iscal + 1;
  a.round = iscal + 2;
  a.cn_stride = a.sc_stride = 3;
  a.ev_t = o_t;
  a.ev_int = o_int;
  a.K = K;
  a.m_max = m_max;
  a.n = n;
  a.has_cs = has_cs;
  a.chunk = 1;
  a.rem_all = 1;
  a.desc_width = 9;
  return launch_lanes<false, LAW_SCALE>(a, stream);
}

// The transition alone for up to `chunk` events per lane: fscal [K, 4 *
// chunk] (e_up, e_comp, svc_down, svc_cs per event), iscal [K, 3 + chunk]
// (seq_ctr, round, rem, then the routed clients); writes the five rows,
// o_t [K, chunk] and o_int [K, 10 * chunk] (the nine descriptors and keep).
extern "C" int megastep(const double* finish, const int* phase,
                        const int* client, const int* seq, const int* disp,
                        const double* mu_c, const double* mu_u,
                        const double* fscal, const int* iscal,
                        double* o_finish, int* o_phase, int* o_client,
                        int* o_seq, int* o_disp, double* o_t, int* o_int,
                        int K, int m_max, int n, int has_cs, int chunk,
                        int stop_on_update, cudaStream_t stream) {
  LaneArgs a = {};
  a.finish = finish;
  a.phase = phase;
  a.client = client;
  a.seq = seq;
  a.disp = disp;
  a.o_finish = o_finish;
  a.o_phase = o_phase;
  a.o_client = o_client;
  a.o_seq = o_seq;
  a.o_disp = o_disp;
  a.mu_c = mu_c;
  a.mu_u = mu_u;
  a.fs = fscal;
  a.fs_stride = 4 * (long long)chunk;
  a.seq_ctr = iscal;
  a.round = iscal + 1;
  a.rem = iscal + 2;
  a.c_new = iscal + 3;
  a.cn_stride = a.sc_stride = 3 + (long long)chunk;
  a.ev_t = o_t;
  a.ev_int = o_int;
  a.K = K;
  a.m_max = m_max;
  a.n = n;
  a.has_cs = has_cs;
  a.chunk = chunk;
  a.stop_on_update = stop_on_update;
  a.desc_width = 10;
  return launch_lanes<false, LAW_SCALE>(a, stream);
}

// The main path's lane steps: the events with their statistics, in the
// rate form a->law.
extern "C" int lanes(const LaneArgs* a, cudaStream_t stream) {
  switch (a->law) {
    case LAW_SCALE:
      return launch_lanes<true, LAW_SCALE>(*a, stream);
    case LAW_H2:
      return launch_lanes<true, LAW_H2>(*a, stream);
    case LAW_LOGNORMAL:
      return launch_lanes<true, LAW_LOGNORMAL>(*a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
