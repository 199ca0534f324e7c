// The closed-network event engine's table transition, hand-written for
// Hopper (sm_90a): one event per lane (event_kernel) and up to `chunk`
// events per lane in one launch (megastep_kernel).  Both run the same
// per-event body, one_event().
//
// Replaces the Pallas TPU kernels repro/kernels/events.py::event_step_tables
// (body _event_kernel / _one_event) and ::megastep_tables
// (_megastep_kernel).  Each lane holds a task table of m_max slots: finish
// (f64, +inf when not in service), phase, client, seq and dispatch round
// (int32).  One event:
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
// rule decides trajectories.  Service variates arrive drawn at unit rate
// ([e_up, e_comp, svc_down, svc_cs] per event) and are rescaled by the
// completing client's rate here (e / mu[c]).  Build with -fmad=false and
// IEEE division: the f64 results are then bitwise those of the plain
// PyTorch versions.
//
// Layout: one warp per lane (the TPU's grid axis); slots are strided over
// the warp, and the argmin and both FIFO picks are warp reductions on
// (value, index) pairs.  The megastep loads the lane's five rows (24 B a
// slot) into shared memory once, retires its events there, writes each
// event's time and 10 descriptors as it goes and the rows back once at the
// end; `chunk` is a runtime argument, so the event loop is not unrolled.
// Bound: bytes (each row read and written once, one 32-byte sector per rate
// gather, the scalars in and the descriptors out); at the main path's sizes
// (a few lanes of 132 slots) the launch, not the bytes, sets the time.
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

// One event's outside-drawn scalars and counters.
struct EventIn {
  double e_up, e_comp, svc_down, svc_cs;
  int c_new, seq_ctr, rnd;
};

// The transition's descriptors, the same in every thread of the warp.
struct EventDesc {
  double t_new;
  int j, c, is_update, delay, new_seq_ctr, new_round, ph, do_comp, do_cs;
};

// One event on one lane's rows, run by the whole warp.  Reads the rows
// fin..dis; when `write`, writes the new rows to o_fin..o_dis, which may be
// the same rows (the megastep's shared memory): every read of another
// thread's slot comes before the first __syncwarp() below, and each thread
// then writes only its own slots.  mu_c/mu_u are the lane's rate rows.
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
  const double svc_up = in.e_up / rate_u;
  const double svc_c = in.e_comp / rate_c;

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

__global__ void event_kernel(
    const double* __restrict__ finish, const int* __restrict__ phase,
    const int* __restrict__ client, const int* __restrict__ seq,
    const int* __restrict__ disp, const double* __restrict__ mu_c,
    const double* __restrict__ mu_u, const double* __restrict__ fscal,
    const int* __restrict__ iscal, double* __restrict__ o_finish,
    int* __restrict__ o_phase, int* __restrict__ o_client,
    int* __restrict__ o_seq, int* __restrict__ o_disp,
    double* __restrict__ o_t, int* __restrict__ o_int, int m_max, int n,
    int has_cs) {
  const int k = blockIdx.x;
  const size_t row = (size_t)k * m_max;
  EventIn in;
  in.e_up = fscal[k * 4 + 0];
  in.e_comp = fscal[k * 4 + 1];
  in.svc_down = fscal[k * 4 + 2];
  in.svc_cs = fscal[k * 4 + 3];
  in.c_new = iscal[k * 3 + 0];
  in.seq_ctr = iscal[k * 3 + 1];
  in.rnd = iscal[k * 3 + 2];
  const EventDesc d = one_event(
      finish + row, phase + row, client + row, seq + row, disp + row,
      o_finish + row, o_phase + row, o_client + row, o_seq + row,
      o_disp + row, true, mu_c + (size_t)k * n, mu_u + (size_t)k * n, m_max,
      n, has_cs != 0, in);
  if (threadIdx.x == 0) {
    o_t[k] = d.t_new;
    write_desc(o_int + (size_t)k * 9, d);
  }
}

// fscal [K, 4 * chunk] (e_up, e_comp, svc_down, svc_cs per event), iscal
// [K, 3 + chunk] (seq_ctr, round, rem, then the routed clients); writes
// o_t [K, chunk] and o_int [K, 10 * chunk] (the nine descriptors and keep).
// keep_i = (i < rem) && !done; with stop_on_update, done latches after the
// first kept update.  A masked event still computes its transition and
// descriptors on the held rows, and writes nothing to them.
__global__ void megastep_kernel(
    const double* __restrict__ finish, const int* __restrict__ phase,
    const int* __restrict__ client, const int* __restrict__ seq,
    const int* __restrict__ disp, const double* __restrict__ mu_c,
    const double* __restrict__ mu_u, const double* __restrict__ fscal,
    const int* __restrict__ iscal, double* __restrict__ o_finish,
    int* __restrict__ o_phase, int* __restrict__ o_client,
    int* __restrict__ o_seq, int* __restrict__ o_disp,
    double* __restrict__ o_t, int* __restrict__ o_int, int m_max, int n,
    int has_cs, int chunk, int stop_on_update) {
  extern __shared__ double smem[];
  double* s_fin = smem;
  int* s_pha = reinterpret_cast<int*>(s_fin + m_max);
  int* s_cli = s_pha + m_max;
  int* s_sq = s_cli + m_max;
  int* s_dis = s_sq + m_max;

  const int k = blockIdx.x;
  const int lane = threadIdx.x;
  const size_t row = (size_t)k * m_max;
  for (int i = lane; i < m_max; i += 32) {
    s_fin[i] = finish[row + i];
    s_pha[i] = phase[row + i];
    s_cli[i] = client[row + i];
    s_sq[i] = seq[row + i];
    s_dis[i] = disp[row + i];
  }
  __syncwarp();

  const double* fs = fscal + (size_t)k * 4 * chunk;
  const int* is = iscal + (size_t)k * (3 + chunk);
  int seq_ctr = is[0];
  int rnd = is[1];
  const int rem = is[2];
  bool done = false;
  for (int i = 0; i < chunk; ++i) {
    EventIn in;
    in.e_up = fs[4 * i + 0];
    in.e_comp = fs[4 * i + 1];
    in.svc_down = fs[4 * i + 2];
    in.svc_cs = fs[4 * i + 3];
    in.c_new = is[3 + i];
    in.seq_ctr = seq_ctr;
    in.rnd = rnd;
    const bool keep = i < rem && !done;
    const EventDesc d = one_event(
        s_fin, s_pha, s_cli, s_sq, s_dis, s_fin, s_pha, s_cli, s_sq, s_dis,
        keep, mu_c + (size_t)k * n, mu_u + (size_t)k * n, m_max, n,
        has_cs != 0, in);
    if (stop_on_update) done = done || (keep && d.is_update);
    if (keep) {
      seq_ctr = d.new_seq_ctr;
      rnd = d.new_round;
    }
    if (lane == 0) {
      o_t[(size_t)k * chunk + i] = d.t_new;
      int* dst = o_int + ((size_t)k * chunk + i) * 10;
      write_desc(dst, d);
      dst[9] = keep ? 1 : 0;
    }
  }

  for (int i = lane; i < m_max; i += 32) {
    o_finish[row + i] = s_fin[i];
    o_phase[row + i] = s_pha[i];
    o_client[row + i] = s_cli[i];
    o_seq[row + i] = s_sq[i];
    o_disp[row + i] = s_dis[i];
  }
}

extern "C" int event_step(const double* finish, const int* phase,
                          const int* client, const int* seq, const int* disp,
                          const double* mu_c, const double* mu_u,
                          const double* fscal, const int* iscal,
                          double* o_finish, int* o_phase, int* o_client,
                          int* o_seq, int* o_disp, double* o_t, int* o_int,
                          int K, int m_max, int n, int has_cs,
                          cudaStream_t stream) {
  if (K > 0)
    event_kernel<<<K, 32, 0, stream>>>(finish, phase, client, seq, disp, mu_c,
                                       mu_u, fscal, iscal, o_finish, o_phase,
                                       o_client, o_seq, o_disp, o_t, o_int,
                                       m_max, n, has_cs);
  return (int)cudaGetLastError();
}

extern "C" int megastep(const double* finish, const int* phase,
                        const int* client, const int* seq, const int* disp,
                        const double* mu_c, const double* mu_u,
                        const double* fscal, const int* iscal,
                        double* o_finish, int* o_phase, int* o_client,
                        int* o_seq, int* o_disp, double* o_t, int* o_int,
                        int K, int m_max, int n, int has_cs, int chunk,
                        int stop_on_update, cudaStream_t stream) {
  const size_t smem = (size_t)m_max * (sizeof(double) + 4 * sizeof(int));
  if (smem > 48 * 1024) {
    // above 48 KB a block's dynamic shared memory needs an opt-in
    const cudaError_t err = cudaFuncSetAttribute(
        megastep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (K > 0)
    megastep_kernel<<<K, 32, smem, stream>>>(
        finish, phase, client, seq, disp, mu_c, mu_u, fscal, iscal, o_finish,
        o_phase, o_client, o_seq, o_disp, o_t, o_int, m_max, n, has_cs, chunk,
        stop_on_update);
  return (int)cudaGetLastError();
}
