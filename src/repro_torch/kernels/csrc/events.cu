// One event of the closed-network event engine per lane, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/events.py::event_step_tables
// (body _event_kernel / _one_event).  Each lane holds a task table of
// m_max slots: finish (f64, +inf when not in service), phase, client, seq
// and dispatch round (int32).  One event:
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
// rule decides trajectories.  Service variates arrive drawn at unit rate in
// fscal = [e_up, e_comp, svc_down, svc_cs] and are rescaled by the
// completing client's rate here (e / mu[c]).  Build with -fmad=false and
// IEEE division: the f64 results are then bitwise those of the plain
// PyTorch version.
//
// Layout: one warp per lane (the TPU's grid axis); slots are strided over
// the warp, and the argmin and both FIFO picks are warp reductions on
// (value, index) pairs.  Bound: bytes — each table row is read once and
// written once; at the main path's sizes (a few lanes of 132 slots) the
// launch, not the bytes, sets the time.
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
  const int lane = threadIdx.x;
  const size_t row = (size_t)k * m_max;
  const double* fin = finish + row;
  const int* pha = phase + row;
  const int* cli = client + row;
  const int* sq = seq + row;
  const int* dis = disp + row;

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

  const int c_new = iscal[k * 3 + 0];
  const int seq_ctr = iscal[k * 3 + 1];
  const int rnd = iscal[k * 3 + 2];
  const double e_up = fscal[k * 4 + 0];
  const double e_comp = fscal[k * 4 + 1];
  const double svc_down = fscal[k * 4 + 2];
  const double svc_cs = fscal[k * 4 + 3];

  const int c = cli[j];
  const int ph = pha[j];
  const int delay = rnd - dis[j];
  const bool is_down = ph == DOWN;
  const bool is_comp = ph == COMP_SERV;
  const bool is_up = ph == UP;
  const bool is_cs = ph == CS_SERV;
  const bool is_update = has_cs ? is_cs : is_up;
  const int new_round = rnd + (is_update ? 1 : 0);

  // rate gathers (a client outside [0, n) reads 0, as the TPU kernel's
  // one-hot gather does)
  const bool c_ok = c >= 0 && c < n;
  const double rate_u = c_ok ? mu_u[(size_t)k * n + c] : 0.0;
  const double rate_c = c_ok ? mu_c[(size_t)k * n + c] : 0.0;
  const double svc_up = e_up / rate_u;
  const double svc_c = e_comp / rate_c;

  // -- 2. phase promotion / routing of slot j -------------------------------
  const int phase_j = is_down ? COMP_WAIT
                              : (is_comp ? UP : (is_update ? DOWN : CS_WAIT));
  const double finish_j =
      is_comp ? t_new + svc_up : (is_update ? t_new + svc_down : INFINITY);
  const bool joins_fifo = is_down || (is_up && has_cs);
  const int seq_j = joins_fifo ? seq_ctr : sq[j];
  const int new_seq_ctr = seq_ctr + (joins_fifo ? 1 : 0);
  const int client_j = is_update ? c_new : c;
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

  for (int i = lane; i < m_max; i += 32) {
    int p_i = i == j ? phase_j : pha[i];
    double f_i = i == j ? finish_j : fin[i];
    if (do_comp && i == w_idx) {
      p_i = COMP_SERV;
      f_i = t_new + svc_c;
    }
    if (do_cs && i == cs_idx) {
      p_i = CS_SERV;
      f_i = t_new + svc_cs;
    }
    o_phase[row + i] = p_i;
    o_finish[row + i] = f_i;
    o_client[row + i] = i == j ? client_j : cli[i];
    o_seq[row + i] = i == j ? seq_j : sq[i];
    o_disp[row + i] = i == j ? disp_j : dis[i];
  }
  if (lane == 0) {
    o_t[k] = t_new;
    int* d = o_int + (size_t)k * 9;
    d[0] = j;
    d[1] = c;
    d[2] = is_update ? 1 : 0;
    d[3] = delay;
    d[4] = new_seq_ctr;
    d[5] = new_round;
    d[6] = ph;
    d[7] = do_comp ? 1 : 0;
    d[8] = do_cs ? 1 : 0;
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
