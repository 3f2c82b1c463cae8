// Fused renewal epoch-scan + Algorithm-1 fold for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/renewal_scan.py
// (renewal_scan_pallas / _renewal_kernel).  It computes, for every
// policy/scenario lane p and Monte-Carlo run r, the whole K-epoch renewal
// recursion in float32 with a Kahan-compensated energy ledger; the plain
// PyTorch version of the same function is renewal_scan_reference in
// ../renewal_scan.py, and every float32 operation below is written in its
// order so the two agree bit for bit.
//
// Design.  One thread per (lane, run); gridDim = (ceil(R / 128), P).  The
// block loads its lane's parameter row, node block and power ladder into
// shared memory once.  The carry (survivor checkpoint ages, the failed
// node's lost-work age, rendezvous anchors, the Kahan pairs of the clocks
// and of the four energy accumulators, the action counters) lives in
// registers: the arrays are bounded by kMaxN >= N and kMaxF >= F (4 each,
// the survivors and ladder levels of every configuration on the path; the
// wrapper raises above them) and every loop over them is unrolled with a
// guard, so their indices are compile-time constants.  Per epoch a thread reads one gap and
// N felled flags and writes one valid flag; runs sit on the last axis of
// gaps (K, R), felled (K, N, R) and valid (P, K, R), so a warp's accesses
// are coalesced.  Nothing per-epoch but `valid` leaves the registers.
//
// What bounds it.  Per occurring (epoch, survivor) point the thread does
// ~190 float32 operations and moves ~7 bytes (benchmarks/failure_sweep.py
// counts them), so the function is compute-bound on paper; this first
// version is a simple one and is limited in practice by the serial
// dependence chain of each thread's epoch loop.
//
// Numerics.  Built with -fmad=false and without fast-math: no
// multiply-add contraction (the Kahan steps and the closed forms
// q - j*period, exec_rem*beta + age must round as separate operations, or
// integer decision counts can flip at ct <= feas_rhs), no flush-to-zero, and
// IEEE division.  jnp.mod / torch.remainder is a floor-mod (the divisor's
// sign), fmod truncates: floor_mod() corrects it.  Runs whose epoch does
// not occur skip the body (an infinite padded gap would make NaNs in the
// sawtooth) but still take the zero increment of every Kahan pair, exactly
// as the reference does.
//
// One deliberate difference from the TPU kernel: the rendezvous anchors and
// their wrap (rem = anchor - work mod period, the re-anchor after P*) are
// float64.  In float32 the wrap's rounding is carried from re-anchor to
// re-anchor, and where the exact remainder is 0 (snapped failures on a
// checkpoint interval commensurate with the rendezvous period) the survivor
// lands a whole period away from the float64 oracle: whole-run energies
// off by up to ~3% on such runs.  The remainder then enters the float32
// math as (float)exec_rem.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kParams = 17;   // PARAM_COLS in ../renewal_scan.py
constexpr int kBlock = 128;
constexpr int kMaxN = 4;      // MAX_N in ../renewal_scan.py
constexpr int kMaxF = 4;      // MAX_F in ../renewal_scan.py
// column indices of the packed parameter row
enum Col {
  INTERVAL, DUR, REEXEC0, T_DOWN, T_RESTART, MU1, MU2, WAIT_MODE,
  P_IDLE_WAIT, MOVE_AHEAD, MOVE_FRAC, MAKESPAN, T_GO_SLEEP, T_WAKEUP,
  P_GO_SLEEP, P_WAKEUP, P_SLEEP
};
constexpr int kWaitActive = 0;          // WaitMode.ACTIVE
constexpr int kActionMinFreq = 1;       // WaitAction.MIN_FREQ
constexpr int kActionSleep = 2;         // WaitAction.SLEEP

__device__ __forceinline__ double floor_mod(double a, double b) {
  double r = fmod(a, b);
  if (r != 0.0 && ((r < 0.0) != (b < 0.0))) r += b;
  return r;
}

__device__ __forceinline__ float maxf(float a, float b) { return a > b ? a : b; }
__device__ __forceinline__ float minf(float a, float b) { return a < b ? a : b; }

// one compensated-summation step into the pair (s, c)
__device__ __forceinline__ void kadd(float& s, float& c, float x, bool comp) {
  if (!comp) { s = s + x; return; }
  float y = x - c;
  float t = s + y;
  c = (t - s) - y;
  s = t;
}

struct Sawtooth { float age, work, d_eff; };

// planning.advance_checkpoint_sawtooth
__device__ __forceinline__ Sawtooth advance(float age0, float delta,
                                            float interval, float dur) {
  float first = interval - age0;
  float period = interval + dur;
  bool fired = delta >= first;
  float q = maxf(delta - first, 0.0f);
  float j = floorf(q / period);
  float r = q - j * period;
  bool mid = fired && (r < dur);
  float n_fired = fired ? j + 1.0f : 0.0f;
  Sawtooth s;
  s.age = fired ? (mid ? 0.0f : r - dur) : age0 + delta;
  s.d_eff = mid ? first + j * period + dur : delta;
  s.work = s.d_eff - n_fired * dur;
  return s;
}

// planning.balanced_span: returns (work, ckpt)
__device__ __forceinline__ void balanced_span(float age0, float span,
                                              float interval, float dur,
                                              float& work, float& ckpt) {
  float first = interval - age0;
  float period = interval + dur;
  float q = maxf(span - first, 0.0f);
  float j = floorf(q / period);
  float r = q - j * period;
  ckpt = span > first ? j * dur + minf(r, dur) : 0.0f;
  work = span - ckpt;
}

// planning.timer_checkpoint_count
__device__ __forceinline__ float timer_count(float exec_rem, float age,
                                             float beta, float interval) {
  const float eps = (float)1e-9;
  return maxf(ceilf((exec_rem * beta + age - interval) / interval - eps), 0.0f);
}

__global__ void __launch_bounds__(kBlock)
renewal_scan_kernel(const float* __restrict__ params,
                    const float* __restrict__ nodes,
                    const float* __restrict__ ladder,
                    const float* __restrict__ gaps,
                    const float* __restrict__ felled,
                    int n, int nf, int n_epochs, int n_runs, bool comp,
                    int32_t* __restrict__ valid,
                    float* __restrict__ fstats,
                    int32_t* __restrict__ istats) {
  __shared__ float s_par[kParams];
  __shared__ float s_node[3][kMaxN];
  __shared__ float s_lad[5][kMaxF];
  const int p = blockIdx.y;
  for (int i = threadIdx.x; i < kParams; i += blockDim.x)
    s_par[i] = params[p * kParams + i];
  for (int i = threadIdx.x; i < 3 * n; i += blockDim.x)
    s_node[i / n][i % n] = nodes[p * 3 * n + i];
  for (int i = threadIdx.x; i < 5 * nf; i += blockDim.x)
    s_lad[i / nf][i % nf] = ladder[p * 5 * nf + i];
  __syncthreads();
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_runs) return;

  const float interval = s_par[INTERVAL], dur = s_par[DUR];
  const float t_restart = s_par[T_RESTART];
  const float t_dr = s_par[T_DOWN] + t_restart;
  const float makespan = s_par[MAKESPAN];
  const int wait_mode = (int)s_par[WAIT_MODE];
  const bool move_ahead = s_par[MOVE_AHEAD] > 0.5f;
  const float move_frac = s_par[MOVE_FRAC];
  const float mu1 = s_par[MU1], mu2 = s_par[MU2];
  const float p_idle_wait = s_par[P_IDLE_WAIT];
  const float trans_t = s_par[T_GO_SLEEP] + s_par[T_WAKEUP];
  const float trans_e = s_par[T_GO_SLEEP] * s_par[P_GO_SLEEP]
                      + s_par[T_WAKEUP] * s_par[P_WAKEUP];
  const float p_sleep = s_par[P_SLEEP];
  const float gate_t = mu1 * trans_t;
  const float* p_comp = s_lad[1];
  const float* beta = s_lad[2];
  const float* p_ckpt = s_lad[3];
  const float* gamma = s_lad[4];
  const float beta0 = beta[0], gamma0 = gamma[0];
  const float p_comp0 = p_comp[0], p_ckpt0 = p_ckpt[0];
  const float dur_fa = dur * gamma0;
  const bool active = wait_mode == kWaitActive;
  const float p_awake = active ? p_comp[nf - 1] : p_idle_wait;
  const float p_ref_wait = active ? p_comp0 : p_idle_wait;
  const float one_plus = (float)(1.0 + 1e-6);
  const float feas_abs = (float)1e-3;
  const float e_resync = (float)(n + 1) * dur_fa * p_ckpt0;

  // carry; the rendezvous anchors and their wrap are float64
  float ages[kMaxN];
  double anchor[kMaxN], period[kMaxN];
  float age_fail = s_par[REEXEC0];
#pragma unroll
  for (int i = 0; i < kMaxN; ++i) {
    if (i < n) {
      ages[i] = s_node[0][i];
      anchor[i] = (double)s_node[1][i];
      period[i] = (double)s_node[2][i];
    }
  }
  float bal = 0.f, bal_c = 0.f, t_anchor = 0.f, t_anchor_c = 0.f;
  float a_bal = 0.f, a_bal_c = 0.f, a_ref = 0.f, a_ref_c = 0.f;
  float a_int = 0.f, a_int_c = 0.f, a_sav = 0.f, a_sav_c = 0.f;
  int nfail = 0, npts = 0, nsleep = 0, nminf = 0, ncomp = 0, ninf = 0;
  bool alive = true;
  int32_t* valid_p = valid + (size_t)p * n_epochs * n_runs + r;

  for (int k = 0; k < n_epochs; ++k) {
    const float delta = gaps[(size_t)k * n_runs + r];
    const bool occurs = alive && (bal + delta <= makespan);
    valid_p[(size_t)k * n_runs] = occurs ? 1 : 0;
    float x_bal = 0.f, x_ref = 0.f, x_int = 0.f, x_sav = 0.f;
    float x_clock = 0.f, x_anchor = 0.f;
    if (occurs) {
      bool m[kMaxN];
      float age_f[kMaxN];
      double exec_rem[kMaxN];
      // geometry: sawtooth advance of every survivor and of the failed node
      float e_bal = 0.f;
      float reexec_fel = -INFINITY;
      double p_star64 = -INFINITY;
#pragma unroll
      for (int i = 0; i < kMaxN; ++i) {
        if (i < n) {
          m[i] = felled != nullptr &&
                 felled[((size_t)k * n + i) * n_runs + r] > 0.5f;
          Sawtooth s = advance(ages[i], delta, interval, dur);
          double rem = floor_mod(anchor[i] - (double)s.work, period[i]);
          exec_rem[i] = rem == 0.0 ? period[i] : rem;
          age_f[i] = s.age;
          float e = s.work * p_comp0 + (s.d_eff - s.work) * p_ckpt0;
          e_bal = i == 0 ? e : e_bal + e;
          if (m[i]) reexec_fel = maxf(reexec_fel, s.age);
          else if (exec_rem[i] > p_star64) p_star64 = exec_rem[i];
        }
      }
      Sawtooth sf = advance(age_fail, delta, interval, dur);
      e_bal = e_bal + (sf.work * p_comp0 + (sf.d_eff - sf.work) * p_ckpt0);
      const float reexec = maxf(sf.age, reexec_fel);
      if (!(p_star64 > 0.0)) p_star64 = 0.0;
      const float p_star = (float)p_star64;
      const float t_recover = t_dr + reexec;
      const float t_e = t_recover + p_star;
      x_bal = e_bal + e_resync;

      int n_felled = 0;
      float s_ref = 0.f, s_int = 0.f, s_sav = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxN; ++i) {
        if (i < n) {
          const float er = (float)exec_rem[i], age = age_f[i];
          const float t_failed = t_recover + er;
          // checkpoint plan at fa: move-ahead decided on the fa timeline
          const float n0 = timer_count(er, age, beta0, interval);
          const float wait_blk = t_failed - (er + n0 * dur);
          const float last_end = n0 > 0.0f
              ? (interval - age) + (n0 - 1.0f) * (interval + dur) + dur
              : -age;
          const float age_blk = er + n0 * dur - last_end;
          const bool plan_move = move_ahead && (age_blk > move_frac * interval)
                                 && (wait_blk > dur);
          const float move = plan_move ? 1.0f : 0.0f;

          // Algorithm 1: running argmin over the ladder (strict <)
          const float feas_rhs = t_failed * one_plus + feas_abs;
          float best_total = 0.f, best_ct = 0.f, ct_ref = 0.f, e_comp_ref = 0.f;
          int best_level = 0;
          bool best_sleeps = false, sleeps_ref = false, feasible_any = false;
#pragma unroll
          for (int f = 0; f < kMaxF; ++f) {
            if (f < nf) {
              const float n_f = f == 0 ? n0 + move
                                       : timer_count(er, age, beta[f], interval) + move;
              const float ckpt_t = n_f * dur * gamma[f];
              const float ct = er * beta[f] + ckpt_t;
              const bool feasible = ct <= feas_rhs;
              const float wt = t_failed - ct;
              const float e_comp = er * beta[f] * p_comp[f] + ckpt_t * p_ckpt[f];
              const float e_awake = maxf(wt, 0.0f) * p_awake;
              const float e_sleep = trans_e + maxf(wt - trans_t, 0.0f) * p_sleep;
              const bool sleeps = (wt > gate_t) && (e_sleep < mu2 * e_awake);
              const float total = feasible
                  ? e_comp + (sleeps ? e_sleep : e_awake) : INFINITY;
              if (f == 0) {
                ct_ref = ct; e_comp_ref = e_comp; sleeps_ref = sleeps;
                best_total = total; best_ct = ct; best_sleeps = sleeps;
                best_level = 0; feasible_any = feasible;
              } else {
                if (total < best_total) {
                  best_total = total; best_ct = ct; best_sleeps = sleeps;
                  best_level = f;
                }
                feasible_any = feasible_any || feasible;
              }
            }
          }
          const float eni = e_comp_ref + maxf(t_failed - ct_ref, 0.0f) * p_ref_wait;
          const float e_sel = feasible_any ? best_total : eni;
          const int level = feasible_any ? best_level : 0;
          const float comp_time = feasible_any ? best_ct : ct_ref;
          const bool sleeps = (feasible_any ? best_sleeps : sleeps_ref) && feasible_any;
          int action = sleeps ? kActionSleep : (active ? kActionMinFreq : 0);
          if (!feasible_any) action = 0;

          // survivor window energy + trailing fa span to T_E
          const float trail_ref = maxf(t_e - maxf(t_failed, ct_ref), 0.0f) * p_comp0;
          const float trail_int = maxf(t_e - maxf(t_failed, comp_time), 0.0f) * p_comp0;
          const float eni_t = eni + trail_ref;
          const float ei_t = e_sel + trail_int;
          const bool v2 = !m[i];
          const float w_ref = v2 ? eni_t : 0.0f;
          const float w_int = v2 ? ei_t : 0.0f;
          const float w_sav = v2 ? eni_t - ei_t : 0.0f;
          s_ref = i == 0 ? w_ref : s_ref + w_ref;
          s_int = i == 0 ? w_int : s_int + w_int;
          s_sav = i == 0 ? w_sav : s_sav + w_sav;
          if (v2) {
            npts += 1;
            nsleep += action == kActionSleep;
            nminf += action == kActionMinFreq;
            ncomp += level != 0;
            ninf += !feasible_any;
          } else {
            n_felled += 1;
          }
          // re-anchor: next rendezvous strictly past P*
          const double gap = floor_mod(p_star64 - exec_rem[i], period[i]);
          anchor[i] = gap == 0.0 ? period[i] : period[i] - gap;
          ages[i] = 0.0f;
        }
      }
      // failed node(s) over [failure, T_E], identical in both runs
      const float epoch_failed = (1.0f + (float)n_felled)
          * (t_restart * p_ckpt0 + (reexec + p_star) * p_comp0);
      x_ref = s_ref + epoch_failed;
      x_int = s_int + epoch_failed;
      x_sav = s_sav;
      x_clock = sf.d_eff;
      x_anchor = sf.d_eff + t_e + dur_fa;
      age_fail = 0.0f;
      nfail += 1;
    }
    kadd(a_bal, a_bal_c, x_bal, comp);
    kadd(a_ref, a_ref_c, x_ref, comp);
    kadd(a_int, a_int_c, x_int, comp);
    kadd(a_sav, a_sav_c, x_sav, comp);
    // the clocks stay compensated in both modes
    kadd(bal, bal_c, x_clock, true);
    kadd(t_anchor, t_anchor_c, x_anchor, true);
    alive = occurs;
  }

  // balanced tail over the remaining failure-free span
  const float span = maxf(makespan - bal, 0.0f);
  float tail = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxN; ++i) {
    if (i < n) {
      float w, ck;
      balanced_span(ages[i], span, interval, dur, w, ck);
      const float e = w * p_comp0 + ck * p_ckpt0;
      tail = i == 0 ? e : tail + e;
    }
  }
  {
    float w, ck;
    balanced_span(age_fail, span, interval, dur, w, ck);
    tail = tail + (w * p_comp0 + ck * p_ckpt0);
  }
  kadd(a_bal, a_bal_c, tail, comp);

  const size_t plane = (size_t)gridDim.y * n_runs;
  const size_t o = (size_t)p * n_runs + r;
  fstats[0 * plane + o] = a_bal + a_ref;      // energy_ref
  fstats[1 * plane + o] = a_bal + a_int;      // energy_int
  fstats[2 * plane + o] = a_sav;              // saving
  fstats[3 * plane + o] = a_bal;              // balanced_energy
  fstats[4 * plane + o] = t_anchor + span;    // end_time
  istats[0 * plane + o] = nfail;
  istats[1 * plane + o] = (alive && bal < makespan) ? 1 : 0;   // truncated
  istats[2 * plane + o] = npts;
  istats[3 * plane + o] = nsleep;
  istats[4 * plane + o] = nminf;
  istats[5 * plane + o] = ncomp;
  istats[6 * plane + o] = ninf;
}

}  // namespace

extern "C" {

// Launch on `stream` without synchronising; returns the launch's cudaError_t.
// felled may be null (no shocks).  fstats is (5, P, R) float32 and istats
// (7, P, R) int32 in the STAT_FIELDS order of ../renewal_scan.py.
int renewal_scan_launch(const float* params, const float* nodes,
                        const float* ladder, const float* gaps,
                        const float* felled, int n_lanes, int n, int nf,
                        int n_epochs, int n_runs, int compensated,
                        int32_t* valid, float* fstats, int32_t* istats,
                        void* stream) {
  if (n < 1 || n > kMaxN || nf < 1 || nf > kMaxF)
    return (int)cudaErrorInvalidValue;
  dim3 grid((n_runs + kBlock - 1) / kBlock, n_lanes);
  renewal_scan_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      params, nodes, ladder, gaps, felled, n, nf, n_epochs, n_runs,
      compensated != 0, valid, fstats, istats);
  return (int)cudaGetLastError();
}

const char* renewal_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
