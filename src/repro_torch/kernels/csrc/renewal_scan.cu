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
// Design.  A run takes G lanes of one warp, G = N or G = 1, a template
// argument beside N (1..kMaxN), chosen per launch (lanes_per_run):
//   * G = N, one lane per survivor: lane i of the group carries survivor
//     slot i (its checkpoint age, float64 rendezvous anchor, period and
//     1/period in that lane's registers) and does its sawtooth advance,
//     rendezvous wrap, checkpoint plan, ladder fold and re-anchor.  A warp
//     holds 32 / N runs (10 at the path's N = 3; the spare lanes idle).
//   * G = 1, one lane per run: the lane carries all N survivors and runs
//     them side by side (the per-survivor loops unroll).
// The failed node's sawtooth, the scalar carry (its age, the Kahan pairs
// of the clocks and of the four energy accumulators) and the cross-node
// reductions are computed identically by every lane of the group: each
// lane gathers the group's per-node values with __shfl_sync in node order
// and runs the serial fold of the one-lane case (the sums x0 + x1, then
// + x2 ...; the strict-> maxima), so the bits match the plain version's
// node-ordered _node_sum; the felled flags travel as a ballot.  Action
// counters are per lane and summed over the group at the end (integers).
// A block is 128 threads; gridDim = (ceil(R / runs per block), P).  Runs
// are the last axis of gaps (K, R), felled (K, N, R) and valid (P, K, R):
// each epoch's gap and felled flags are loaded one epoch ahead into
// registers, so the occurring epochs never wait on a global load.  A run
// stops occurring for good once its makespan ends, so
// valid[p, k, r] = k < n_failures(r): the block writes its (K x runs) tile
// of `valid` once, coalesced, after the scan.  Apart from the branches
// around rare cases (the floor-mod's fallback, each IEEE division's slow
// path), the occurring epoch's body has no data-dependent branch.
//
// Dead epochs.  Once every run of a warp has stopped occurring (__all_sync
// over the warp; lanes without a run count as dead) the warp leaves the
// epoch loop.  What is left of each run is a zero increment per remaining
// epoch into each of its six Kahan pairs.  A zero step maps (s, c) to a
// value that depends on (s, c) alone, so once one step leaves the pair
// bitwise unchanged every later one does too: kadd_zeros runs the steps
// only until that fixed point (comparing bits, so -0.0 and +0.0 differ) and
// gives the bits the remaining K - k steps would.  With c = +-0 the pair is
// fixed after at most two steps (s + (0 - c) turns s = -0 into +0); with a
// c too small to move s, after one; otherwise after a few.
//
// What bounds it.  Per occurring (epoch, survivor) point a lane does ~190
// float32 operations and moves ~7 bytes (benchmarks/failure_sweep.py counts
// them), so the function is compute-bound on paper; the byte bound of a
// launch is its valid mask.  In practice a launch is bound by one of two
// things.  While its runs are few (the main path: 6 x 4096 runs, one wave
// of groups) it is latency-bound: each run is one serial chain of epochs,
// the longest run of a warp sets the warp's pace, and the kernel ends with
// the slowest warp.  One lane per survivor shortens each epoch's chain (the
// survivors run on N lanes), puts N times the warps on the card and makes
// a warp's longest run the longest of 32 / N.  Once the runs fill the card
// (the 42-policy grid) it is throughput-bound: instructions issued per run
// decide, and one lane per run issues the per-run work once per 32 runs
// instead of once per 32 / N, with no shuffles.  lanes_per_run takes
// G = N while the launch's groups fit on the card at once, G = 1 beyond.
//
// Wide shapes.  renewal_scan_kernel<N, G> keeps every survivor of a lane in
// registers, so it is instantiated for 1..kMaxN survivors and unrolls its
// ladder to kMaxF levels.  Past either bound the shape takes
// renewal_scan_wide_kernel (up to kWideMaxN survivors and kWideMaxF levels):
// one lane per run, runtime loops over the survivors and the ladder, the
// per-survivor carry (age, float64 anchor) and the epoch's exec_rem and age
// in per-thread arrays (local memory), each survivor's period and 1/period
// in shared memory, and the felled flags as a 64-bit mask.  An epoch takes
// two passes over the survivors: the sawtooth, the wrap and the cross-node
// sums and maxima first, then the plan, Algorithm 1 and the re-anchor.  Its
// float32 operations are the one-lane case's, in the same node order, so it
// gives the same bits as the plain version too.  The shape alone picks the
// kernel.
//
// Numerics.  Built with -fmad=false and without fast-math: no
// multiply-add contraction (the Kahan steps and the closed forms
// q - j*period, exec_rem*beta + age must round as separate operations, or
// integer decision counts can flip at ct <= feas_rhs), no flush-to-zero, and
// IEEE division: the float32 divisions of advance, balanced_span and
// timer_count stay divisions, as floorf(q / period) must round as the plain
// version's does.  jnp.mod / torch.remainder is a floor-mod (the divisor's
// sign); floor_mod() takes the truncated remainder and corrects its sign,
// as the CPU's torch.remainder does.  The truncated remainder is trunc_rem:
// a quotient from the precomputed 1/b, one fma, and at most one
// correction, exact and equal to fmod (see there).  Runs whose epoch does
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
constexpr int kBlock = 128;   // threads per block: 4 warps
constexpr int kMaxN = 4;      // FAST_MAX_N in ../renewal_scan.py
constexpr int kMaxF = 4;      // FAST_MAX_F in ../renewal_scan.py
constexpr int kWideMaxN = 64; // MAX_N in ../renewal_scan.py
constexpr int kWideMaxF = 16; // MAX_F in ../renewal_scan.py
constexpr unsigned kFullMask = 0xffffffffu;
// column indices of the packed parameter row
enum Col {
  INTERVAL, DUR, REEXEC0, T_DOWN, T_RESTART, MU1, MU2, WAIT_MODE,
  P_IDLE_WAIT, MOVE_AHEAD, MOVE_FRAC, MAKESPAN, T_GO_SLEEP, T_WAKEUP,
  P_GO_SLEEP, P_WAKEUP, P_SLEEP
};
constexpr int kWaitActive = 0;          // WaitMode.ACTIVE
constexpr int kActionMinFreq = 1;       // WaitAction.MIN_FREQ
constexpr int kActionSleep = 2;         // WaitAction.SLEEP

// fmod(a, b), the exact truncated remainder, without its long software
// loop.  q = trunc(a * inv_b) (inv_b = 1/b rounded) is within one of the
// true quotient trunc(a / b) while |q| < 2^51: the product's relative error
// is below 2^-51.9, so its absolute error stays under 0.55.  With q exact,
// a - q*b is exactly representable (|a - q*b| < |b| and it is a multiple of
// the smaller ulp of a and b), so one fma gives it without rounding.  If q
// was one too far from zero the fma's result has the wrong sign (the exact
// value lies in [-|b|, 0) for a >= 0 and rounds to a nonzero value of that
// sign); if one short, it is >= |b| in magnitude (b is representable, so
// rounding cannot carry it below).  Either way one step of q and one more
// fma give the exact remainder.  A zero takes a's sign, as fmod's does.
// Beyond 2^51, for infinite b, and for NaN, fmod itself runs.  That branch
// is never taken on the path: |a| is at most a makespan plus a period
// (~3e6 s) and b a rendezvous period of seconds to hours, so |q| < 2^22.
__device__ __forceinline__ double trunc_rem(double a, double b, double inv_b) {
  const double q0 = trunc(a * inv_b);
  if (!(fabs(q0) < 0x1p51) || isinf(b)) return fmod(a, b);
  // the correction is selected, not branched on: the second fma always
  // runs (it repeats the first where q0 was right)
  const double r0 = fma(-q0, b, a);
  const double step = (a >= 0.0) == (b > 0.0) ? 1.0 : -1.0;
  const bool q_far = a >= 0.0 ? r0 < 0.0 : r0 > 0.0;    // one too far
  const bool q_short = !q_far && fabs(r0) >= fabs(b);   // one short
  const double q = q_far ? q0 - step : (q_short ? q0 + step : q0);
  const double r = fma(-q, b, a);
  return r == 0.0 ? copysign(0.0, a) : r;
}

// floor-mod (the divisor's sign), as torch.remainder
__device__ __forceinline__ double floor_mod(double a, double b, double inv_b) {
  double r = trunc_rem(a, b, inv_b);
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

// `steps` zero increments into (s, c), stopped at the pair's bitwise fixed
// point (the argument is in the header)
__device__ __forceinline__ void kadd_zeros(float& s, float& c, int steps,
                                           bool comp) {
  for (int j = 0; j < steps; ++j) {
    const unsigned s0 = __float_as_uint(s), c0 = __float_as_uint(c);
    kadd(s, c, 0.0f, comp);
    if (__float_as_uint(s) == s0 && __float_as_uint(c) == c0) break;
  }
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

// The lanes of one run: G of them from lane `base` (G = N: one survivor
// per lane; G = 1: one lane holds all N).  get(x, owner) is the value x of
// lane `owner` of the group, in every lane of it.
template <int G>
struct Group {
  unsigned mask;
  int base;
  template <class T>
  __device__ __forceinline__ T get(T x, int owner) const {
    if constexpr (G == 1) return x;
    else return __shfl_sync(mask, x, base + owner);
  }
  // x0 + x1 + ... over the run's survivors in node order (the plain
  // version's _node_sum); survivor i is slot i / G of lane i % G
  template <int N>
  __device__ __forceinline__ float node_sum(const float (&x)[N / G]) const {
    float s = get(x[0], 0);
#pragma unroll
    for (int i = 1; i < N; ++i) s = s + get(x[i / G], i % G);
    return s;
  }
  // x summed over the group's lanes (integers: any order)
  __device__ __forceinline__ int lane_sum(int x) const {
    int s = get(x, 0);
#pragma unroll
    for (int j = 1; j < G; ++j) s += get(x, j);
    return s;
  }
};

template <int N, int G>
__global__ void __launch_bounds__(kBlock)
renewal_scan_kernel(const float* __restrict__ params,
                    const float* __restrict__ nodes,
                    const float* __restrict__ ladder,
                    const float* __restrict__ gaps,
                    const float* __restrict__ felled,
                    int nf, int n_epochs, int n_runs, bool comp,
                    int32_t* __restrict__ valid,
                    float* __restrict__ fstats,
                    int32_t* __restrict__ istats) {
  constexpr int NL = N / G;                            // survivors per lane
  constexpr int kGroups = 32 / G;                      // runs per warp
  constexpr int kRunsPerBlock = kGroups * (kBlock / 32);
  static_assert(G == 1 || G == N, "a run takes one lane or one per survivor");
  __shared__ float s_par[kParams];
  __shared__ float s_node[3][N];
  __shared__ float s_lad[5][kMaxF];
  __shared__ int s_nfail[kRunsPerBlock];
  const int p = blockIdx.y;
  for (int i = threadIdx.x; i < kParams; i += blockDim.x)
    s_par[i] = params[p * kParams + i];
  for (int i = threadIdx.x; i < 3 * N; i += blockDim.x)
    s_node[i / N][i % N] = nodes[p * 3 * N + i];
  for (int i = threadIdx.x; i < 5 * nf; i += blockDim.x)
    s_lad[i / nf][i % nf] = ladder[p * 5 * nf + i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int grp = lane / G;                 // run within the warp
  const int node0 = lane - grp * G;         // first survivor of this lane
  Group<G> g;
  g.base = grp * G;
  g.mask = ((1u << G) - 1u) << g.base;
  const int block_r0 = blockIdx.x * kRunsPerBlock;
  const int slot = (threadIdx.x >> 5) * kGroups + grp;   // run within block
  const int r = block_r0 + slot;
  // lanes past the last group of a warp, and groups past R, hold no run:
  // they count as dead from the start and never shuffle
  const bool has_run = grp < kGroups && r < n_runs;

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
  const float e_resync = (float)(N + 1) * dur_fa * p_ckpt0;

  // carry: this lane's survivors (anchors and wraps in float64) ...
  float age[NL];
  double anchor[NL], period[NL], inv_period[NL];
#pragma unroll
  for (int s = 0; s < NL; ++s) {
    const int i = node0 + G * s;
    age[s] = s_node[0][i];
    anchor[s] = (double)s_node[1][i];
    period[s] = (double)s_node[2][i];
    inv_period[s] = 1.0 / period[s];
  }
  // ... and the run's scalars, the same in every lane of the group
  float age_fail = s_par[REEXEC0];
  float bal = 0.f, bal_c = 0.f, t_anchor = 0.f, t_anchor_c = 0.f;
  float a_bal = 0.f, a_bal_c = 0.f, a_ref = 0.f, a_ref_c = 0.f;
  float a_int = 0.f, a_int_c = 0.f, a_sav = 0.f, a_sav_c = 0.f;
  int nfail = 0;
  int npts = 0, nsleep = 0, nminf = 0, ncomp = 0, ninf = 0;   // this lane's
  bool alive = has_run;

  // epoch k's operands, loaded during epoch k - 1
  float delta_next = has_run ? gaps[r] : 0.f;
  float fel_next[NL];
#pragma unroll
  for (int s = 0; s < NL; ++s)
    fel_next[s] = has_run && felled != nullptr
        ? felled[(size_t)(node0 + G * s) * n_runs + r] : 0.f;

  int k = 0;
  for (; k < n_epochs; ++k) {
    if (__all_sync(kFullMask, !alive)) break;
    const float delta = delta_next;
    bool m[NL];
#pragma unroll
    for (int s = 0; s < NL; ++s) m[s] = fel_next[s] > 0.5f;
    const bool occurs = alive && (bal + delta <= makespan);
    if (occurs && k + 1 < n_epochs) {
      delta_next = gaps[(size_t)(k + 1) * n_runs + r];
      if (felled != nullptr) {
#pragma unroll
        for (int s = 0; s < NL; ++s)
          fel_next[s] = felled[((size_t)(k + 1) * N + node0 + G * s) * n_runs + r];
      }
    }
    float x_bal = 0.f, x_ref = 0.f, x_int = 0.f, x_sav = 0.f;
    float x_clock = 0.f, x_anchor = 0.f;
    if (occurs) {   // the same in every lane of the group
      // geometry: the failed node in every lane, and this lane's survivors.
      // The body is kept free of data-dependent branches (the floor-mod's
      // correction and the ladder's levels are selected), so the compiler
      // can interleave its independent chains.
      const Sawtooth sf = advance(age_fail, delta, interval, dur);
      float age_f[NL], e_node[NL];
      double exec_rem[NL];
      unsigned fel_bits = 0u;
#pragma unroll
      for (int s = 0; s < NL; ++s) {
        const Sawtooth sv = advance(age[s], delta, interval, dur);
        const double rem = floor_mod(anchor[s] - (double)sv.work, period[s],
                                     inv_period[s]);
        exec_rem[s] = rem == 0.0 ? period[s] : rem;
        age_f[s] = sv.age;
        e_node[s] = sv.work * p_comp0 + (sv.d_eff - sv.work) * p_ckpt0;
        if constexpr (G == 1) fel_bits |= (unsigned)m[s] << s;
      }
      if constexpr (G != 1) fel_bits = __ballot_sync(g.mask, m[0]) >> g.base;
      // cross-node reductions, in node order, in every lane of the group
      const float e_bal = g.template node_sum<N>(e_node);
      float reexec_fel = -INFINITY;
      double p_star64 = -INFINITY;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const double er_i = g.get(exec_rem[i / G], i % G);
        if (!((fel_bits >> i) & 1u) && er_i > p_star64) p_star64 = er_i;
      }
      if (felled != nullptr) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float age_i = g.get(age_f[i / G], i % G);
          if ((fel_bits >> i) & 1u) reexec_fel = maxf(reexec_fel, age_i);
        }
      }
      const float reexec = maxf(sf.age, reexec_fel);
      if (!(p_star64 > 0.0)) p_star64 = 0.0;
      const float p_star = (float)p_star64;
      // re-anchor: next rendezvous strictly past P*
#pragma unroll
      for (int s = 0; s < NL; ++s) {
        const double gap = floor_mod(p_star64 - exec_rem[s], period[s],
                                     inv_period[s]);
        anchor[s] = gap == 0.0 ? period[s] : period[s] - gap;
        age[s] = 0.0f;
      }
      const float t_recover = t_dr + reexec;
      const float t_e = t_recover + p_star;
      x_bal = (e_bal + (sf.work * p_comp0 + (sf.d_eff - sf.work) * p_ckpt0))
              + e_resync;

      float w_ref[NL], w_int[NL], w_sav[NL];
#pragma unroll
      for (int s = 0; s < NL; ++s) {
        // survivor s of this lane: checkpoint plan at fa, then Algorithm 1
        const float er = (float)exec_rem[s], af = age_f[s];
        const float t_failed = t_recover + er;
        const float n0 = timer_count(er, af, beta0, interval);
        const float wait_blk = t_failed - (er + n0 * dur);
        const float last_end = n0 > 0.0f
            ? (interval - af) + (n0 - 1.0f) * (interval + dur) + dur
            : -af;
        const float age_blk = er + n0 * dur - last_end;
        const bool plan_move = move_ahead && (age_blk > move_frac * interval)
                               && (wait_blk > dur);
        const float move = plan_move ? 1.0f : 0.0f;

        // running argmin over the ladder (strict <), level 0 the reference.
        // Levels past nf repeat level nf - 1 and are never taken, so the
        // loop is straight-line code whatever nf is.
        const float feas_rhs = t_failed * one_plus + feas_abs;
        float best_total = 0.f, best_ct = 0.f, ct_ref = 0.f, e_comp_ref = 0.f;
        int best_level = 0;
        bool best_sleeps = false, sleeps_ref = false, feasible_any = false;
#pragma unroll
        for (int f = 0; f < kMaxF; ++f) {
          const bool level = f < nf;
          const int fl = level ? f : nf - 1;
          const float n_f = f == 0 ? n0 + move
                                   : timer_count(er, af, beta[fl], interval) + move;
          const float ckpt_t = n_f * dur * gamma[fl];
          const float ct = er * beta[fl] + ckpt_t;
          const bool feasible = ct <= feas_rhs;
          const float wt = t_failed - ct;
          const float e_comp = er * beta[fl] * p_comp[fl] + ckpt_t * p_ckpt[fl];
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
            if (level && total < best_total) {
              best_total = total; best_ct = ct; best_sleeps = sleeps;
              best_level = f;
            }
            feasible_any = feasible_any || (level && feasible);
          }
        }
        const float eni = e_comp_ref + maxf(t_failed - ct_ref, 0.0f) * p_ref_wait;
        const float e_sel = feasible_any ? best_total : eni;
        const int level_sel = feasible_any ? best_level : 0;
        const float comp_time = feasible_any ? best_ct : ct_ref;
        const bool sleeps = (feasible_any ? best_sleeps : sleeps_ref) && feasible_any;
        int action = sleeps ? kActionSleep : (active ? kActionMinFreq : 0);
        if (!feasible_any) action = 0;

        // survivor window energy + trailing fa span to T_E
        const float trail_ref = maxf(t_e - maxf(t_failed, ct_ref), 0.0f) * p_comp0;
        const float trail_int = maxf(t_e - maxf(t_failed, comp_time), 0.0f) * p_comp0;
        const float eni_t = eni + trail_ref;
        const float ei_t = e_sel + trail_int;
        const bool v2 = !m[s];
        w_ref[s] = v2 ? eni_t : 0.0f;
        w_int[s] = v2 ? ei_t : 0.0f;
        w_sav[s] = v2 ? eni_t - ei_t : 0.0f;
        if (v2) {
          npts += 1;
          nsleep += action == kActionSleep;
          nminf += action == kActionMinFreq;
          ncomp += level_sel != 0;
          ninf += !feasible_any;
        }
      }
      // failed node(s) over [failure, T_E], identical in both runs
      const float epoch_failed = (1.0f + (float)__popc(fel_bits))
          * (t_restart * p_ckpt0 + (reexec + p_star) * p_comp0);
      x_ref = g.template node_sum<N>(w_ref) + epoch_failed;
      x_int = g.template node_sum<N>(w_int) + epoch_failed;
      x_sav = g.template node_sum<N>(w_sav);
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
  // epochs k..K-1 occur in no run of this warp: zero increments only
  const int rest = n_epochs - k;
  kadd_zeros(a_bal, a_bal_c, rest, comp);
  kadd_zeros(a_ref, a_ref_c, rest, comp);
  kadd_zeros(a_int, a_int_c, rest, comp);
  kadd_zeros(a_sav, a_sav_c, rest, comp);
  kadd_zeros(bal, bal_c, rest, true);
  kadd_zeros(t_anchor, t_anchor_c, rest, true);

  if (has_run) {
    // balanced tail over the remaining failure-free span
    const float span = maxf(makespan - bal, 0.0f);
    float w, ck, e_tail[NL];
#pragma unroll
    for (int s = 0; s < NL; ++s) {
      balanced_span(age[s], span, interval, dur, w, ck);
      e_tail[s] = w * p_comp0 + ck * p_ckpt0;
    }
    float tail = g.template node_sum<N>(e_tail);
    balanced_span(age_fail, span, interval, dur, w, ck);
    tail = tail + (w * p_comp0 + ck * p_ckpt0);
    kadd(a_bal, a_bal_c, tail, comp);
    npts = g.lane_sum(npts);
    nsleep = g.lane_sum(nsleep);
    nminf = g.lane_sum(nminf);
    ncomp = g.lane_sum(ncomp);
    ninf = g.lane_sum(ninf);

    if (node0 == 0) {
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
      s_nfail[slot] = nfail;
    }
  }

  // the block's valid tile, row by row: valid[p, k, r] = k < n_failures(r)
  __syncthreads();
  const int runs = min(kRunsPerBlock, n_runs - block_r0);
  int32_t* valid_p = valid + (size_t)p * n_epochs * n_runs + block_r0;
  for (int i = threadIdx.x; i < n_epochs * runs; i += kBlock) {
    const int kk = i / runs, j = i - kk * runs;
    valid_p[(size_t)kk * n_runs + j] = kk < s_nfail[j] ? 1 : 0;
  }
}

// The wide shapes' kernel: one lane per run, n survivors and nf ladder
// levels at run time (see the header).  Every float32 expression is the
// one-lane case's of renewal_scan_kernel, in its order.
__global__ void __launch_bounds__(kBlock)
renewal_scan_wide_kernel(const float* __restrict__ params,
                         const float* __restrict__ nodes,
                         const float* __restrict__ ladder,
                         const float* __restrict__ gaps,
                         const float* __restrict__ felled,
                         int n, int nf, int n_epochs, int n_runs, bool comp,
                         int32_t* __restrict__ valid,
                         float* __restrict__ fstats,
                         int32_t* __restrict__ istats) {
  __shared__ float s_par[kParams];
  __shared__ float s_age0[kWideMaxN];
  __shared__ double s_exec0[kWideMaxN], s_period[kWideMaxN], s_inv[kWideMaxN];
  __shared__ float s_lad[5][kWideMaxF];
  __shared__ int s_nfail[kBlock];
  const int p = blockIdx.y;
  for (int i = threadIdx.x; i < kParams; i += blockDim.x)
    s_par[i] = params[p * kParams + i];
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float* nd = nodes + (size_t)p * 3 * n;
    s_age0[i] = nd[i];
    s_exec0[i] = (double)nd[n + i];
    s_period[i] = (double)nd[2 * n + i];
    s_inv[i] = 1.0 / s_period[i];
  }
  for (int i = threadIdx.x; i < 5 * nf; i += blockDim.x)
    s_lad[i / nf][i % nf] = ladder[(size_t)p * 5 * nf + i];
  __syncthreads();

  const int block_r0 = blockIdx.x * kBlock;
  const int r = block_r0 + threadIdx.x;
  const bool has_run = r < n_runs;

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

  // the run's carry and the epoch's per-survivor values
  float age[kWideMaxN], age_f[kWideMaxN];
  double anchor[kWideMaxN], exec_rem[kWideMaxN];
  for (int i = 0; i < n; ++i) {
    age[i] = s_age0[i];
    anchor[i] = s_exec0[i];
  }
  float age_fail = s_par[REEXEC0];
  float bal = 0.f, bal_c = 0.f, t_anchor = 0.f, t_anchor_c = 0.f;
  float a_bal = 0.f, a_bal_c = 0.f, a_ref = 0.f, a_ref_c = 0.f;
  float a_int = 0.f, a_int_c = 0.f, a_sav = 0.f, a_sav_c = 0.f;
  int nfail = 0, npts = 0, nsleep = 0, nminf = 0, ncomp = 0, ninf = 0;
  bool alive = has_run;

  int k = 0;
  for (; k < n_epochs; ++k) {
    if (__all_sync(kFullMask, !alive)) break;
    const float delta = alive ? gaps[(size_t)k * n_runs + r] : 0.f;
    const bool occurs = alive && (bal + delta <= makespan);
    float x_bal = 0.f, x_ref = 0.f, x_int = 0.f, x_sav = 0.f;
    float x_clock = 0.f, x_anchor = 0.f;
    if (occurs) {
      uint64_t fel = 0u;
      if (felled != nullptr) {
        for (int i = 0; i < n; ++i)
          fel |= (uint64_t)(felled[((size_t)k * n + i) * n_runs + r] > 0.5f) << i;
      }
      // pass 1: sawtooth and wrap per survivor; the cross-node sums and
      // maxima in node order
      const Sawtooth sf = advance(age_fail, delta, interval, dur);
      float e_bal = 0.f, reexec_fel = -INFINITY;
      double p_star64 = -INFINITY;
      for (int i = 0; i < n; ++i) {
        const Sawtooth sv = advance(age[i], delta, interval, dur);
        const double rem = floor_mod(anchor[i] - (double)sv.work, s_period[i],
                                     s_inv[i]);
        const double er = rem == 0.0 ? s_period[i] : rem;
        exec_rem[i] = er;
        age_f[i] = sv.age;
        const float e_node = sv.work * p_comp0 + (sv.d_eff - sv.work) * p_ckpt0;
        e_bal = i == 0 ? e_node : e_bal + e_node;
        const bool fel_i = (fel >> i) & 1u;
        if (!fel_i && er > p_star64) p_star64 = er;
        if (fel_i) reexec_fel = maxf(reexec_fel, sv.age);
      }
      const float reexec = maxf(sf.age, reexec_fel);
      if (!(p_star64 > 0.0)) p_star64 = 0.0;
      const float p_star = (float)p_star64;
      const float t_recover = t_dr + reexec;
      const float t_e = t_recover + p_star;
      x_bal = (e_bal + (sf.work * p_comp0 + (sf.d_eff - sf.work) * p_ckpt0))
              + e_resync;

      // pass 2: checkpoint plan, Algorithm 1 and re-anchor per survivor
      float s_ref = 0.f, s_int = 0.f, s_sav = 0.f;
      for (int i = 0; i < n; ++i) {
        const float er = (float)exec_rem[i], af = age_f[i];
        const float t_failed = t_recover + er;
        const float n0 = timer_count(er, af, beta0, interval);
        const float wait_blk = t_failed - (er + n0 * dur);
        const float last_end = n0 > 0.0f
            ? (interval - af) + (n0 - 1.0f) * (interval + dur) + dur
            : -af;
        const float age_blk = er + n0 * dur - last_end;
        const bool plan_move = move_ahead && (age_blk > move_frac * interval)
                               && (wait_blk > dur);
        const float move = plan_move ? 1.0f : 0.0f;

        const float feas_rhs = t_failed * one_plus + feas_abs;
        float best_total = 0.f, best_ct = 0.f, ct_ref = 0.f, e_comp_ref = 0.f;
        int best_level = 0;
        bool best_sleeps = false, sleeps_ref = false, feasible_any = false;
        for (int f = 0; f < nf; ++f) {
          const float n_f = f == 0 ? n0 + move
                                   : timer_count(er, af, beta[f], interval) + move;
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
        const float eni = e_comp_ref + maxf(t_failed - ct_ref, 0.0f) * p_ref_wait;
        const float e_sel = feasible_any ? best_total : eni;
        const int level_sel = feasible_any ? best_level : 0;
        const float comp_time = feasible_any ? best_ct : ct_ref;
        const bool sleeps = (feasible_any ? best_sleeps : sleeps_ref) && feasible_any;
        int action = sleeps ? kActionSleep : (active ? kActionMinFreq : 0);
        if (!feasible_any) action = 0;

        const float trail_ref = maxf(t_e - maxf(t_failed, ct_ref), 0.0f) * p_comp0;
        const float trail_int = maxf(t_e - maxf(t_failed, comp_time), 0.0f) * p_comp0;
        const float eni_t = eni + trail_ref;
        const float ei_t = e_sel + trail_int;
        const bool v2 = !((fel >> i) & 1u);
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
          ncomp += level_sel != 0;
          ninf += !feasible_any;
        }
        // re-anchor: next rendezvous strictly past P*
        const double gap = floor_mod(p_star64 - exec_rem[i], s_period[i],
                                     s_inv[i]);
        anchor[i] = gap == 0.0 ? s_period[i] : s_period[i] - gap;
        age[i] = 0.0f;
      }
      const float epoch_failed = (1.0f + (float)__popcll(fel))
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
    kadd(bal, bal_c, x_clock, true);
    kadd(t_anchor, t_anchor_c, x_anchor, true);
    alive = occurs;
  }
  const int rest = n_epochs - k;
  kadd_zeros(a_bal, a_bal_c, rest, comp);
  kadd_zeros(a_ref, a_ref_c, rest, comp);
  kadd_zeros(a_int, a_int_c, rest, comp);
  kadd_zeros(a_sav, a_sav_c, rest, comp);
  kadd_zeros(bal, bal_c, rest, true);
  kadd_zeros(t_anchor, t_anchor_c, rest, true);

  if (has_run) {
    const float span = maxf(makespan - bal, 0.0f);
    float w, ck, tail = 0.f;
    for (int i = 0; i < n; ++i) {
      balanced_span(age[i], span, interval, dur, w, ck);
      const float e_tail = w * p_comp0 + ck * p_ckpt0;
      tail = i == 0 ? e_tail : tail + e_tail;
    }
    balanced_span(age_fail, span, interval, dur, w, ck);
    tail = tail + (w * p_comp0 + ck * p_ckpt0);
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
    s_nfail[threadIdx.x] = nfail;
  }

  // the block's valid tile, row by row: valid[p, k, r] = k < n_failures(r)
  __syncthreads();
  const int runs = min(kBlock, n_runs - block_r0);
  int32_t* valid_p = valid + (size_t)p * n_epochs * n_runs + block_r0;
  for (int i = threadIdx.x; i < n_epochs * runs; i += kBlock) {
    const int kk = i / runs, j = i - kk * runs;
    valid_p[(size_t)kk * n_runs + j] = kk < s_nfail[j] ? 1 : 0;
  }
}

template <int N, int G>
int launch(const float* params, const float* nodes, const float* ladder,
           const float* gaps, const float* felled, int n_lanes, int nf,
           int n_epochs, int n_runs, bool comp, int32_t* valid,
           float* fstats, int32_t* istats, cudaStream_t stream) {
  constexpr int kRunsPerBlock = (32 / G) * (kBlock / 32);
  dim3 grid((n_runs + kRunsPerBlock - 1) / kRunsPerBlock, n_lanes);
  renewal_scan_kernel<N, G><<<grid, kBlock, 0, stream>>>(
      params, nodes, ladder, gaps, felled, nf, n_epochs, n_runs, comp,
      valid, fstats, istats);
  return (int)cudaGetLastError();
}

// G = N where `per_survivor` (N = 1 has only G = 1)
template <int N>
int launch_n(bool per_survivor, const float* params, const float* nodes,
             const float* ladder, const float* gaps, const float* felled,
             int n_lanes, int nf, int n_epochs, int n_runs, bool comp,
             int32_t* valid, float* fstats, int32_t* istats, cudaStream_t s) {
  if constexpr (N > 1) {
    if (per_survivor)
      return launch<N, N>(params, nodes, ladder, gaps, felled, n_lanes, nf,
                          n_epochs, n_runs, comp, valid, fstats, istats, s);
  }
  return launch<N, 1>(params, nodes, ladder, gaps, felled, n_lanes, nf,
                      n_epochs, n_runs, comp, valid, fstats, istats, s);
}

template <int N>
const void* kernel_ptr(bool per_survivor) {
  if constexpr (N > 1) {
    if (per_survivor) return (const void*)renewal_scan_kernel<N, N>;
  }
  return (const void*)renewal_scan_kernel<N, 1>;
}

const void* kernel_for(int n, bool per_survivor) {
  switch (n) {
    case 1: return kernel_ptr<1>(per_survivor);
    case 2: return kernel_ptr<2>(per_survivor);
    case 3: return kernel_ptr<3>(per_survivor);
    case 4: return kernel_ptr<4>(per_survivor);
    default: return nullptr;
  }
}

// the shape picks the kernel: renewal_scan_kernel<N, G> within its
// compile-time bounds, the wide kernel beyond them
bool fast_shape(int n, int nf) {
  return n >= 1 && n <= kMaxN && nf >= 1 && nf <= kMaxF;
}

bool wide_shape(int n, int nf) {
  return n >= 1 && n <= kWideMaxN && nf >= 1 && nf <= kWideMaxF;
}

int launch_wide(const float* params, const float* nodes, const float* ladder,
                const float* gaps, const float* felled, int n_lanes, int n,
                int nf, int n_epochs, int n_runs, int compensated,
                int32_t* valid, float* fstats, int32_t* istats, void* stream) {
  dim3 grid((n_runs + kBlock - 1) / kBlock, n_lanes);
  renewal_scan_wide_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      params, nodes, ladder, gaps, felled, n, nf, n_epochs, n_runs,
      compensated != 0, valid, fstats, istats);
  return (int)cudaGetLastError();
}

// Lanes per run for a launch of runs_total runs: one lane per survivor
// while all the groups fit on the card at once (the launch is then
// latency-bound: the group shortens each run's chain and multiplies the
// resident warps), one lane per run beyond (the launch is then
// throughput-bound, and a group would pay for its shuffles and its
// redundant per-run work).  The two mappings give the same bits, so the
// choice (and its per-device cache) bears on speed only.
int lanes_per_run(int n, long long runs_total) {
  static int cached_device = -1, slots[kMaxN + 1] = {};
  if (n < 1 || n > kMaxN) return 1;        // wide shapes: one lane per run
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return n;
  if (dev != cached_device) {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      return n;
    for (int i = 1; i <= kMaxN; ++i) {
      int blocks = 0;
      if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &blocks, kernel_for(i, true), kBlock, 0) != cudaSuccess)
        return n;
      slots[i] = sms * blocks * kBlock;   // threads of one wave
    }
    cached_device = dev;
  }
  return runs_total * n <= slots[n] ? n : 1;
}

int launch_mapped(const float* params, const float* nodes, const float* ladder,
                  const float* gaps, const float* felled, int n_lanes, int n,
                  int nf, int n_epochs, int n_runs, int compensated,
                  int32_t* valid, float* fstats, int32_t* istats, void* stream,
                  int lanes) {
  if (n < 1 || n > kMaxN || nf < 1 || nf > kMaxF || (lanes != 1 && lanes != n))
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const bool comp = compensated != 0, per = lanes == n;
  switch (n) {
    case 1: return launch_n<1>(per, params, nodes, ladder, gaps, felled,
                               n_lanes, nf, n_epochs, n_runs, comp, valid,
                               fstats, istats, s);
    case 2: return launch_n<2>(per, params, nodes, ladder, gaps, felled,
                               n_lanes, nf, n_epochs, n_runs, comp, valid,
                               fstats, istats, s);
    case 3: return launch_n<3>(per, params, nodes, ladder, gaps, felled,
                               n_lanes, nf, n_epochs, n_runs, comp, valid,
                               fstats, istats, s);
    default: return launch_n<4>(per, params, nodes, ladder, gaps, felled,
                                n_lanes, nf, n_epochs, n_runs, comp, valid,
                                fstats, istats, s);
  }
}

}  // namespace

extern "C" {

// Launch on `stream` without synchronising; returns the launch's cudaError_t.
// felled may be null (no shocks).  fstats is (5, P, R) float32 and istats
// (7, P, R) int32 in the STAT_FIELDS order of ../renewal_scan.py.  Shapes
// within kMaxN survivors and kMaxF levels run renewal_scan_kernel<N, G>
// with the mapping (lanes per run) of lanes_per_run(); wider shapes, up to
// kWideMaxN and kWideMaxF, the wide kernel.
int renewal_scan_launch(const float* params, const float* nodes,
                        const float* ladder, const float* gaps,
                        const float* felled, int n_lanes, int n, int nf,
                        int n_epochs, int n_runs, int compensated,
                        int32_t* valid, float* fstats, int32_t* istats,
                        void* stream) {
  if (!wide_shape(n, nf)) return (int)cudaErrorInvalidValue;
  if (!fast_shape(n, nf))
    return launch_wide(params, nodes, ladder, gaps, felled, n_lanes, n, nf,
                       n_epochs, n_runs, compensated, valid, fstats, istats,
                       stream);
  return launch_mapped(params, nodes, ladder, gaps, felled, n_lanes, n, nf,
                       n_epochs, n_runs, compensated, valid, fstats, istats,
                       stream, lanes_per_run(n, (long long)n_lanes * n_runs));
}

// The same with the lanes per run given (1 or n): for measuring the two
// mappings against each other.  Wide shapes take only lanes = 1.
int renewal_scan_launch_lanes(const float* params, const float* nodes,
                              const float* ladder, const float* gaps,
                              const float* felled, int n_lanes, int n, int nf,
                              int n_epochs, int n_runs, int compensated,
                              int32_t* valid, float* fstats, int32_t* istats,
                              void* stream, int lanes) {
  if (!fast_shape(n, nf)) {
    if (!wide_shape(n, nf) || lanes != 1) return (int)cudaErrorInvalidValue;
    return launch_wide(params, nodes, ladder, gaps, felled, n_lanes, n, nf,
                       n_epochs, n_runs, compensated, valid, fstats, istats,
                       stream);
  }
  return launch_mapped(params, nodes, ladder, gaps, felled, n_lanes, n, nf,
                       n_epochs, n_runs, compensated, valid, fstats, istats,
                       stream, lanes);
}

// Resident blocks per SM of the kernel for N survivors and `lanes` lanes
// per run (1 or N), as CUDA's occupancy calculator derives them from its
// registers and static shared memory, with its threads per block and the
// runs a block holds.  N past kMaxN (lanes = 1) is the wide kernel.
int renewal_scan_occupancy(int n, int lanes, int* blocks, int* threads,
                           int* runs_per_block) {
  if (lanes != 1 && lanes != n) return (int)cudaErrorInvalidValue;
  const void* fn = n > kMaxN && n <= kWideMaxN && lanes == 1
      ? (const void*)renewal_scan_wide_kernel : kernel_for(n, lanes == n);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  *threads = kBlock;
  *runs_per_block = (32 / lanes) * (kBlock / 32);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kBlock, 0);
}

// The lanes per run renewal_scan_launch takes for n_lanes x n_runs runs of
// N survivors on the current device, at ladder depths up to kMaxF (the wide
// kernel, past kMaxN survivors or kMaxF levels, takes one).
int renewal_scan_lanes_per_run(int n, int n_lanes, int n_runs) {
  if (n < 1 || n > kWideMaxN) return -1;
  return lanes_per_run(n, (long long)n_lanes * n_runs);
}

const char* renewal_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
