// Causal GQA flash attention (optional sliding window) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_bhsd / _kernel).  Operands are in kernel layout:
// q (BH, Sq, D) pre-scaled by D**-0.5, k and v (BK, Sk, D) with
// BK = BH / group, float32 or bfloat16; the output is (BH, Sq, D) in q's
// type.  Softmax, sums and the final division are float32.  The plain
// PyTorch version of the same function is flash_attention_reference in
// ../flash_attention.py.
//
// Shared design.  The TPU kernel walks the key blocks as the innermost,
// sequential grid axis and keeps the online-softmax state (m, l, acc) in
// VMEM scratch between grid steps.  Blocks of a CUDA grid run in no order,
// so here one block owns 64 query rows of one (batch, head) and walks the
// key blocks (64 keys; 32 in bf16 at D = 256) in a loop inside the program:
// gridDim = (BH, ceil(Sq / 64)).  The KV head is bh / group, as the TPU kernel's
// index_map.  Key blocks that every row of the tile masks are not visited
// (the TPU kernel's pl.when skip); a ragged tail (Sq or Sk not a multiple
// of the block) is masked here, so the kernel takes every length.  Masked scores
// are -1e30, not -inf: a row that a visited block masks whole takes exp(0)
// terms while its running max is still -1e30, and the first block with a
// real key rescales them by alpha = exp(-1e30 - m) = 0, where -inf would
// make NaN.  The final division is by max(l, 1e-30).  Rows and keys past
// Sq / Sk load as 0, so such terms never carry NaN.
//
// The dtype picks the kernel at the C entry point (never a failure):
//
// bfloat16: flash_mma_kernel, FlashAttention-2 on the tensor cores.  Four
// warps, each owning 16 query rows; Q, K and V stay bf16 in shared memory
// and arrive by 16-byte cp.async, K and V in a double-buffered ring so that
// key block j+1 loads while block j computes.  Rows are padded by 16 bytes
// (D + 8 elements): every row starts 16-byte aligned and the eight row
// addresses of each ldmatrix phase fall in distinct banks.  S = Q K^T is
// mma.sync m16n8k16 bf16 -> float32 (D/16 k-steps, 8 key tiles of 8 per
// warp); Q's fragments stay in registers for D <= 128 and are re-read from
// shared memory per k-step for D = 256.  The online softmax
// runs on the accumulator fragments in the base-2 domain (scores times
// log2 e, exp2f): each row lives in the four lanes of a quad, so its max
// takes two xor shuffles; l is kept per lane from the float32 P and summed
// over the quad at the end.  O += P V feeds the S fragments straight back
// as the A operand, rounded P = P_hi + P_lo (mma_sm90.cuh split_bf16) and
// issued as two mma.sync against the same V fragment (ldmatrix.trans).
// One bf16 rounding of P would miss the bar against the plain version
// (which keeps P in float32, as the TPU kernel does); V is bf16 already,
// so the split costs one extra product and no extra load.  The output is
// staged in shared memory and written as 16-byte rows.
//
// float32: flash_kernel, the CUDA-core kernel of the first port, kept as
// it was: tensor-core TF32 would miss the 2e-5 float32 bar, and float32
// attention serves the decode check, not the prefill.  256 threads as a
// 16 x 16 grid; thread (ty, tx) owns 4 query rows, a 4 x 4 block of the
// 64 x 64 score tile and a 4 x D/16 block of the accumulator in registers;
// K/V tiles in padded shared memory.
//
// What bounds it.  At zamba2-7b's prefill (BH = 64, S = 4096, D = 112,
// bf16) the function needs ~2.4e11 flop against ~235 MB of operands, so it
// is bound by the tensor cores (~0.24 ms at 989 TFLOP/s).  The bf16 kernel
// issues 1.5x that work (the P split) through mma.sync, which reaches a
// fraction of wgmma's rate; wgmma with a 64-row warpgroup tile, TMA and
// warp specialisation are what would close the rest.
//
// Resources (ptxas for sm_90a and CUDA's occupancy calculator, printed by
// chip_smoke.py's [build] and [occupancy] lines; table in PERF.md): at
// D = 112 the bf16 kernel takes 175 registers with no spills and 61,440 B
// of shared memory (two ring stages of 64-key K and V tiles of 240-byte
// rows; Q is staged in stage 1 before the loop), so 2 blocks (8 warps)
// are resident per SM, bound by registers (3 would fit by shared memory).
//
// Built without -fmad=false (contraction allowed) and without fast-math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per step of the float32 kernel's loop
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows

template <int D>
struct MmaLayout {
  static constexpr int RS = D + 8;          // row stride (bf16 elements)
  // keys per block of the loop; at D = 256 the accumulator alone is 128
  // registers, and 32 keys keep S to 16 more
  static constexpr int BK = D <= 128 ? 64 : 32;
  static constexpr bool q_in_regs = D <= 128;
  // the ring: two stages of K then V (BK rows each); Q is staged in stage 1
  // before the loop when its fragments stay in registers, else it has a
  // tile of its own after the ring
  static constexpr int stage = 2 * BK * RS;
  static constexpr int bytes = 2 * (2 * stage + (q_in_regs ? 0 : kBQ * RS));
  static_assert(2 * BK >= kBQ, "a stage must hold Q and the output tile");
};

// copy rows [row0, row0 + ROWS) of a (rows, D) bf16 matrix into a padded
// tile, zero-filling rows past n_rows
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int n_rows, int tid) {
  constexpr int kChunks = D / 8;            // 16-byte pieces per row
  for (int c = tid; c < ROWS * kChunks; c += kMmaThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool ok = row0 + r < n_rows;
    const __nv_bfloat16* s = ok ? src + (size_t)(row0 + r) * D + col : src;
    mma::cp_async16(dst + r * MmaLayout<D>::RS + col, s, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, int sq, int sk, int group,
                 int causal, int window) {
  using L = MmaLayout<D>;
  constexpr int RS = L::RS, BK = L::BK;
  constexpr int KD = D / 16;               // k-steps of Q K^T
  constexpr int ND = D / 8;                // n8 tiles of O
  constexpr int QF = L::q_in_regs ? KD : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][K, V]
  __nv_bfloat16* qs = L::q_in_regs ? ring + L::stage : ring + 2 * L::stage;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // longest rows first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* qg = q + (size_t)bh * sq * D;
  const __nv_bfloat16* kg = k + (size_t)(bh / group) * sk * D;
  const __nv_bfloat16* vg = v + (size_t)(bh / group) * sk * D;

  // queries occupy the suffix of the keys (prefill: sq == sk)
  const int q_offset = causal ? sk - sq : 0;
  const bool use_window = causal && window > 0;
  int k_begin = 0, k_end = sk;
  if (causal) {
    const int last_row = min(q0 + kBQ, sq) - 1 + q_offset;
    k_end = min(sk, last_row + 1);
    if (use_window) k_begin = max(0, q0 + q_offset - window + 1);
  }
  const int kb0 = (k_begin / BK) * BK;
  const int n_blocks = kb0 < k_end ? (k_end - kb0 + BK - 1) / BK : 0;

  // prologue: Q and the first K/V block in one group
  load_tile<D, kBQ>(qs, qg, q0, sq, tid);
  if (n_blocks > 0) {
    load_tile<D, BK>(ring, kg, kb0, sk, tid);
    load_tile<D, BK>(ring + BK * RS, vg, kb0, sk, tid);
  }
  mma::cp_async_commit();

  // this warp's Q rows: ldmatrix x4 at (row lane % 16, col 8 * (lane / 16))
  // of each 16 x 16 block gives a0..a3
  const __nv_bfloat16* q_frag_base =
      qs + (warp * 16 + (lane & 15)) * RS + (lane >> 4) * 8;
  uint32_t qf[QF][4];
  if constexpr (L::q_in_regs) {
    mma::cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < QF; ++kk) mma::ldsm_x4(qf[kk], q_frag_base + kk * 16);
    __syncthreads();   // stage 1 is free for the ring
  }

  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};
  const int row_a = q0 + warp * 16 + g + q_offset;   // absolute position, row g

  // K fragments (B of Q K^T, non-trans): row key n0 + lane % 8 + 8 (lane / 16),
  // col 8 ((lane / 8) % 2) -> b0, b1 of key tile n0 and b0, b1 of n0 + 8
  const int k_ld = ((lane & 7) + ((lane >> 4) << 3)) * RS + ((lane >> 3) & 1) * 8;
  // V fragments (B of P V, trans): row key 16 kk + lane % 8 + 8 ((lane / 8) % 2),
  // col d0 + 8 (lane / 16) -> b0, b1 of d tile d0 and of d0 + 8
  const int v_ld = ((lane & 7) + (((lane >> 3) & 1) << 3)) * RS + (lane >> 4) * 8;

  for (int it = 0; it < n_blocks; ++it) {
    const int k0 = kb0 + it * BK;
    const int buf = it & 1;
    if (it + 1 < n_blocks) {
      __nv_bfloat16* nxt = ring + (buf ^ 1) * L::stage;
      load_tile<D, BK>(nxt, kg, k0 + BK, sk, tid);
      load_tile<D, BK>(nxt + BK * RS, vg, k0 + BK, sk, tid);
    }
    mma::cp_async_commit();
    mma::cp_async_wait<1>();   // block `it` (and Q) has landed
    __syncthreads();
    const __nv_bfloat16* kt = ring + buf * L::stage;
    const __nv_bfloat16* vt = kt + BK * RS;

    // ---- S = Q K^T, 16 rows x BK keys per warp ------------------------
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      if constexpr (L::q_in_regs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        mma::ldsm_x4(a, q_frag_base + kk * 16);
      }
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t b[4];
        mma::ldsm_x4(b, kt + np * 16 * RS + k_ld + kk * 16);
        mma::mma_bf16(s[2 * np], a, b[0], b[1]);
        mma::mma_bf16(s[2 * np + 1], a, b[2], b[3]);
      }
    }

    // ---- mask, base-2 scale, online softmax on the fragments -----------
    const bool edge = k0 + BK > sk ||
                      (causal && k0 + BK - 1 > q0 + q_offset) ||
                      (use_window && k0 <= q0 + kBQ - 1 + q_offset - window);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * kLog2e;
        if (edge) {
          const int ka = k0 + j * 8 + 2 * t + (e & 1);
          const int qa = row_a + (e >> 1) * 8;
          bool keep = ka < sk;
          if (causal) keep = keep && ka <= qa;
          if (use_window) keep = keep && ka > qa - window;
          if (!keep) x = kNegInf;
        }
        s[j][e] = x;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i[r], mx);
      const float alpha = exp2f(m_i[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        s[j][2 * r] = exp2f(s[j][2 * r] - m_new);
        s[j][2 * r + 1] = exp2f(s[j][2 * r + 1] - m_new);
        rs += s[j][2 * r] + s[j][2 * r + 1];
      }
      l_i[r] = alpha * l_i[r] + rs;      // this lane's share; quad sum at the end
      m_i[r] = m_new;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        o[d][2 * r] *= alpha;
        o[d][2 * r + 1] *= alpha;
      }
    }

    // ---- O += (P_hi + P_lo) V -------------------------------------------
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      mma::split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      mma::split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      mma::split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      mma::split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t b[4];
        mma::ldsm_x4_trans(b, vt + kk * 16 * RS + v_ld + dp * 16);
        mma::mma_bf16(o[2 * dp], ph, b[0], b[1]);
        mma::mma_bf16(o[2 * dp], pl, b[0], b[1]);
        mma::mma_bf16(o[2 * dp + 1], ph, b[2], b[3]);
        mma::mma_bf16(o[2 * dp + 1], pl, b[2], b[3]);
      }
    }
    __syncthreads();   // every warp is done with `buf` before it is refilled
  }
  mma::cp_async_wait<0>();
  __syncthreads();     // no copy in flight; stage 0 is free for the output

  // ---- O / l, rounded once to bf16, staged in stage 0, written by rows --
  __nv_bfloat16* os = ring + warp * 16 * RS;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_i[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const uint32_t pr = mma::pack_bf16(__float2bfloat16_rn(o[d][2 * r] / den),
                                         __float2bfloat16_rn(o[d][2 * r + 1] / den));
      *reinterpret_cast<uint32_t*>(os + (g + 8 * r) * RS + d * 8 + 2 * t) = pr;
    }
  }
  __syncwarp();
  __nv_bfloat16* og = out + (size_t)bh * sq * D;
  constexpr int kChunks = D / 8;
  for (int c = lane; c < 16 * kChunks; c += 32) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const int row = q0 + warp * 16 + r;
    if (row < sq)
      *reinterpret_cast<uint4*>(og + (size_t)row * D + col) =
          *reinterpret_cast<const uint4*>(os + r * RS + col);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out, int bh,
               int sq, int sk, int group, int causal, int window,
               cudaStream_t stream) {
  const int bytes = MmaLayout<D>::bytes;
  auto kernel = flash_mma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, (sq + kBQ - 1) / kBQ);
  kernel<<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      sq, sk, group, causal, window);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;    // 16 x 16

template <int D>
struct Layout {
  static constexpr int QS = D + 4;     // Q row stride: rows 4 apart -> other banks
  static constexpr int KS = D + 1;     // K row stride: odd, column reads conflict-free
  static constexpr int PS = kBK + 4;   // probability row stride
  static constexpr int floats = kBQ * QS + kBK * KS + kBK * D + kBQ * PS;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int sq,
             int sk, int group, int causal, int window) {
  using L = Layout<D>;
  constexpr int ND = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;                        // [kBQ][QS]
  float* ks = qs + kBQ * L::QS;            // [kBK][KS]
  float* vs = ks + kBK * L::KS;            // [kBK][D]
  float* ps = vs + kBK * D;                // [kBQ][PS]

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const float* qg = q + (size_t)bh * sq * D;
  const float* kg = k + (size_t)(bh / group) * sk * D;
  const float* vg = v + (size_t)(bh / group) * sk * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    float qv = 0.f;
    if (q0 + r < sq) qv = qg[(size_t)(q0 + r) * D + c];
    qs[r * L::QS + c] = qv;
  }

  // queries occupy the suffix of the keys (prefill: sq == sk)
  const int q_offset = causal ? sk - sq : 0;
  const bool use_window = causal && window > 0;
  int k_begin = 0, k_end = sk;
  if (causal) {
    const int last_row = min(q0 + kBQ, sq) - 1 + q_offset;
    k_end = min(sk, last_row + 1);
    if (use_window) k_begin = max(0, q0 + q_offset - window + 1);
  }

  float m_i[4], l_i[4], acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int d = 0; d < ND; ++d) acc[i][d] = 0.f;
  }

  for (int k0 = (k_begin / kBK) * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();   // the previous step is done with ks, vs and ps
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      float kv = 0.f, vv = 0.f;
      if (k0 + r < sk) {
        kv = kg[(size_t)(k0 + r) * D + c];
        vv = vg[(size_t)(k0 + r) * D + c];
      }
      ks[r * L::KS + c] = kv;
      vs[r * D + c] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * L::QS + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * L::KS + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qa = q0 + ty * 4 + i + q_offset;     // absolute query position
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ka = k0 + tx + 16 * j;
        bool keep = ka < sk;
        if (causal) keep = keep && ka <= qa;
        if (use_window) keep = keep && ka > qa - window;
        if (!keep) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[i] = alpha * l_i[i] + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int d = 0; d < ND; ++d) acc[i][d] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(ty * 4 + i) * L::PS + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4], vv[ND];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * L::PS + c];
#pragma unroll
      for (int d = 0; d < ND; ++d) vv[d] = vs[c * D + tx + 16 * d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int d = 0; d < ND; ++d) acc[i][d] = fmaf(pv[i], vv[d], acc[i][d]);
    }
  }

  float* og = out + (size_t)bh * sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    const float denom = fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int d = 0; d < ND; ++d)
      og[(size_t)row * D + tx + 16 * d] = acc[i][d] / denom;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, int bh,
               int sq, int sk, int group, int causal, int window,
               cudaStream_t stream) {
  const size_t bytes = sizeof(float) * Layout<D>::floats;
  auto kernel = flash_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, (sq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), sq, sk, group,
      causal, window);
  return (int)cudaGetLastError();
}

// blocks of the dtype's kernel resident per SM at its launch shape, as the
// occupancy calculator derives them from its registers and shared memory
template <int D>
int occupancy(int dtype, int* blocks, int* threads, int* smem_bytes) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const bool mma = dtype == 1;
  const void* fn = mma ? (const void*)flash_mma_kernel<D> : (const void*)flash_kernel<D>;
  *threads = mma ? kMmaThreads : kThreads;
  *smem_bytes = mma ? MmaLayout<D>::bytes : (int)(sizeof(float) * Layout<D>::floats);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, *threads,
                                                            *smem_bytes);
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* out,
           int bh, int sq, int sk, int group, int causal, int window,
           cudaStream_t s) {
  if (dtype == 0) return launch_f32<D>(q, k, v, out, bh, sq, sk, group, causal, window, s);
  if (dtype == 1) return launch_mma<D>(q, k, v, out, bh, sq, sk, group, causal, window, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  window <= 0: no sliding window.  bfloat16
// operands must start 16-byte aligned (the wrapper checks).  Returns 0 or
// the cudaError_t of the attribute call or the launch.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int bh, int sq, int sk, int d,
                           int group, int causal, int window, int dtype,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(dtype, q, k, v, out, bh, sq, sk, group, causal, window, s);
    case 32: return launch<32>(dtype, q, k, v, out, bh, sq, sk, group, causal, window, s);
    case 64: return launch<64>(dtype, q, k, v, out, bh, sq, sk, group, causal, window, s);
    case 112: return launch<112>(dtype, q, k, v, out, bh, sq, sk, group, causal, window, s);
    case 128: return launch<128>(dtype, q, k, v, out, bh, sq, sk, group, causal, window, s);
    case 256: return launch<256>(dtype, q, k, v, out, bh, sq, sk, group, causal, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// blocks per SM, threads per block and dynamic shared memory of the
// kernel for (d, dtype)
int flash_attention_occupancy(int d, int dtype, int* blocks, int* threads,
                              int* smem_bytes) {
  switch (d) {
    case 16: return occupancy<16>(dtype, blocks, threads, smem_bytes);
    case 32: return occupancy<32>(dtype, blocks, threads, smem_bytes);
    case 64: return occupancy<64>(dtype, blocks, threads, smem_bytes);
    case 112: return occupancy<112>(dtype, blocks, threads, smem_bytes);
    case 128: return occupancy<128>(dtype, blocks, threads, smem_bytes);
    case 256: return occupancy<256>(dtype, blocks, threads, smem_bytes);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
