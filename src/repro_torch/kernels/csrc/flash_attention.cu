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
// so here a block owns a tile of query rows of one (batch, head) and walks
// the key blocks in a loop inside the program.  The KV head is bh / group,
// as the TPU kernel's index_map.  Key blocks that every row of the tile
// masks are not visited (the TPU kernel's pl.when skip); a ragged tail (Sq
// or Sk not a multiple of the block) is masked here, so the kernels take
// every length.  Masked scores are -1e30, not -inf: a row that a visited
// block masks whole takes exp(0) terms while its running max is still
// -1e30, and the first block with a real key rescales them by alpha =
// exp(-1e30 - m) = 0, where -inf would make NaN.  The final division is by
// max(l, 1e-30).  Rows and keys past Sq / Sk load as 0, so such terms
// never carry NaN.  The online softmax runs in the base-2 domain (scores
// times log2 e, exp2f) on the accumulator registers: each row lives in the
// four lanes of a quad, so its max takes two xor shuffles; l is kept per
// lane and summed over the quad at the end.  In bf16 the probabilities P
// enter P V as P_hi + P_lo, two bf16 parts (mma_sm90.cuh split_bf16), each
// multiplied by the same bf16 V: one bf16 rounding of P would miss the bar
// against the plain version, which keeps P in float32 as the TPU kernel
// does.  The output is rounded once to bf16.
//
// The dtype and head dim pick the kernel at the C entry point (never a
// failure; ../flash_attention.py BF16_KERNEL and BF16_TILES name them):
//
// bfloat16 at D = 64, 112, 128 (every bf16 launch of the LM paths):
// flash_wgmma_kernel, on Hopper's own instructions.  One persistent block
// per SM walks tiles of 128 query rows, every head's heaviest tile first,
// dealt in rounds of gridDim tiles taken forward and backward in turn.  A
// tile ends where the 64-row half holding the last query row ends, so a
// ragged Sq leaves at most one half of the first tile before row 0 (it
// does nothing) and rows past Sq in the last half (read as zeros, never
// stored).  384 threads in three warpgroups:
//  * warpgroup 0, the producer, gives its registers away (setmaxnreg.dec
//    to 24); one thread issues TMA copies: each tile's Q into one of two Q
//    buffers (the next tile's Q loads while this one computes), then K and
//    V of each visited block of 64 keys into a ring of 4 stages.  Each
//    stage has a "full" mbarrier (the copy's bytes) and an "empty" one (an
//    arrival from each of the 8 consumer warps); each Q buffer a "full"
//    and an "empty" (freed when both consumers' outputs are stored).
//  * warpgroups 1 and 2, the consumers, take 64 rows each
//    (setmaxnreg.inc to 240).  S = Q K^T is wgmma m64n64k16 with both
//    operands in shared memory (D / 16 k-steps: 7 at D = 112); P V is two
//    register-A wgmma m64nDk16 per 16 keys (P_hi, P_lo) on the V tile read
//    MN-major through the descriptor's transpose bit.  S of block j + 1 is
//    issued before P V of block j, and its softmax runs while that product
//    is on the tensor cores; O is rescaled once the product is done.  A
//    consumer computes only the blocks that hold a pair its own rows keep
//    (the visit rule over its rows) and passes the others through the
//    ring; it frees a stage after its products on it are done.
// The visit rule is the TPU kernel's skip over the rows that exist: block
// j of BK keys is visited iff j BK < Sk, j BK <= last row + (Sk - Sq)
// (causal) and j BK + BK - 1 > first row + (Sk - Sq) - window (window);
// the tile's rows decide the ring's blocks, each consumer's rows its own.
// Everything a computed block masks is masked per element.  The tiles are
// 64-column swizzled (128 bytes) as TMA writes them and wgmma reads them:
// a row of D = 112 is two 64-column boxes, the second's columns 112..127
// past the tensor's edge arrive as zeros, P V uses N = 112.  The tensor
// maps are 3-D (D, rows, heads), so a box at a head's ragged tail reads
// zeros, never the next head's rows; they are built on every launch by
// cuTensorMapEncodeTiled, taken from the driver at run time (no -lcuda;
// tma_sm90.cuh), and passed as __grid_constant__ parameters.  The output
// is staged in the consumer's Q rows (its last read of them done) and
// stored by TMA, which clips rows past Sq and columns past D.
// Tiles (why 64 keys and 4 stages): ptxas allocates the whole kernel
// within the launch bound's 168 registers (setmaxnreg raises a
// warpgroup's allocation at run time, not ptxas's budget).  With 128-key
// blocks the overlapped consumer's S, P and O (64 + 64 + 64 registers at
// D = 128) do not fit: it spills, and ptxas serialises the wgmmas.  At 64
// keys nothing spills.  The overlap holds two stages per consumer at once,
// so two stages leave the producer nothing to fill ahead.
//
// bfloat16 at D = 16, 32, 224, 256: flash_mma_kernel, on the instructions
// Hopper shares with Ampere.  Four warps, each owning 16
// query rows of a 64-row block; Q, K and V stay bf16 in shared memory and
// arrive by 16-byte cp.async, K and V in a double-buffered ring of 64-key
// blocks (32 at D = 224, 256).  Rows are padded by 16 bytes (D + 8 elements):
// every row starts 16-byte aligned and the eight row addresses of each
// ldmatrix phase fall in distinct banks.  S = Q K^T is mma.sync m16n8k16;
// O += P V feeds the S fragments straight back as the A operand, issued
// as two mma.sync (P_hi, P_lo) against the same V fragment
// (ldmatrix.trans).  Padding D = 16 or 32 to the 64-column atom would
// waste three quarters or half of every product and copy, and at D = 256
// the wgmma kernel's O alone (128 registers) leaves no room for S and P
// under the 168-register budget.  D = 224 (the published Zamba2's shared
// attention, 32 heads of 224) is laid out as 256: 14 k-steps of Q K^T and
// 28 n8 tiles of O (112 registers), Q in its own tile (232-element rows,
// 464 bytes: the eight rows of an ldmatrix phase land 20 words apart mod
// 32, in distinct banks), 89,088 B of shared memory.  The wgmma kernel
// does not take it as it stands: a row is four 64-column tiles (two Q
// buffers 128 KB, each 64-key stage 64 KB, far past a block's 227 KB), and
// O's 112 registers beside S and P at 64 keys break the 168-register
// budget; a 32-key ring of 3 stages (226 KB) and an m64n224 register-A
// product would fit, and are left to a later change.
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
// is bound by the tensor cores (~0.24 ms at 989 TFLOP/s).  The bf16
// kernels issue 1.5x that work (the P split: 6 d flop per kept pair, a
// ceiling of ~0.365 ms).  Each 128-row tile also reads its visited K and V
// blocks from L2 once (1.9 GB at that shape), traffic that TMA overlaps
// with the products but that grows as the tiles shrink.
//
// Resources (ptxas for sm_90a and CUDA's occupancy calculator, printed by
// chip_smoke.py's [build] and [occupancy] lines; table in PERF.md):
// flash_wgmma_kernel takes the launch bound's 168 registers at every D
// with no spills and 99,328 B (D = 64) or 197,632 B (D = 112, 128) of
// dynamic shared memory, one block per SM; flash_mma_kernel<256> 255
// registers, 2 blocks of 128 threads; flash_mma_kernel<224> 174 registers,
// 89,088 B, 2 blocks of 128 threads; flash_kernel<224> 128 registers,
// 190,720 B, one block.
//
// Built without -fmad=false (contraction allowed) and without fast-math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"
#include "tma_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per step of the float32 kernel's loop
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bfloat16 at D = 16, 32, 224, 256: mma.sync
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows

template <int D>
struct MmaLayout {
  static constexpr int RS = D + 8;          // row stride (bf16 elements)
  // keys per block of the loop; at D = 224, 256 the accumulator alone is
  // 112, 128 registers, and 32 keys keep S to 16 more
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
// bfloat16 at D = 64, 112, 128: TMA ring, producer warpgroup, wgmma
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 384;   // producer warpgroup + two consumer warpgroups
constexpr int kWgBQ = 128;        // query rows per block, 64 per consumer
constexpr int kTileBytes = 64 * 128;   // 64 rows of one 64-column swizzled tile

constexpr bool wgmma_dim(int d) { return d == 64 || d == 112 || d == 128; }

template <int D>
struct WgLayout {
  static_assert(wgmma_dim(D), "the wgmma kernel takes head dims 64, 112, 128");
  static constexpr int BK = 64;                     // keys per ring stage
  static constexpr int stages = 4;                  // ring stages of K and V
  // registers per thread after setmaxnreg: launched at 168 (65536 / 384,
  // down to a multiple of 8), the producer's threads keep 24 and the
  // consumers' take 240 (24 x 128 + 240 x 256 = 64,512 of the 65,536)
  static constexpr int producer_regs = 24;
  static constexpr int consumer_regs = 240;
  static constexpr int NB = (D + 63) / 64;          // 64-column tiles per row
  static constexpr int q_half = NB * kTileBytes;    // one consumer's 64 Q rows
  // (two buffers of Q: a tile's Q loads while the tile before computes)
  static constexpr int kv = NB * BK * 128;          // a K or V tile of a stage
  static constexpr int stage = 2 * kv;
  // 1024 bytes of slack align the swizzled tiles
  static constexpr int bytes = 1024 + 4 * q_half + stages * stage;
};

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// The visit rule, the TPU kernel's pl.when skip over query rows [lo, hi]
// (those that exist): key blocks [x, y] of BK keys, each starting inside
// the keys, no later than row hi's position (causal) and, with a window,
// ending after row lo's window begins.  Exactly the blocks that hold a
// (query, key) pair the mask keeps for one of the rows.
template <int BK>
__device__ __forceinline__ int2 visit(int lo, int hi, int sk, int q_offset,
                                      int causal, int window) {
  if (hi < lo) return make_int2(0, -1);
  int first = 0, last = (sk - 1) / BK;
  if (causal) {
    last = min(last, floor_div(hi + q_offset, BK));
    if (window > 0)
      first = max(0, floor_div(lo + q_offset - window - BK + 1, BK) + 1);
  }
  return make_int2(first, last);
}

// o (64 x D) += P (64 x 16, registers) V (16 x D, MN-major in shared memory)
template <int D>
__device__ __forceinline__ void mma_pv(float (&o)[D / 2], const uint32_t (&a)[4],
                                       uint64_t desc_v) {
  if constexpr (D == 64) wg::mma_rs_n64(o, a, desc_v);
  else if constexpr (D == 112) wg::mma_rs_n112(o, a, desc_v);
  else wg::mma_rs_n128(o, a, desc_v);
}

// The consumer's rows for masking: absolute positions of this thread's
// row g (row g + 8 is 8 further) and of the consumer's first row
struct Rows {
  int sk, row_a, first_pos, causal, use_window, window, t;
};

// s (64 x BK, this consumer's rows) = Q K^T over D / 16 k-steps; Q's 64
// rows at qa, the stage's K tiles at kt (both K-major, 64 columns a tile)
template <int D, int BK>
__device__ __forceinline__ void qk(float (&s)[BK / 2], uint32_t qa, uint32_t kt) {
  static_assert(BK == 64, "S is one m64n64 product per k-step");
  wg::mma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;   // 16 columns = 32 bytes
    wg::mma_ss_n64(s, wg::desc(qa + (kk >> 2) * kTileBytes + off, 16, 1024),
                   wg::desc(kt + (kk >> 2) * BK * 128 + off, 16, 1024), kk > 0);
  }
}

// o += (P_hi + P_lo) V: two register-A products per 16 keys on the V tiles
// at vt (MN-major: 16 keys are 2048 bytes, the next 64 columns BK rows on)
template <int D, int BK>
__device__ __forceinline__ void pv(float (&o)[D / 2], const uint32_t (&ph)[BK / 16][4],
                                   const uint32_t (&pl)[BK / 16][4], uint32_t vt) {
  wg::mma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t dv = wg::desc(vt + kk * 2048, BK * 128, 1024);
    mma_pv<D>(o, ph[kk], dv);
    mma_pv<D>(o, pl[kk], dv);
  }
}

// Mask the scores of keys [k0, k0 + BK) (only where the block reaches a
// ragged tail, the diagonal or the window's edge), scale them to base 2
// and take the online softmax step: s becomes exp2(s - m_new), l and m
// move on, alpha = exp2(m_old - m_new) per row (rows g and g + 8)
template <int BK>
__device__ __forceinline__ void softmax(float (&s)[BK / 2], float (&m_i)[2],
                                        float (&l_i)[2], float (&alpha)[2],
                                        int k0, const Rows& r) {
  const bool edge = k0 + BK > r.sk || (r.causal && k0 + BK - 1 > r.first_pos) ||
                    (r.use_window && k0 <= r.first_pos + 63 - r.window);
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e] * kLog2e;
      if (edge) {
        const int ka = k0 + j * 8 + 2 * r.t + (e & 1);
        const int qa = r.row_a + (e >> 1) * 8;
        bool keep = ka < r.sk;
        if (r.causal) keep = keep && ka <= qa;
        if (r.use_window) keep = keep && ka > qa - r.window;
        if (!keep) x = kNegInf;
      }
      s[4 * j + e] = x;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_i[h], mx);
    alpha[h] = exp2f(m_i[h] - m_new);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[4 * j + 2 * h] = exp2f(s[4 * j + 2 * h] - m_new);
      s[4 * j + 2 * h + 1] = exp2f(s[4 * j + 2 * h + 1] - m_new);
      rs += s[4 * j + 2 * h] + s[4 * j + 2 * h + 1];
    }
    l_i[h] = alpha[h] * l_i[h] + rs;   // this lane's share; quad sum at the end
    m_i[h] = m_new;
  }
}

template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

// P (the accumulator layout of S is the A fragment of P V) as bf16 hi + lo
template <int BK>
__device__ __forceinline__ void split_p(const float (&s)[BK / 2], uint32_t (&ph)[BK / 16][4],
                                        uint32_t (&pl)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      mma::split_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1], ph[kk][i], pl[kk][i]);
}

// A query tile: rows [q0, q0 + 128) of head bh, and the key blocks
// [first, first + n_blocks) its ring carries.  Tile i of a launch is head
// i % BH, and the (i / BH)-th tile from the end of the rows: every head's
// heaviest tile comes first.  Tiles end where the 64-row half holding the
// last query row ends.  A ragged Sq leaves rows past Sq in the last half
// (TMA reads them as zeros and does not store them) and, when ceil(Sq /
// 64) is odd, a first tile whose first half lies wholly before row 0: that
// consumer loads, computes and stores nothing.
struct Tile {
  int bh, q0, first, n_blocks;
};

template <int BK>
__device__ __forceinline__ Tile tile_at(int i, int bh_total, int sq, int sk,
                                        int q_offset, int causal, int window) {
  Tile tl;
  tl.bh = i % bh_total;
  tl.q0 = (sq + 63) / 64 * 64 - (i / bh_total + 1) * kWgBQ;
  const int2 blocks = visit<BK>(max(tl.q0, 0), min(tl.q0 + kWgBQ, sq) - 1, sk,
                                q_offset, causal, window);
  tl.first = blocks.x;
  tl.n_blocks = max(0, blocks.y - blocks.x + 1);
  return tl;
}

// The k-th tile of block p among `grid` persistent blocks: rounds of
// `grid` tiles, taken in turn forward and backward (the heaviest of a
// round and the lightest of the next fall to one block)
__device__ __forceinline__ int tile_index(int k, int p, int grid) {
  return k * grid + ((k & 1) ? grid - 1 - p : p);
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap to, int bh_total,
                   int sq, int sk, int group, int causal, int window) {
  using L = WgLayout<D>;
  constexpr int NB = L::NB, BK = L::BK, STAGES = L::stages;
  constexpr int ND = D / 8;           // n8 column blocks of O
  extern __shared__ unsigned char smem_raw[];
  // q_full[2], q_empty[2] (the two Q buffers), full[], empty[] (the ring)
  __shared__ __align__(8) uint64_t bars[4 + 2 * STAGES];
  const uint32_t base = (wg::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;                    // [buffer][consumer][64-column tile]
  const uint32_t ring = base + 4 * L::q_half;   // [stage][K tiles, V tiles]
  const uint32_t q_full0 = wg::smem_u32(&bars[0]);
  const uint32_t q_empty0 = wg::smem_u32(&bars[2]);
  const uint32_t full0 = wg::smem_u32(&bars[4]);
  const uint32_t empty0 = wg::smem_u32(&bars[4 + STAGES]);

  // queries occupy the suffix of the keys (prefill: sq == sk)
  const int q_offset = causal ? sk - sq : 0;
  const bool use_window = causal && window > 0;
  const int n_tiles = (sq + kWgBQ - 1) / kWgBQ * bh_total;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int b = 0; b < 2; ++b) {
      wg::mbar_init(q_full0 + 8 * b, 1);
      wg::mbar_init(q_empty0 + 8 * b, 2);   // one arrival per consumer
    }
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(full0 + 8 * s, 1);
      wg::mbar_init(empty0 + 8 * s, 8);     // one arrival per consumer warp
    }
    wg::mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup, read from lane 0 so that the compiler sees it uniform
  // across each warp: setmaxnreg then takes hold for the branch it opens
  const int role = __shfl_sync(0xffffffffu, tid >> 7, 0);
  if (role == 0) {
    // ---- producer: one thread keeps the Q buffers and the ring full -------
    wg::setmaxnreg_dec<L::producer_regs>();
    if (tid == 0) {
      int blk = 0;   // blocks through the ring so far
      for (int k = 0;; ++k) {
        const int i = tile_index(k, blockIdx.x, gridDim.x);
        if (i >= n_tiles) break;
        const Tile tl = tile_at<BK>(i, bh_total, sq, sk, q_offset, causal, window);
        const int qb = k & 1, c_first = tl.q0 < 0 ? 1 : 0;
        // the buffer's tile before last is stored (a fresh barrier passes)
        wg::mbar_wait(q_empty0 + 8 * qb, ((k >> 1) & 1) ^ 1);
        wg::mbar_arrive_expect_tx(q_full0 + 8 * qb, (2 - c_first) * L::q_half);
        for (int c = c_first; c < 2; ++c)
          for (int b = 0; b < NB; ++b)
            wg::tma_load_3d(q_s + ((2 * qb + c) * NB + b) * kTileBytes, &tq,
                            q_full0 + 8 * qb, 64 * b, tl.q0 + 64 * c, tl.bh);
        const int kv_head = tl.bh / group;
        for (int it = 0; it < tl.n_blocks; ++it, ++blk) {
          const int s = blk % STAGES;
          // a fresh barrier passes the wait for parity 1: the first pass
          // over the ring finds every stage free
          wg::mbar_wait(empty0 + 8 * s, ((blk / STAGES) & 1) ^ 1);
          wg::mbar_arrive_expect_tx(full0 + 8 * s, L::stage);
          const uint32_t kt = ring + s * L::stage, vt = kt + L::kv;
          const int k0 = (tl.first + it) * BK;
          for (int b = 0; b < NB; ++b) {
            wg::tma_load_3d(kt + b * BK * 128, &tk, full0 + 8 * s, 64 * b, k0, kv_head);
            wg::tma_load_3d(vt + b * BK * 128, &tv, full0 + 8 * s, 64 * b, k0, kv_head);
          }
        }
      }
    }
    return;
  }

  // ---- consumers: 64 query rows of each tile -----------------------------
  wg::setmaxnreg_inc<L::consumer_regs>();
  const int c = role - 1;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float o[D / 2];
  float m_i[2], l_i[2], alpha[2];
  float sacc[BK / 2];
  uint32_t ph[BK / 16][4], pl[BK / 16][4];
  int blk = 0;   // blocks through the ring before this tile
  for (int k = 0;; ++k) {
    const int i = tile_index(k, blockIdx.x, gridDim.x);
    if (i >= n_tiles) break;
    const Tile tl = tile_at<BK>(i, bh_total, sq, sk, q_offset, causal, window);
    const int qb = k & 1;
    const int r0 = tl.q0 + 64 * c;                      // this consumer's first row
    const int row_a = r0 + 16 * warp + g + q_offset;    // absolute position, row g
    const uint32_t qa = q_s + (2 * qb + c) * L::q_half;
    const Rows rows{sk, row_a, r0 + q_offset, causal, use_window, window, t};
#pragma unroll
    for (int x = 0; x < D / 2; ++x) o[x] = 0.f;
    m_i[0] = m_i[1] = kNegInf;
    l_i[0] = l_i[1] = 0.f;

    // This consumer computes the tile's blocks [it0, it1): the visit rule
    // over its own rows that exist.  A block outside them is masked whole
    // for its rows, so it only passes the block through the ring.  Every
    // consumer warp arrives once on each block's "empty" barrier, after
    // that block's "full" phase, computed or not.
    const int2 own = visit<BK>(max(r0, 0), min(r0 + 64, sq) - 1, sk, q_offset,
                               causal, window);
    const int it0 = max(0, own.x - tl.first);
    const int it1 = max(it0, min(tl.n_blocks, own.y - tl.first + 1));
    auto pass = [&](int it) {
      const int b = blk + it;
      wg::mbar_wait(full0 + 8 * (b % STAGES), (b / STAGES) & 1);
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(empty0 + 8 * (b % STAGES));
    };
    wg::mbar_wait(q_full0 + 8 * qb, (k >> 1) & 1);
    for (int it = 0; it < it0; ++it) pass(it);

    // S of block it + 1 is issued before P V of block it, and its softmax
    // runs while that product is on the tensor cores; O is rescaled once
    // the product is done
    if (it0 < it1) {
      const int b = blk + it0;
      wg::mbar_wait(full0 + 8 * (b % STAGES), (b / STAGES) & 1);
      qk<D, BK>(sacc, qa, ring + (b % STAGES) * L::stage);
      wg::mma_commit();
      wg::mma_wait<0>();
      wg::fence_regs(sacc);
      softmax<BK>(sacc, m_i, l_i, alpha, (tl.first + it0) * BK, rows);
      split_p<BK>(sacc, ph, pl);
    }
    // (the last block's product is issued after the loop: a loop body
    // without branches lets the compiler keep both products in flight)
    for (int it = it0; it + 1 < it1; ++it) {
      const int b = blk + it;
      const int s = b % STAGES, s1 = (b + 1) % STAGES;
      wg::mbar_wait(full0 + 8 * s1, ((b + 1) / STAGES) & 1);
      qk<D, BK>(sacc, qa, ring + s1 * L::stage);
      wg::mma_commit();
      wg::fence_regs(o);
      pv<D, BK>(o, ph, pl, ring + s * L::stage + L::kv);
      wg::mma_commit();
      wg::mma_wait<1>();
      wg::fence_regs(sacc);
      softmax<BK>(sacc, m_i, l_i, alpha, (tl.first + it + 1) * BK, rows);
      wg::mma_wait<0>();
      wg::fence_regs(o);
      // the stage is free once every consumer warp's products on it are done
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(empty0 + 8 * s);
      rescale<D>(o, alpha);
      split_p<BK>(sacc, ph, pl);
    }
    if (it0 < it1) {
      const int s = (blk + it1 - 1) % STAGES;
      wg::fence_regs(o);
      pv<D, BK>(o, ph, pl, ring + s * L::stage + L::kv);
      wg::mma_commit();
      wg::mma_wait<0>();
      wg::fence_regs(o);
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(empty0 + 8 * s);
    }
    for (int it = it1; it < tl.n_blocks; ++it) pass(it);
    blk += tl.n_blocks;

    // ---- O / l rounded once to bf16, staged in this consumer's Q tiles (in
    // the swizzle the store's tensor map reads), stored by TMA: rows past Sq
    // and columns past D lie outside the map and are not written.  The
    // buffer is free for the tile after next once the store has read it.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = l_i[h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float den = fmaxf(l, 1e-30f);
      const int row = 16 * warp + g + 8 * h;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const uint32_t pr = mma::pack_bf16(__float2bfloat16_rn(o[4 * j + 2 * h] / den),
                                           __float2bfloat16_rn(o[4 * j + 2 * h + 1] / den));
        wg::st_shared_u32(qa + (j >> 3) * kTileBytes + row * 128 +
                              ((((j & 7) ^ (row & 7))) << 4) + 4 * t, pr);
      }
    }
    wg::fence_async_shared();
    wg::named_sync(1 + c, 128);
    if ((tid & 127) == 0) {
      if (r0 >= 0) {
        for (int b = 0; b < NB; ++b)
          wg::tma_store_3d(&to, qa + b * kTileBytes, 64 * b, r0, tl.bh);
        wg::tma_store_commit_and_wait();
      }
      wg::mbar_arrive(q_empty0 + 8 * qb);
    }
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, int bh,
                 int sq, int sk, int group, int causal, int window,
                 cudaStream_t stream) {
  CUtensorMap tq, tk, tv, to;
  int err = tma::bf16_map(&tq, q, D, sq, bh, 64);
  if (!err) err = tma::bf16_map(&tk, k, D, sk, bh / group, WgLayout<D>::BK);
  if (!err) err = tma::bf16_map(&tv, v, D, sk, bh / group, WgLayout<D>::BK);
  if (!err) err = tma::bf16_map(&to, out, D, sq, bh, 64);
  if (err) return err;
  const int bytes = WgLayout<D>::bytes;
  auto kernel = flash_wgmma_kernel<D>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return (int)attr;
  // one persistent block per SM (at most one per tile)
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (long long)((sq + kWgBQ - 1) / kWgBQ) * bh;
  const int grid = (int)(tiles < sms ? tiles : sms);
  kernel<<<grid, kWgThreads, bytes, stream>>>(tq, tk, tv, to, bh, sq, sk,
                                              group, causal, window);
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
  const void* fn;
  if (dtype == 0) {
    fn = (const void*)flash_kernel<D>;
    *threads = kThreads;
    *smem_bytes = (int)(sizeof(float) * Layout<D>::floats);
  } else if constexpr (wgmma_dim(D)) {
    fn = (const void*)flash_wgmma_kernel<D>;
    *threads = kWgThreads;
    *smem_bytes = WgLayout<D>::bytes;
  } else {
    fn = (const void*)flash_mma_kernel<D>;
    *threads = kMmaThreads;
    *smem_bytes = MmaLayout<D>::bytes;
  }
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, *threads,
                                                            *smem_bytes);
}

// the bf16 kernel's tiles at head dim D: query rows per block, keys per
// step, ring stages, and 1 for the wgmma kernel (0: flash_mma_kernel)
template <int D>
int bf16_tiles(int* bq, int* bk, int* stages, int* wgmma) {
  if constexpr (wgmma_dim(D)) {
    *bq = kWgBQ, *bk = WgLayout<D>::BK, *stages = WgLayout<D>::stages, *wgmma = 1;
  } else {
    *bq = kBQ, *bk = MmaLayout<D>::BK, *stages = 2, *wgmma = 0;
  }
  return 0;
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* out,
           int bh, int sq, int sk, int group, int causal, int window,
           cudaStream_t s) {
  if (dtype == 0) return launch_f32<D>(q, k, v, out, bh, sq, sk, group, causal, window, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if constexpr (wgmma_dim(D))
    return launch_wgmma<D>(q, k, v, out, bh, sq, sk, group, causal, window, s);
  else
    return launch_mma<D>(q, k, v, out, bh, sq, sk, group, causal, window, s);
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
    case 224: return launch<224>(dtype, q, k, v, out, bh, sq, sk, group, causal, window, s);
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
    case 224: return occupancy<224>(dtype, blocks, threads, smem_bytes);
    case 256: return occupancy<256>(dtype, blocks, threads, smem_bytes);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the bf16 kernel's tiles at head dim d (bf16_tiles)
int flash_attention_bf16_tiles(int d, int* bq, int* bk, int* stages, int* wgmma) {
  switch (d) {
    case 16: return bf16_tiles<16>(bq, bk, stages, wgmma);
    case 32: return bf16_tiles<32>(bq, bk, stages, wgmma);
    case 64: return bf16_tiles<64>(bq, bk, stages, wgmma);
    case 112: return bf16_tiles<112>(bq, bk, stages, wgmma);
    case 128: return bf16_tiles<128>(bq, bk, stages, wgmma);
    case 224: return bf16_tiles<224>(bq, bk, stages, wgmma);
    case 256: return bf16_tiles<256>(bq, bk, stages, wgmma);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attention_error_string(int err) {
  if (const char* text = tma::error_string(err)) return text;
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
