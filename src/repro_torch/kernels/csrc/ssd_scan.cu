// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py
// (ssd_scan_pallas / _kernel).  Operands in kernel layout:
//   x (B, H, S, P) float32 or bfloat16, dt (B, H, 1, S) float32,
//   a (H,) float32, bmat / cmat (B, G, S, N) in x's type;
//   -> y (B, H, S, P) float32 and the final state (B, H, P, N) float32.
// Per chunk of Q steps, with la = dt * a, cum = cumsum(la) and
// dax = dt * x:
//   y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dax_j
//         + exp(cum_i) C_i . S^T                          (S: P x N)
//   S  <- exp(cum_end) S + sum_j exp(cum_end - cum_j) dax_j (x) B_j
// The plain PyTorch version of the same function is ssd_scan_reference in
// ../ssd_scan.py.  B and C are group-mapped (head h reads bank h / (H / G)).
// The decay is selected by the causal mask, never multiplied by it: for
// j > i, exp(cum_i - cum_j) can be inf, and inf * 0 is NaN (the TPU
// kernel's where).  Every chunk length 1 .. kMaxChunk is taken; tiles past
// the chunk's end load as zero and are masked.
//
// The TPU kernel makes the chunk axis the innermost, sequential grid axis
// and carries S in VMEM scratch.  Only that P x N state is carried from
// chunk to chunk; everything else is independent across chunks.  The dtype
// and (P, N, Q) pick the kernels at the C entry point (never a failure;
// ../ssd_scan.py BF16_CHUNK_SCAN names the chunk scan's):
//
// bfloat16: three kernels on the current stream, Mamba2's own chunked-scan
// structure, the products on the tensor cores (bf16 in, float32 out):
//   (a) ssd_kernel_chunk_state, grid (nc, B*H), 4 warps, mma.sync
//       m16n8k16 (mma_sm90.cuh).  The chunk's cum (block scan; written to
//       a float32 scratch (B, H, S)) and its local state
//       sum_j (w_j x_j) (x) B_j  as the product (w x)^T B,
//       w_j = exp(cum_end - cum_j) dt_j: each x fragment is scaled by w in
//       registers and split hi + lo; B is an exact bf16 operand.  To a
//       float32 scratch (B, H, nc, P, N).  x and B arrive 64 steps at a
//       time, the next tile by cp.async while this one computes.
//   (b) ssd_kernel_state_pass, grid (P*N / 1024, B*H): the only
//       sequential part, P*N independent float32 recurrences of length nc
//       per (b, h): S_c = exp(cum_end,c) S_{c-1} + local_c.  The state
//       entering chunk c goes to a bf16 scratch (B, H, nc, 2, P, N),
//       already split hi and lo; the last is the final state.
//   (c) the chunk scan, y_i = exp(cum_i) C_i . S_in^T (S_in split hi/lo)
//       + sum over key tiles j <= i of G_ij x_j, G = (C B^T) exp(cum_i -
//       cum_j) dt_j (split hi/lo against the exact bf16 x).  Most of the
//       call's time (78 % with the mma.sync kernel below).
//       * ssd_wgmma_chunk_scan, at (P, N) = (64, 64) (zamba2-7b) and
//         (64, 128) (mamba2-370m), chunks up to kWgMaxChunk = 256, on
//         Hopper's own instructions.  The unit of work is one chunk of one
//         (batch, head), all its 64-row query tiles in one block, so each
//         C, B and x tile and the entering state leave device memory once
//         a chunk (the mma.sync kernel's per-tile blocks read ~2.2x that
//         from L2).  One persistent block per SM walks the units in
//         memory order (chunks fastest), 384 threads in three warpgroups:
//          - warpgroup 0, the producer (setmaxnreg.dec to 40): one thread
//            issues TMA copies of each unit's S_in hi and lo, then of its
//            64-step tiles (C, B and x rows, 64-column 128-byte-swizzled
//            boxes) through a ring of slots with "full" and "empty"
//            mbarriers; warp 1 loads the unit's cum (times log2 e), dt and
//            w_j = exp2(cum_e - cum_j) dt_j (cum_e the last step of j's
//            tile) into one of two buffers, every load of a unit issued
//            before it waits for the buffer.  The tensor maps are 4-D
//            (columns, Q, nc, banks or heads; tma_sm90.cuh): a box past the
//            chunk's last step reads zeros, as the other kernels' tiles do,
//            never the next chunk's rows, so every Q takes this kernel.
//          - warpgroups 1 and 2, the consumers (setmaxnreg.inc to 232),
//            64 query rows at a time, the tiles dealt by consumer_tiles
//            (the heaviest first, each to the consumer with fewer pairs:
//            {0, 3} and {1, 2} at four tiles, 5 pairs each).  Per query
//            tile q: S of key tile 0 and then the inter-chunk product C_q
//            (S_hi + S_lo)^T are issued together (wgmma m64n64k16, both
//            operands in shared memory, K-major), key tile 0's decay runs
//            while the inter-chunk product is on the tensor cores, and y
//            is scaled by exp2(cum_i log2 e), 0 past Q.  Then per key tile
//            j <= q: S of tile j + 1 is issued before (G_hi + G_lo) x_j
//            (register-A wgmma, x read MN-major through the transpose bit;
//            the accumulator layout of S is the A fragment), and its decay
//            runs while that product is on the tensor cores.  The decay on
//            the diagonal tile is exp2(cum_i - cum_j) dt_j, selected where
//            j <= i < Q; below it, where every pair is kept, it is the row
//            factor exp2(cum_i - cum_e) times the unit's w_j: 2
//            exponentials a thread in place of 32, and both factors at
//            most 1 where cum does not increase (a <= 0, dt >= 0).  G's hi
//            is G truncated to bf16 (a byte permute), lo = bf16(G - hi):
//            one conversion a pair.  y leaves by streaming stores straight
//            from the accumulator, 256 contiguous bytes a row.  A consumer
//            frees each tile after its last product on it and passes
//            through those it never reads (every consumer warp arrives
//            once on each "empty" barrier, after its "full" phase).
//         The ring: 7 tile slots (24 KB each) and 2 S_in buffers at (64,
//         64); 4 slots (40 KB) and 1 buffer at (64, 128), where two would
//         not fit in 227 KB.  A slot count of at least a chunk's 4 tiles
//         keeps the ring free of deadlock.  Registers: y, S and G's hi/lo
//         fragments are 96 a thread; ptxas fits the kernel in the launch
//         bound's 168 with no spill (it allocates within the launch bound,
//         not within what setmaxnreg grants at run time).
//       * ssd_kernel_chunk_scan, the other (P, N) and chunks past 256:
//         grid (nc * ceil(Q/64), B*H), 4 warps of 16 query rows on
//         mma.sync, C, key tiles and S_in by cp.async into padded rows,
//         key tile t + 1 loading while tile t computes.
// One bf16 rounding of w x, S_in or G would miss the bar against the plain
// version (which keeps them float32, as the TPU kernel does); the other
// operand of each product is exact bf16, so each split costs one product
// and no load.
//
// float32: ssd_kernel, the CUDA-core kernel of the first port, kept as it
// was: tensor-core TF32 would miss the float32 bars, and float32 SSD serves
// the decode check, not the bf16 prefill.  One block per (batch, head)
// loops over the chunks in order (256 threads as a 16 x 16 grid); each
// thread keeps its P/16 x N/16 share of S in registers, mirrored to shared
// memory once per chunk for the inter-chunk term; (C B^T) o L is formed in
// 64 x 64 tiles (at chunk 256 it would be 256 KB), key tiles j <= i only.
//
// What bounds it.  At zamba2-7b's prefill (B = 2, H = 112, S = 4096,
// P = N = 64, chunk 256) the function moves ~362 MB (y in float32 is
// 235 MB of it) against ~4.5e10 flop, so it is bound by bytes (~0.11 ms at
// 3.35 TB/s).  The bf16 design adds ~235 MB of scratch traffic (the local
// states written by (a), read and rewritten by (b), read by (c)).  The
// wgmma chunk scan moves ~335 MB of device memory (y, x, S_in, cum and
// dt; B and C once a chunk), ~0.10 ms, and issues ~7.1e10 flop with the
// splits, ~0.072 ms; it takes ~0.18 ms.  clock64 probes put each
// consumer's time in the decay and split of every key tile and in waiting
// for the tensor cores, which the two consumers share (PERF.md section 6).
//
// Resources (ptxas for sm_90a and CUDA's occupancy calculator, printed by
// chip_smoke.py's [build] and [occupancy] lines; table in PERF.md), bf16 at
// (P, N) = (64, 64), chunk 256, no spills: chunk_state 80 registers and
// 38,912 B of shared memory, 5 blocks per SM (shared memory); state_pass
// 57 registers, 4 blocks of 256 threads (registers); ssd_wgmma_chunk_scan
// the launch bound's 168 registers, 176 B static and 211,968 B dynamic
// shared memory, 1 block of 12 warps per SM; ssd_kernel_chunk_scan held
// to 128 registers by its launch bounds (4 blocks of 128 threads).
//
// Built without -fmad=false (contraction allowed) and without fast-math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"
#include "tma_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace {

constexpr int kT = 64;           // rows of a query or key tile
constexpr int kMaxChunk = 1024;  // ../ssd_scan.py MAX_CHUNK
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bfloat16: chunk state, state passing, chunk scan on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kMmaThreads = 128;   // chunk_state, chunk_scan: 4 warps
constexpr int kPassThreads = 256;
constexpr int kPassAhead = 4;      // chunks whose local states load together

__host__ __device__ constexpr int round_up(int q) { return (q + kT - 1) / kT * kT; }

template <int P, int N>
struct MmaLayout {
  static constexpr int XS = P + 8;   // x tile row stride (bf16 elements)
  static constexpr int BS = N + 8;   // B, C and S_in row stride
  // chunk_state: a warp's unit of (w x)^T B is 16 rows of P by NT n8 tiles
  static constexpr int NT = (N < 64 ? N : 64) / 8;
  static constexpr int NG = N / (NT * 8);
  static constexpr int UNITS = (P / 16) * NG;
  static constexpr int UPW = (UNITS + 3) / 4;     // units per warp
  // one key tile: 64 B rows, then 64 x rows (bf16 elements)
  static constexpr int KEY_TILE = kT * BS + kT * XS;
  // the state entering a chunk, hi tile then lo tile
  static constexpr int S_IN = 2 * P * BS;
  static constexpr int R1 = KEY_TILE > S_IN ? KEY_TILE : S_IN;
  // chunk_state: two key tiles, then the decay weights (q rounded up to
  // whole tiles, zero past q) and cum (q floats)
  static size_t state_bytes(int q) {
    return 2 * (size_t)(2 * KEY_TILE) + 4 * (size_t)(round_up(q) + q);
  }
  // chunk_scan blocks per SM the registers are held to (128 per thread at
  // (64, 64)); the larger shapes keep what ptxas chooses
  static constexpr int scan_min_blocks = P * N <= 64 * 64 ? 4 : 1;
  // chunk_scan: the C tile, key tile 0, a room for S_in and then key
  // tile 1, then cum and dt (q floats each)
  static size_t scan_bytes(int q) {
    return 2 * (size_t)(kT * BS + KEY_TILE + R1) + 8 * (size_t)q;
  }
};

// copy rows [row0, row0 + ROWS) of a (rows, W) bf16 matrix into a tile of
// row stride RS, zero-filling rows at or past n_rows
template <int W, int RS, int ROWS = kT>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int row0,
                                          int n_rows) {
  constexpr int kChunks = W / 8;            // 16-byte pieces per row
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kMmaThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool ok = row0 + r < n_rows;
    mma::cp_async16(dst + r * RS + col,
                    ok ? src + (size_t)(row0 + r) * W + col : src, ok);
  }
}

// key tile of steps [row0, row0 + 64) of a chunk of q steps: B rows, x rows
template <int P, int N>
__device__ __forceinline__ void load_key_tile(bf16* dst, const bf16* bg,
                                              const bf16* xg, int row0, int q) {
  using L = MmaLayout<P, N>;
  load_rows<N, L::BS>(dst, bg, row0, q);
  load_rows<P, L::XS>(dst + kT * L::BS, xg, row0, q);
}

template <int P, int N>
__global__ void __launch_bounds__(kMmaThreads)
ssd_kernel_chunk_state(const bf16* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ a, const bf16* __restrict__ bm,
                       float* __restrict__ cum_out, float* __restrict__ states,
                       int H, int G, int S, int Q) {
  using L = MmaLayout<P, N>;
  constexpr int XS = L::XS, BS = L::BS, NT = L::NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* tiles = reinterpret_cast<bf16*>(smem_raw);            // two key tiles
  float* wdec = reinterpret_cast<float*>(tiles + 2 * L::KEY_TILE);   // [round_up(Q)]
  float* cum = wdec + round_up(Q);                                   // [Q]
  __shared__ float warp_total[kMmaThreads / 32];

  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / H, h = bh % H, g = h / (H / G);
  const int t0 = c * Q, nc = S / Q;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const bf16* xg = x + ((size_t)bh * S + t0) * P;
  const bf16* bg = bm + ((size_t)(b * G + g) * S + t0) * N;
  const float* dtg = dt + (size_t)bh * S + t0;
  const int n_tiles = (Q + kT - 1) / kT;

  // the first key tile is in flight while the scan runs
  load_key_tile<P, N>(tiles, bg, xg, 0, Q);
  mma::cp_async_commit();

  // cum = inclusive cumsum of dt * a: a serial run per thread over
  // consecutive steps, then a scan of the runs across the block
  const float a_h = a[h];
  const int per = (Q + kMmaThreads - 1) / kMmaThreads;
  float run = 0.f;
  for (int m = 0; m < per; ++m) {
    const int i = tid * per + m;
    if (i < Q) {
      const float d = dtg[i];
      wdec[i] = d;
      run += __fmul_rn(d, a_h);
      cum[i] = run;
    }
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  float base = incl - run;
  for (int w = 0; w < warp; ++w) base += warp_total[w];
  for (int m = 0; m < per; ++m) {
    const int i = tid * per + m;
    if (i < Q) cum[i] += base;
  }
  __syncthreads();
  const float cum_end = cum[Q - 1];
  for (int i = tid; i < round_up(Q); i += kMmaThreads) {
    if (i < Q) {
      cum_out[(size_t)bh * S + t0 + i] = cum[i];
      wdec[i] = expf(cum_end - cum[i]) * wdec[i];   // exp(cum_end - cum_j) dt_j
    } else {
      wdec[i] = 0.f;                                // the tail's zero rows
    }
  }

  float acc[L::UPW][NT][4];
#pragma unroll
  for (int u = 0; u < L::UPW; ++u)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][j][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int jt = t * kT;
    const bf16* bt = tiles + (t & 1) * L::KEY_TILE;
    const bf16* xt = bt + kT * BS;
    if (t + 1 < n_tiles)
      load_key_tile<P, N>(tiles + ((t + 1) & 1) * L::KEY_TILE, bg, xg, jt + kT, Q);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();   // tile t has landed and wdec is written

    // acc += (wdec x)^T B over the tile's 64 steps.  A = x^T from the
    // [step][p] tile by ldmatrix.trans (row step 16 kk + lane % 8 +
    // 8 (lane / 16), col p0 + 8 ((lane / 8) % 2)), scaled in registers by
    // wdec of its steps (a0, a1: 2t, 2t+1; a2, a3: 2t+8, 2t+9) and split
    // hi + lo.  B = the exact bf16 B rows by ldmatrix.trans: row step
    // 16 kk + lane % 8 + 8 ((lane / 8) % 2), col n0 + 8 (lane / 16).
#pragma unroll
    for (int u = 0; u < L::UPW; ++u) {
      const int unit = warp + 4 * u;
      if (unit >= L::UNITS) break;
      const int p0 = (unit / L::NG) * 16, n0 = (unit % L::NG) * NT * 8;
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk) {
        uint32_t xf[4], ah[4], al[4];
        mma::ldsm_x4_trans(xf, xt + (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * XS +
                                   p0 + ((lane >> 3) & 1) * 8);
        const float* wj = wdec + jt + kk * 16 + 2 * tq;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float w0 = wj[(e >> 1) * 8], w1 = wj[(e >> 1) * 8 + 1];
          // a bf16 is the top half of its float32
          mma::split_bf16(__uint_as_float(xf[e] << 16) * w0,
                          __uint_as_float(xf[e] & 0xffff0000u) * w1, ah[e], al[e]);
        }
        const int b_off = (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * BS +
                          n0 + (lane >> 4) * 8;
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t b4[4];
          mma::ldsm_x4_trans(b4, bt + b_off + np * 16);
          mma::mma_bf16(acc[u][2 * np], ah, b4[0], b4[1]);
          mma::mma_bf16(acc[u][2 * np], al, b4[0], b4[1]);
          mma::mma_bf16(acc[u][2 * np + 1], ah, b4[2], b4[3]);
          mma::mma_bf16(acc[u][2 * np + 1], al, b4[2], b4[3]);
        }
      }
    }
    __syncthreads();   // tile t is free for tile t + 2
  }

  float* sg = states + ((size_t)bh * nc + c) * P * N;
#pragma unroll
  for (int u = 0; u < L::UPW; ++u) {
    const int unit = warp + 4 * u;
    if (unit >= L::UNITS) break;
    const int p0 = (unit / L::NG) * 16, n0 = (unit % L::NG) * NT * 8;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int p = p0 + gq, n = n0 + j * 8 + 2 * tq;
      *reinterpret_cast<float2*>(sg + (size_t)p * N + n) =
          make_float2(acc[u][j][0], acc[u][j][1]);
      *reinterpret_cast<float2*>(sg + (size_t)(p + 8) * N + n) =
          make_float2(acc[u][j][2], acc[u][j][3]);
    }
  }
}

// Four consecutive state elements per thread; the local states of
// kPassAhead chunks are loaded together, so a thread has that many loads in
// flight rather than one per step of its recurrence.  The state entering
// chunk c goes out split, hi then lo, in the layout chunk_scan copies.
__global__ void __launch_bounds__(kPassThreads)
ssd_kernel_state_pass(const float* __restrict__ cum,
                      const float* __restrict__ states,
                      bf16* __restrict__ states_in, float* __restrict__ state_out,
                      int S, int Q, int PN) {
  const int bh = blockIdx.y;
  const int e = (blockIdx.x * kPassThreads + threadIdx.x) * 4;
  if (e >= PN) return;
  const int nc = S / Q;
  const float* src = states + (size_t)bh * nc * PN + e;
  bf16* dst = states_in + (size_t)bh * nc * 2 * PN + e;
  const float* cum_end = cum + (size_t)bh * S + Q - 1;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < nc; c0 += kPassAhead) {
    float4 local[kPassAhead];
    float decay[kPassAhead];
#pragma unroll
    for (int u = 0; u < kPassAhead; ++u) {
      local[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      decay[u] = 0.f;
      if (c0 + u < nc) {
        local[u] = __ldcs(reinterpret_cast<const float4*>(src + (size_t)(c0 + u) * PN));
        decay[u] = expf(cum_end[(size_t)(c0 + u) * Q]);
      }
    }
#pragma unroll
    for (int u = 0; u < kPassAhead; ++u) {
      if (c0 + u >= nc) break;
      uint32_t h01, l01, h23, l23;
      mma::split_bf16(s[0], s[1], h01, l01);
      mma::split_bf16(s[2], s[3], h23, l23);
      bf16* d = dst + (size_t)(c0 + u) * 2 * PN;
      *reinterpret_cast<uint2*>(d) = make_uint2(h01, h23);
      *reinterpret_cast<uint2*>(d + PN) = make_uint2(l01, l23);
      s[0] = s[0] * decay[u] + local[u].x;
      s[1] = s[1] * decay[u] + local[u].y;
      s[2] = s[2] * decay[u] + local[u].z;
      s[3] = s[3] * decay[u] + local[u].w;
    }
  }
  *reinterpret_cast<float4*>(state_out + (size_t)bh * PN + e) =
      make_float4(s[0], s[1], s[2], s[3]);
}

template <int P, int N>
__global__ void __launch_bounds__(kMmaThreads, MmaLayout<P, N>::scan_min_blocks)
ssd_kernel_chunk_scan(const bf16* __restrict__ x, const float* __restrict__ dt,
                      const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                      const float* __restrict__ cum_g,
                      const bf16* __restrict__ states_in, float* __restrict__ y,
                      int H, int G, int S, int Q) {
  using L = MmaLayout<P, N>;
  constexpr int XS = L::XS, BS = L::BS, KN = N / 16, NPT = P / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* cs = reinterpret_cast<bf16*>(smem_raw);   // [kT][BS] C rows of the tile
  bf16* key0 = cs + kT * BS;                       // key tile 0 (B rows, x rows)
  bf16* room = key0 + L::KEY_TILE;                 // S_in hi, lo; then key tile 1
  float* cum = reinterpret_cast<float*>(room + L::R1);   // [Q] cum * log2 e
  float* dts = cum + Q;                                   // [Q]

  const int n_qt = (Q + kT - 1) / kT;
  const int c = blockIdx.x / n_qt, i0 = (blockIdx.x % n_qt) * kT;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, g = h / (H / G);
  const int t0 = c * Q, nc = S / Q;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const bf16* xg = x + ((size_t)bh * S + t0) * P;
  const bf16* bg = bm + ((size_t)(b * G + g) * S + t0) * N;
  const bf16* cg = cm + ((size_t)(b * G + g) * S + t0) * N;
  const bf16* s_in = states_in + ((size_t)bh * nc + c) * 2 * P * N;

  load_rows<N, BS>(cs, cg, i0, Q);
  load_rows<N, BS, 2 * P>(room, s_in, 0, 2 * P);
  load_key_tile<P, N>(key0, bg, xg, 0, Q);
  mma::cp_async_commit();
  const int rows = min(Q, i0 + kT);              // steps this tile can reach
  for (int i = tid; i < rows; i += kMmaThreads) {
    cum[i] = cum_g[(size_t)bh * S + t0 + i] * kLog2e;
    dts[i] = dt[(size_t)bh * S + t0 + i];
  }
  mma::cp_async_wait<0>();
  __syncthreads();

  // this warp's 16 C rows as A fragments, read from the tile at each use
  // (registers): row lane % 16, col 8 (lane / 16) of each 16 x 16 block
  const bf16* c_frag = cs + (warp * 16 + (lane & 15)) * BS + (lane >> 4) * 8;
  int row[2];
  float cum_i[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = i0 + warp * 16 + gq + 8 * r;
    cum_i[r] = row[r] < Q ? cum[row[r]] : 0.f;
  }

  // y = exp(cum_i) C_i . (S_hi + S_lo)^T.  B = S_in^T from the [p][n]
  // tiles (non-trans): row p0 + lane % 8 + 8 (lane / 16), col 16 kk +
  // 8 ((lane / 8) % 2) -> b0, b1 of p tile p0 and of p0 + 8
  float acc[NPT][4];
#pragma unroll
  for (int j = 0; j < NPT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const int nt_ld = ((lane & 7) + ((lane >> 4) << 3)) * BS + ((lane >> 3) & 1) * 8;
  const bf16* sh = room;
  const bf16* sl = room + P * BS;
#pragma unroll
  for (int kk = 0; kk < KN; ++kk) {
    uint32_t cf[4];
    mma::ldsm_x4(cf, c_frag + kk * 16);
#pragma unroll
    for (int pp = 0; pp < P / 16; ++pp) {
      uint32_t bh4[4], bl4[4];
      mma::ldsm_x4(bh4, sh + pp * 16 * BS + nt_ld + kk * 16);
      mma::ldsm_x4(bl4, sl + pp * 16 * BS + nt_ld + kk * 16);
      mma::mma_bf16(acc[2 * pp], cf, bh4[0], bh4[1]);
      mma::mma_bf16(acc[2 * pp], cf, bl4[0], bl4[1]);
      mma::mma_bf16(acc[2 * pp + 1], cf, bh4[2], bh4[3]);
      mma::mma_bf16(acc[2 * pp + 1], cf, bl4[2], bl4[3]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float decay = row[r] < Q ? exp2f(cum_i[r]) : 0.f;
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      acc[j][2 * r] *= decay;
      acc[j][2 * r + 1] *= decay;
    }
  }
  __syncthreads();   // S_in is read: its room takes key tile 1

  // y += sum over key tiles j <= i of G x, G = (C B^T) exp(cum_i - cum_j) dt_j
  const int x_ld = ((lane & 7) + (((lane >> 3) & 1) << 3)) * XS + (lane >> 4) * 8;
  const int n_kt = (rows - 1) / kT + 1;
  const int r0 = i0 + warp * 16;                 // this warp's first row
  for (int t = 0; t < n_kt; ++t) {
    const int jt = t * kT;
    const bf16* bs = (t & 1) ? room : key0;
    const bf16* xs = bs + kT * BS;
    if (t + 1 < n_kt)
      load_key_tile<P, N>((t & 1) ? key0 : room, bg, xg, jt + kT, Q);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();   // key tile t has landed

    // the 16-key groups of this tile that the warp's rows reach: all four
    // below the diagonal, fewer on it, none past it (masked whole, skipped)
    const int groups = r0 < Q ? min(kT / 16, (r0 + 16 - jt) / 16) : 0;
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) {
      uint32_t cf[4];
      mma::ldsm_x4(cf, c_frag + kk * 16);
#pragma unroll
      for (int np = 0; np < kT / 16; ++np) {
        if (np >= groups) break;
        uint32_t b4[4];
        mma::ldsm_x4(b4, bs + np * 16 * BS + nt_ld + kk * 16);
        mma::mma_bf16(sc[2 * np], cf, b4[0], b4[1]);
        mma::mma_bf16(sc[2 * np + 1], cf, b4[2], b4[3]);
      }
    }
    // decay and dt on the float32 accumulator, selected by the mask
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = row[e >> 1], kj = jt + j * 8 + 2 * tq + (e & 1);
        float gv = 0.f;
        if (kj <= i && i < Q)
          gv = sc[j][e] * exp2f(cum_i[e >> 1] - cum[kj]) * dts[kj];
        sc[j][e] = gv;
      }
    // y += (G_hi + G_lo) x.  B = x from the [step][p] tile by
    // ldmatrix.trans: row step 16 kk + lane % 8 + 8 ((lane / 8) % 2),
    // col p0 + 8 (lane / 16)
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      if (kk >= groups) break;
      uint32_t gh[4], gl[4];
      mma::split_bf16(sc[2 * kk][0], sc[2 * kk][1], gh[0], gl[0]);
      mma::split_bf16(sc[2 * kk][2], sc[2 * kk][3], gh[1], gl[1]);
      mma::split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], gh[2], gl[2]);
      mma::split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], gh[3], gl[3]);
#pragma unroll
      for (int pp = 0; pp < P / 16; ++pp) {
        uint32_t b4[4];
        mma::ldsm_x4_trans(b4, xs + kk * 16 * XS + x_ld + pp * 16);
        mma::mma_bf16(acc[2 * pp], gh, b4[0], b4[1]);
        mma::mma_bf16(acc[2 * pp], gl, b4[0], b4[1]);
        mma::mma_bf16(acc[2 * pp + 1], gh, b4[2], b4[3]);
        mma::mma_bf16(acc[2 * pp + 1], gl, b4[2], b4[3]);
      }
    }
    __syncthreads();   // key tile t is free for tile t + 2
  }

  // y is written once and read by the next layer's glue: streaming stores
  float* yg = y + ((size_t)bh * S + t0) * P;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= Q) continue;
#pragma unroll
    for (int j = 0; j < NPT; ++j)
      __stcs(reinterpret_cast<float2*>(yg + (size_t)row[r] * P + j * 8 + 2 * tq),
             make_float2(acc[j][2 * r], acc[j][2 * r + 1]));
  }
}

// ---------------------------------------------------------------------------
// bfloat16 chunk scan at (P, N) = (64, 64), (64, 128), chunks up to 256:
// one persistent block per SM over whole chunks, TMA, wgmma
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 384;        // producer warpgroup + two consumer warpgroups
constexpr int kWgMaxChunk = 256;       // ../ssd_scan.py WGMMA_MAX_CHUNK
constexpr int kTileBytes = 64 * 128;   // 64 rows of one 64-column swizzled bf16 tile

template <int P, int N>
constexpr bool wgmma_pn() {
  return P == 64 && (N == 64 || N == 128);
}

template <int P, int N>
struct WgLayout {
  static_assert(wgmma_pn<P, N>(), "the wgmma chunk scan takes P 64, N 64 or 128");
  static constexpr int NB = N / 64;          // 64-column tiles of a row of B, C, S_in
  // tile i of a chunk (steps 64 i .. 64 i + 63): C rows, B rows, x rows
  static constexpr int tile = (2 * NB + 1) * kTileBytes;
  static constexpr int s_in = 2 * NB * kTileBytes;   // S_in (P = 64 rows) hi, then lo
  // ring depths (why: the note at the top): tile slots and S_in buffers
  static constexpr int slots = N == 64 ? 7 : 4;
  static constexpr int s_bufs = N == 64 ? 2 : 1;
  static constexpr int cd = 3 * kWgMaxChunk * 4;     // cum * log2 e, dt, w of a chunk
  // registers per thread after setmaxnreg: launched at 168 (65536 / 384),
  // the producer's threads keep 40 and the consumers' take 232
  // (40 x 128 + 232 x 256 = 64,512 of the 65,536)
  static constexpr int producer_regs = 40;
  static constexpr int consumer_regs = 232;
  // 1024 bytes of slack align the swizzled tiles; two cum/dt/w buffers
  static constexpr int bytes = 1024 + slots * tile + s_bufs * s_in + 2 * cd;
  static_assert(slots * 64 >= kWgMaxChunk, "a chunk's tiles fit in the ring");
  static_assert(bytes <= 232448 - 1024, "dynamic shared memory of one block");
};

// The query tiles (bit t: rows 64 t .. 64 t + 63) of consumer c among a
// chunk's nq tiles: from the heaviest (tile nq - 1, nq key tiles) down,
// each to the consumer with fewer (query tile, key tile) pairs so far,
// consumer 0 on a tie.  At 4 tiles: consumer 0 {0, 3}, consumer 1 {1, 2},
// 5 pairs each.  ../ssd_scan.py consumer_tiles is the same rule.
__host__ __device__ __forceinline__ unsigned consumer_tiles(int nq, int c) {
  int load0 = 0, load1 = 0;
  unsigned mask0 = 0u, mask1 = 0u;
  for (int t = nq - 1; t >= 0; --t) {
    if (load1 < load0) {
      load1 += t + 1;
      mask1 |= 1u << t;
    } else {
      load0 += t + 1;
      mask0 |= 1u << t;
    }
  }
  return c ? mask1 : mask0;
}

// unit u of a launch: chunk c of head bh, chunks fastest (the order of x
// and y in memory); bank = b G + h / (H / G)
struct Unit {
  int bh, c, bank;
};

__device__ __forceinline__ Unit unit_at(int u, int H, int G, int nc) {
  const int c = u % nc, bh = u / nc;
  const int b = bh / H, h = bh % H;
  return Unit{bh, c, b * G + h / (H / G)};
}

// the per-warp arrival that frees a buffer (barriers freed by the consumers
// count 8 arrivals: 4 warps of each)
__device__ __forceinline__ void warp_arrive(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) wg::mbar_arrive(bar);
}

// acc (64 x 64) [+]= A (64 x N, K-major, NB tiles at a) B^T (64 x N,
// K-major, NB tiles at b) over N / 16 k-steps; scale_first 0 drops acc
template <int N>
__device__ __forceinline__ void mma_kmajor(float (&acc)[32], uint32_t a, uint32_t b,
                                           int scale_first) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    // 16 columns are 32 bytes; the next 64 columns are the next tile
    const uint32_t off = (kk >> 2) * kTileBytes + (kk & 3) * 32;
    wg::mma_ss_n64(acc, wg::desc(a + off, 16, 1024), wg::desc(b + off, 16, 1024),
                   kk > 0 || scale_first);
  }
}

// x0, x1 as bf16 hi + lo, packed (x0 in the low half): hi is x truncated
// to bf16 (its upper 16 bits, one byte permute), lo = bf16(x - hi) (x - hi
// is exact in float32), so hi + lo carries x to ~2^-16 of its size with
// one conversion a pair (../ssd_scan.py _split_trunc)
__device__ __forceinline__ void split_trunc(float x0, float x1, uint32_t& hi,
                                            uint32_t& lo) {
  const uint32_t b0 = __float_as_uint(x0), b1 = __float_as_uint(x1);
  hi = __byte_perm(b0, b1, 0x7632);
  const float r0 = x0 - __uint_as_float(b0 & 0xffff0000u);
  const float r1 = x1 - __uint_as_float(b1 & 0xffff0000u);
  const __nv_bfloat162 l = __floats2bfloat162_rn(r0, r1);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// 2^x, flushing a result below 2^-126 to zero (a decay that small adds
// nothing at float32's precision)
__device__ __forceinline__ float ex2_ftz(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// S (64 x 64, the accumulator of C_q B_j^T) on the diagonal key tile ->
// G = S exp(cum_i - cum_j) dt_j where j <= i < Q, else 0: selected, never
// multiplied by the mask (exp(cum_i - cum_j) is inf for some j > i).  Rows
// i0 and i0 + 8 (cum ci), key tile from step k0; cum and dt of the unit
__device__ __forceinline__ void decay_diagonal(float (&s)[32], const float* cum,
                                               const float* dts, const float (&ci)[2],
                                               int i0, int k0, int t, int Q) {
#pragma unroll
  for (int jb = 0; jb < 8; ++jb) {
    const int kj = k0 + 8 * jb + 2 * t;
    const float2 cj = *reinterpret_cast<const float2*>(cum + kj);
    const float2 dj = *reinterpret_cast<const float2*>(dts + kj);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + 8 * (e >> 1), kk = kj + (e & 1);
      const float cjv = (e & 1) ? cj.y : cj.x, djv = (e & 1) ? dj.y : dj.x;
      const float v = s[4 * jb + e] * ex2_ftz(ci[e >> 1] - cjv) * djv;
      s[4 * jb + e] = kk <= i && i < Q ? v : 0.f;
    }
  }
}

// S on a key tile below the diagonal (every step j of it before every row
// i): exp(cum_i - cum_j) dt_j = exp(cum_i - cum_e) w_j with cum_e the key
// tile's last step and w_j = exp(cum_e - cum_j) dt_j, which the unit's w
// holds.  Exact for any cum, and where cum does not increase (a <= 0,
// dt >= 0, as Mamba2's parametrisation gives) both factors are at most 1.
// Two exponentials a thread (its rows) in place of 32; a row at or past Q
// takes factor 0 (its C row is zero, and exp(0 - cum_e) may be inf)
__device__ __forceinline__ void decay_below(float (&s)[32], const float* cum,
                                            const float* w, const float (&ci)[2],
                                            int i0, int k0, int t, int Q) {
  const float ce = cum[k0 + 63];
  const float r0 = i0 < Q ? ex2_ftz(ci[0] - ce) : 0.f;
  const float r1 = i0 + 8 < Q ? ex2_ftz(ci[1] - ce) : 0.f;
#pragma unroll
  for (int jb = 0; jb < 8; ++jb) {
    const float2 wj = *reinterpret_cast<const float2*>(w + k0 + 8 * jb + 2 * t);
    s[4 * jb] *= wj.x * r0;
    s[4 * jb + 1] *= wj.y * r0;
    s[4 * jb + 2] *= wj.x * r1;
    s[4 * jb + 3] *= wj.y * r1;
  }
}

// G (the accumulator layout of S is the A fragment of G x) as bf16 hi + lo
__device__ __forceinline__ void split_g(const float (&s)[32], uint32_t (&ph)[4][4],
                                        uint32_t (&pl)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_trunc(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], ph[kk][r], pl[kk][r]);
}

// y += (G_hi + G_lo) x_j: two register-A products per 16 steps on the x
// tile at xt ((64 steps, P), MN-major: 16 steps are 2048 bytes)
__device__ __forceinline__ void gx(float (&y)[32], const uint32_t (&ph)[4][4],
                                   const uint32_t (&pl)[4][4], uint32_t xt) {
  wg::mma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t dx = wg::desc(xt + kk * 2048, kTileBytes, 1024);
    wg::mma_rs_n64(y, ph[kk], dx);
    wg::mma_rs_n64(y, pl[kk], dx);
  }
}

template <int P, int N>
__global__ void __launch_bounds__(kWgThreads, 1)
ssd_wgmma_chunk_scan(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tb,
                     const __grid_constant__ CUtensorMap tc,
                     const __grid_constant__ CUtensorMap ts,
                     const float* __restrict__ dt, const float* __restrict__ cum_g,
                     float* __restrict__ y, int H, int G, int S, int Q, int n_units) {
  using L = WgLayout<P, N>;
  constexpr int NB = L::NB, SLOTS = L::slots, SB = L::s_bufs;
  extern __shared__ unsigned char smem_raw[];
  // s_full[SB], s_empty[SB], t_full[SLOTS], t_empty[SLOTS], cd_full[2], cd_empty[2]
  __shared__ __align__(8) uint64_t bars[2 * SB + 2 * SLOTS + 4];
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t tiles = base;                        // [slot][C, B, x]
  const uint32_t s_in = base + SLOTS * L::tile;       // [buffer][hi, lo]
  float* const cd = reinterpret_cast<float*>(smem_raw + (s_in + SB * L::s_in - raw));
  const uint32_t s_full0 = wg::smem_u32(&bars[0]);
  const uint32_t s_empty0 = wg::smem_u32(&bars[SB]);
  const uint32_t t_full0 = wg::smem_u32(&bars[2 * SB]);
  const uint32_t t_empty0 = wg::smem_u32(&bars[2 * SB + SLOTS]);
  const uint32_t cd_full0 = wg::smem_u32(&bars[2 * SB + 2 * SLOTS]);
  const uint32_t cd_empty0 = wg::smem_u32(&bars[2 * SB + 2 * SLOTS + 2]);
  const int nc = S / Q, nq = (Q + 63) / 64;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int b = 0; b < SB; ++b) {
      wg::mbar_init(s_full0 + 8 * b, 1);
      wg::mbar_init(s_empty0 + 8 * b, 8);
    }
    for (int s = 0; s < SLOTS; ++s) {
      wg::mbar_init(t_full0 + 8 * s, 1);
      wg::mbar_init(t_empty0 + 8 * s, 8);
    }
    for (int b = 0; b < 2; ++b) {
      wg::mbar_init(cd_full0 + 8 * b, 32);   // one arrival per lane of warp 1
      wg::mbar_init(cd_empty0 + 8 * b, 8);
    }
    wg::mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup, read from lane 0 so that the compiler sees it uniform
  // across each warp: setmaxnreg then takes hold for the branch it opens
  const int role = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  if (role == 0) {
    wg::setmaxnreg_dec<L::producer_regs>();
    if (warp == 0 && lane == 0) {
      // ---- TMA: each unit's S_in, then its tiles through the ring --------
      int e = 0;   // tiles through the ring so far
      for (int k = 0;; ++k) {
        const int u = k * gridDim.x + blockIdx.x;
        if (u >= n_units) break;
        const Unit un = unit_at(u, H, G, nc);
        const int sb = k % SB;
        // a fresh barrier passes the wait for parity 1: the first pass over
        // each buffer finds it free
        wg::mbar_wait(s_empty0 + 8 * sb, ((k / SB) & 1) ^ 1);
        wg::mbar_arrive_expect_tx(s_full0 + 8 * sb, L::s_in);
        for (int half = 0; half < 2; ++half)
          for (int b = 0; b < NB; ++b)
            wg::tma_load_3d(s_in + sb * L::s_in + (half * NB + b) * kTileBytes, &ts,
                            s_full0 + 8 * sb, 64 * b, P * half, un.bh * nc + un.c);
        for (int i = 0; i < nq; ++i, ++e) {
          const int s = e % SLOTS;
          wg::mbar_wait(t_empty0 + 8 * s, ((e / SLOTS) & 1) ^ 1);
          wg::mbar_arrive_expect_tx(t_full0 + 8 * s, L::tile);
          const uint32_t dst = tiles + s * L::tile;
          for (int b = 0; b < NB; ++b) {
            wg::tma_load_4d(dst + b * kTileBytes, &tc, t_full0 + 8 * s, 64 * b, 64 * i,
                            un.c, un.bank);
            wg::tma_load_4d(dst + (NB + b) * kTileBytes, &tb, t_full0 + 8 * s, 64 * b,
                            64 * i, un.c, un.bank);
          }
          wg::tma_load_4d(dst + 2 * NB * kTileBytes, &tx, t_full0 + 8 * s, 0, 64 * i,
                          un.c, un.bh);
        }
      }
    } else if (warp == 1) {
      // ---- cum * log2 e, dt and w_j = exp(cum_e - cum_j) dt_j (cum_e the
      // last step of j's tile) of each unit, zero past Q: every load of a
      // unit is issued at once, before the wait for its buffer -------------
      constexpr int R = kWgMaxChunk / 32;
      for (int k = 0;; ++k) {
        const int u = k * gridDim.x + blockIdx.x;
        if (u >= n_units) break;
        const Unit un = unit_at(u, H, G, nc);
        const size_t off = (size_t)un.bh * S + (size_t)un.c * Q;
        float cv[R], dv[R];
#pragma unroll
        for (int m = 0; m < R; ++m) {
          const int r = lane + 32 * m;
          cv[m] = r < Q ? cum_g[off + r] : 0.f;
          dv[m] = r < Q ? dt[off + r] : 0.f;
        }
        const int b = k & 1;
        wg::mbar_wait(cd_empty0 + 8 * b, ((k >> 1) & 1) ^ 1);
        float* cum = cd + b * 3 * kWgMaxChunk;
#pragma unroll
        for (int m = 0; m < R; ++m) {
          const int r = lane + 32 * m;
          const float cl = cv[m] * kLog2e;
          // step 64 (m / 2) + 63 is lane 31 of m | 1
          const float ce = __shfl_sync(0xffffffffu, cv[m | 1], 31) * kLog2e;
          if (r < nq * 64) {
            cum[r] = cl;
            cum[kWgMaxChunk + r] = dv[m];
            cum[2 * kWgMaxChunk + r] = ex2_ftz(ce - cl) * dv[m];
          }
        }
        wg::mbar_arrive(cd_full0 + 8 * b);   // releases this lane's stores
      }
    }
    return;
  }

  // ---- consumers: query tiles of 64 rows, by consumer_tiles --------------
  wg::setmaxnreg_inc<L::consumer_regs>();
  const int g = lane >> 2, t = lane & 3;
  const unsigned mine = consumer_tiles(nq, role - 1);
  const int q_last = mine ? 31 - __clz(mine) : -1;   // its last query tile
  float yacc[32], sacc[32];
  uint32_t ph[4][4], pl[4][4];
#pragma unroll
  for (int r = 0; r < 32; ++r) yacc[r] = sacc[r] = 0.f;
  for (int k = 0;; ++k) {
    const int u = k * gridDim.x + blockIdx.x;
    if (u >= n_units) break;
    const Unit un = unit_at(u, H, G, nc);
    const int sb = k % SB, e0 = k * nq;
    const uint32_t sd = s_in + sb * L::s_in;
    wg::mbar_wait(cd_full0 + 8 * (k & 1), (k >> 1) & 1);
    const float* cum = cd + (k & 1) * 3 * kWgMaxChunk;
    const float* dts = cum + kWgMaxChunk;
    const float* w = cum + 2 * kWgMaxChunk;
    float* yg = y + ((size_t)un.bh * S + (size_t)un.c * Q) * P;

    for (int q = 0; q < nq; ++q) {
      if (!((mine >> q) & 1u)) continue;
      const int eq = e0 + q;
      const uint32_t ct = tiles + (eq % SLOTS) * L::tile;   // C rows of tile q
      wg::mbar_wait(t_full0 + 8 * (eq % SLOTS), (eq / SLOTS) & 1);
      wg::mbar_wait(s_full0 + 8 * sb, (k / SB) & 1);
      wg::mbar_wait(t_full0 + 8 * (e0 % SLOTS), (e0 / SLOTS) & 1);
      const uint32_t b0 = tiles + (e0 % SLOTS) * L::tile + NB * kTileBytes;

      // S of key tile 0, then y = C_q . (S_hi + S_lo)^T (S_in is (P, N),
      // K-major): S's decay runs while the inter-chunk product is on the
      // tensor cores
      wg::fence_regs(yacc);
      wg::fence_regs(sacc);
      wg::mma_fence();
      mma_kmajor<N>(sacc, ct, b0, 0);
      wg::mma_commit();
      mma_kmajor<N>(yacc, ct, sd, 0);
      mma_kmajor<N>(yacc, ct, sd + NB * kTileBytes, 1);
      wg::mma_commit();
      const int i0 = 64 * q + 16 * warp + g;             // rows i0, i0 + 8
      const float ci[2] = {cum[i0], cum[i0 + 8]};
      wg::mma_wait<1>();
      wg::fence_regs(sacc);
      if (q == 0)
        decay_diagonal(sacc, cum, dts, ci, i0, 0, t, Q);
      else
        decay_below(sacc, cum, w, ci, i0, 0, t, Q);
      wg::mma_wait<0>();
      wg::fence_regs(yacc);
      if (q == q_last) warp_arrive(s_empty0 + 8 * sb, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h) {                      // times exp(cum_i), 0 past Q
        const float scale = i0 + 8 * h < Q ? exp2f(ci[h]) : 0.f;
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
          yacc[4 * jb + 2 * h] *= scale;
          yacc[4 * jb + 2 * h + 1] *= scale;
        }
      }
      split_g(sacc, ph, pl);

      // y += sum over key tiles j <= q of (G_hi + G_lo) x_j.  S of tile
      // j + 1 is issued before G x_j, and its decay runs while that product
      // is on the tensor cores; G is split once the product is done (the
      // last product is issued after the loop: a loop body without
      // branches around a wgmma keeps both in flight)
      for (int j = 0; j < q; ++j) {
        const int ej = e0 + j, s0 = ej % SLOTS, s1 = (ej + 1) % SLOTS;
        wg::mbar_wait(t_full0 + 8 * s1, ((ej + 1) / SLOTS) & 1);
        const uint32_t bt1 = tiles + s1 * L::tile + NB * kTileBytes;
        wg::fence_regs(sacc);
        wg::mma_fence();
        mma_kmajor<N>(sacc, ct, bt1, 0);
        wg::mma_commit();
        wg::fence_regs(yacc);
        gx(yacc, ph, pl, tiles + s0 * L::tile + 2 * NB * kTileBytes);
        wg::mma_commit();
        wg::mma_wait<1>();
        wg::fence_regs(sacc);
        if (j + 1 == q)
          decay_diagonal(sacc, cum, dts, ci, i0, 64 * (j + 1), t, Q);
        else
          decay_below(sacc, cum, w, ci, i0, 64 * (j + 1), t, Q);
        wg::mma_wait<0>();
        wg::fence_regs(yacc);
        // this consumer's last query tile is its last use of every tile j
        if (q == q_last) warp_arrive(t_empty0 + 8 * s0, lane);
        split_g(sacc, ph, pl);
      }
      {
        const int s0 = eq % SLOTS;
        wg::fence_regs(yacc);
        gx(yacc, ph, pl, tiles + s0 * L::tile + 2 * NB * kTileBytes);
        wg::mma_commit();
        wg::mma_wait<0>();
        wg::fence_regs(yacc);
        if (q == q_last) warp_arrive(t_empty0 + 8 * s0, lane);
      }

      // y is written once and read by the next layer's glue: streaming
      // stores straight from the accumulator (256 contiguous bytes a row)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + 8 * h;
        if (i >= Q) continue;
#pragma unroll
        for (int jb = 0; jb < 8; ++jb)
          __stcs(reinterpret_cast<float2*>(yg + (size_t)i * P + jb * 8 + 2 * t),
                 make_float2(yacc[4 * jb + 2 * h], yacc[4 * jb + 2 * h + 1]));
      }
    }

    // pass through what this consumer does not read: the tiles past its
    // last query tile and, with no query tile, S_in (every consumer warp
    // arrives once on each buffer's "empty" barrier, after its "full" phase)
    for (int j = q_last + 1; j < nq; ++j) {
      const int ej = e0 + j;
      wg::mbar_wait(t_full0 + 8 * (ej % SLOTS), (ej / SLOTS) & 1);
      warp_arrive(t_empty0 + 8 * (ej % SLOTS), lane);
    }
    if (q_last < 0) {
      wg::mbar_wait(s_full0 + 8 * sb, (k / SB) & 1);
      warp_arrive(s_empty0 + 8 * sb, lane);
    }
    warp_arrive(cd_empty0 + 8 * (k & 1), lane);
  }
}

template <int P, int N>
int launch_wgmma_scan(const bf16* x, const float* dt, const bf16* bm, const bf16* cm,
                      const float* cum, const bf16* states_in, float* y, int B, int H,
                      int G, int S, int Q, cudaStream_t stream) {
  using L = WgLayout<P, N>;
  const int nc = S / Q;
  // 4-D maps (columns, Q, nc, banks or heads): a box past a chunk's last
  // step reads zeros, never the next chunk's rows
  const cuuint64_t xd[4] = {(cuuint64_t)P, (cuuint64_t)Q, (cuuint64_t)nc,
                            (cuuint64_t)B * H};
  const cuuint64_t bd[4] = {(cuuint64_t)N, (cuuint64_t)Q, (cuuint64_t)nc,
                            (cuuint64_t)B * G};
  const cuuint64_t sd[3] = {(cuuint64_t)N, 2 * (cuuint64_t)P, (cuuint64_t)B * H * nc};
  CUtensorMap tx, tb, tc, ts;
  int err = tma::bf16_map(&tx, x, 4, xd, 64);
  if (!err) err = tma::bf16_map(&tb, bm, 4, bd, 64);
  if (!err) err = tma::bf16_map(&tc, cm, 4, bd, 64);
  if (!err) err = tma::bf16_map(&ts, states_in, 3, sd, 64);
  if (err) return err;
  auto kernel = ssd_wgmma_chunk_scan<P, N>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
  if (e != cudaSuccess) return (int)e;
  // one persistent block per SM (at most one per unit)
  int device = 0, sms = 0;
  e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const long long units = (long long)B * H * nc;
  if (units > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int grid = (int)(units < sms ? units : sms);
  kernel<<<grid, kWgThreads, L::bytes, stream>>>(tx, tb, tc, ts, dt, cum, y, H, G, S, Q,
                                                 (int)units);
  return (int)cudaGetLastError();
}

// which chunk-scan kernel a bf16 call of (P, N, Q) runs: the wgmma kernel
// at (64, 64) and (64, 128) up to kWgMaxChunk, else ssd_kernel_chunk_scan
// (../ssd_scan.py BF16_CHUNK_SCAN)
template <int P, int N>
constexpr bool use_wgmma_scan(int Q) {
  return wgmma_pn<P, N>() && Q <= kWgMaxChunk;
}

template <int P, int N>
int launch_mma(const void* x, const float* dt, const float* a, const void* bm,
               const void* cm, float* y, float* state, float* cum,
               float* states, bf16* states_in, int B, int H, int G, int S,
               int Q, cudaStream_t stream) {
  using L = MmaLayout<P, N>;
  const int nc = S / Q, n_bh = B * H;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* bb = static_cast<const bf16*>(bm);
  const bf16* cb = static_cast<const bf16*>(cm);

  const size_t state_bytes = L::state_bytes(Q);
  cudaError_t err = cudaFuncSetAttribute(ssd_kernel_chunk_state<P, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)state_bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_kernel_chunk_state<P, N><<<dim3(nc, n_bh), kMmaThreads, state_bytes, stream>>>(
      xb, dt, a, bb, cum, states, H, G, S, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int pass_blocks = (P * N / 4 + kPassThreads - 1) / kPassThreads;
  ssd_kernel_state_pass<<<dim3(pass_blocks, n_bh), kPassThreads, 0, stream>>>(
      cum, states, states_in, state, S, Q, P * N);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  if constexpr (wgmma_pn<P, N>())
    if (use_wgmma_scan<P, N>(Q))
      return launch_wgmma_scan<P, N>(xb, dt, bb, cb, cum, states_in, y, B, H, G, S, Q,
                                     stream);
  const size_t scan_bytes = L::scan_bytes(Q);
  err = cudaFuncSetAttribute(ssd_kernel_chunk_scan<P, N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)scan_bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (Q + kT - 1) / kT;
  ssd_kernel_chunk_scan<P, N><<<dim3(nc * n_qt, n_bh), kMmaThreads, scan_bytes,
                                stream>>>(xb, dt, bb, cb, cum, states_in, y, H, G,
                                          S, Q);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: one block per (batch, head) on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;    // 16 x 16

template <int P, int N>
struct Layout {
  static constexpr int NS = N + 1;     // odd stride: column reads conflict-free
  static constexpr int GS = kT + 4;    // score tile stride
  static constexpr int floats_fixed =
      P * NS + 2 * kT * NS + kT * P + kT * GS;
  static size_t bytes(int q) { return sizeof(float) * (floats_fixed + 2 * q); }
};

template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a, const float* __restrict__ bm,
           const float* __restrict__ cm, float* __restrict__ y,
           float* __restrict__ state_out, int H, int G, int S, int Q) {
  using L = Layout<P, N>;
  constexpr int NP = P / 16, NN = N / 16;
  extern __shared__ float smem[];
  float* st = smem;                  // [P][NS]  state for the inter-chunk term
  float* cs = st + P * L::NS;        // [kT][NS] C rows of the query tile
  float* bs = cs + kT * L::NS;       // [kT][NS] B rows of the key tile
  float* xs = bs + kT * L::NS;       // [kT][P]  dax rows of the key tile
  float* gs = xs + kT * P;           // [kT][GS] masked score tile
  float* cum = gs + kT * L::GS;      // [Q]
  float* dts = cum + Q;              // [Q]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const float a_h = a[h];
  const float* xg = x + (size_t)bh * S * P;
  const float* dtg = dt + (size_t)bh * S;
  const float* bg = bm + (size_t)(b * G + g) * S * N;
  const float* cg = cm + (size_t)(b * G + g) * S * N;
  float* yg = y + (size_t)bh * S * P;

  float s_reg[NP][NN];               // this thread's share of the state
#pragma unroll
  for (int i = 0; i < NP; ++i)
#pragma unroll
    for (int j = 0; j < NN; ++j) s_reg[i][j] = 0.f;
  for (int e = tid; e < P * L::NS; e += kThreads) st[e] = 0.f;

  for (int t0 = 0; t0 < S; t0 += Q) {
    // cum = inclusive cumsum of dt * a over the chunk (Hillis-Steele)
    for (int i = tid; i < Q; i += kThreads) {
      dts[i] = dtg[t0 + i];
      cum[i] = dts[i] * a_h;
    }
    __syncthreads();
    for (int off = 1; off < Q; off <<= 1) {
      float add[kMaxChunk / kThreads];
#pragma unroll
      for (int m = 0; m < kMaxChunk / kThreads; ++m) {
        const int i = tid + m * kThreads;
        add[m] = 0.f;
        if (i < Q && i >= off) add[m] = cum[i - off];
      }
      __syncthreads();
#pragma unroll
      for (int m = 0; m < kMaxChunk / kThreads; ++m) {
        const int i = tid + m * kThreads;
        if (i < Q) cum[i] += add[m];
      }
      __syncthreads();
    }
    const float cum_end = cum[Q - 1];

    // ---- outputs: one 64-row query tile at a time ------------------------
    for (int it = 0; it < Q; it += kT) {
      float y_acc[4][NP];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int p = 0; p < NP; ++p) y_acc[i][p] = 0.f;

      for (int jt = 0; jt <= it; jt += kT) {
        __syncthreads();   // cs, bs, xs and gs are free
        for (int e = tid; e < kT * N; e += kThreads) {
          const int r = e / N, n = e % N;
          float bv = 0.f;
          if (jt + r < Q) bv = bg[(size_t)(t0 + jt + r) * N + n];
          bs[r * L::NS + n] = bv;
          if (jt == 0) {
            float cv = 0.f;
            if (it + r < Q) cv = cg[(size_t)(t0 + it + r) * N + n];
            cs[r * L::NS + n] = cv;
          }
        }
        for (int e = tid; e < kT * P; e += kThreads) {
          const int r = e / P, p = e % P;
          float xv = 0.f;
          if (jt + r < Q) xv = xg[(size_t)(t0 + jt + r) * P + p] * dts[jt + r];
          xs[e] = xv;
        }
        __syncthreads();

        // masked score tile: G_ij = (C_i . B_j) exp(cum_i - cum_j), j <= i
        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = cs[(ty * 4 + i) * L::NS + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = bs[(tx + 16 * j) * L::NS + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(cv[i], bv[j], sc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int li = it + ty * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int lj = jt + tx + 16 * j;
            float gv = 0.f;   // selected, never multiplied by the mask
            if (lj <= li && li < Q) gv = sc[i][j] * expf(cum[li] - cum[lj]);
            gs[(ty * 4 + i) * L::GS + tx + 16 * j] = gv;
          }
        }
        __syncthreads();

#pragma unroll 4
        for (int j = 0; j < kT; ++j) {
          float gv[4], xv[NP];
#pragma unroll
          for (int i = 0; i < 4; ++i) gv[i] = gs[(ty * 4 + i) * L::GS + j];
#pragma unroll
          for (int p = 0; p < NP; ++p) xv[p] = xs[j * P + tx + 16 * p];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int p = 0; p < NP; ++p) y_acc[i][p] = fmaf(gv[i], xv[p], y_acc[i][p]);
        }
      }

      // inter-chunk term: y_i += exp(cum_i) * C_i . S_prev^T
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int li = it + ty * 4 + i;
        if (li >= Q) continue;
        const float decay = expf(cum[li]);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const float* srow = st + (tx + 16 * p) * L::NS;
          const float* crow = cs + (ty * 4 + i) * L::NS;
          float dot = 0.f;
#pragma unroll 8
          for (int n = 0; n < N; ++n) dot = fmaf(crow[n], srow[n], dot);
          yg[(size_t)(t0 + li) * P + tx + 16 * p] = y_acc[i][p] + decay * dot;
        }
      }
    }

    // ---- state: S = exp(cum_end) S + sum_j exp(cum_end - cum_j) dax_j B_j
    const float chunk_decay = expf(cum_end);
#pragma unroll
    for (int i = 0; i < NP; ++i)
#pragma unroll
      for (int j = 0; j < NN; ++j) s_reg[i][j] *= chunk_decay;
    for (int jt = 0; jt < Q; jt += kT) {
      __syncthreads();   // every read of st, bs and xs so far is done
      for (int e = tid; e < kT * N; e += kThreads) {
        const int r = e / N, n = e % N;
        float bv = 0.f;
        if (jt + r < Q) bv = bg[(size_t)(t0 + jt + r) * N + n];
        bs[r * L::NS + n] = bv;
      }
      for (int e = tid; e < kT * P; e += kThreads) {
        const int r = e / P, p = e % P;
        const int j = jt + r;
        float xv = 0.f;
        if (j < Q)
          xv = xg[(size_t)(t0 + j) * P + p] * dts[j] * expf(cum_end - cum[j]);
        xs[e] = xv;
      }
      __syncthreads();
#pragma unroll 2
      for (int r = 0; r < kT; ++r) {
        float xv[NP], bv[NN];
#pragma unroll
        for (int i = 0; i < NP; ++i) xv[i] = xs[r * P + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < NN; ++j) bv[j] = bs[r * L::NS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < NP; ++i)
#pragma unroll
          for (int j = 0; j < NN; ++j) s_reg[i][j] = fmaf(xv[i], bv[j], s_reg[i][j]);
      }
    }
    __syncthreads();   // st is read by no one now
#pragma unroll
    for (int i = 0; i < NP; ++i)
#pragma unroll
      for (int j = 0; j < NN; ++j) st[(ty + 16 * i) * L::NS + tx + 16 * j] = s_reg[i][j];
    __syncthreads();
  }

  float* sg = state_out + (size_t)bh * P * N;
#pragma unroll
  for (int i = 0; i < NP; ++i)
#pragma unroll
    for (int j = 0; j < NN; ++j) sg[(ty + 16 * i) * N + tx + 16 * j] = s_reg[i][j];
}

template <int P, int N>
int launch_f32(const void* x, const float* dt, const float* a, const void* bm,
               const void* cm, float* y, float* state, int B, int H, int G,
               int S, int Q, cudaStream_t stream) {
  const size_t bytes = Layout<P, N>::bytes(Q);
  auto kernel = ssd_kernel<P, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * H, kThreads, bytes, stream>>>(
      static_cast<const float*>(x), dt, a, static_cast<const float*>(bm),
      static_cast<const float*>(cm), y, state, H, G, S, Q);
  return (int)cudaGetLastError();
}

// blocks resident per SM of each kernel a call of (P, N, Q, dtype) runs,
// as the occupancy calculator derives them from registers and shared
// memory: bf16 chunk_state, state_pass, chunk_scan; float32 ssd_kernel
// alone (the other two entries 0)
template <int P, int N>
int occupancy(int Q, int dtype, int* blocks, int* threads, int* smem_bytes) {
  using L = MmaLayout<P, N>;
  const void* fns[3] = {(const void*)ssd_kernel<P, N>, nullptr, nullptr};
  threads[0] = kThreads;
  smem_bytes[0] = (int)Layout<P, N>::bytes(Q);
  threads[1] = threads[2] = smem_bytes[1] = smem_bytes[2] = 0;
  if (dtype == 1) {
    fns[0] = (const void*)ssd_kernel_chunk_state<P, N>;
    fns[1] = (const void*)ssd_kernel_state_pass;
    fns[2] = (const void*)ssd_kernel_chunk_scan<P, N>;
    threads[0] = threads[2] = kMmaThreads;
    threads[1] = kPassThreads;
    smem_bytes[0] = (int)L::state_bytes(Q);
    smem_bytes[2] = (int)L::scan_bytes(Q);
    if constexpr (wgmma_pn<P, N>())
      if (use_wgmma_scan<P, N>(Q)) {
        fns[2] = (const void*)ssd_wgmma_chunk_scan<P, N>;
        threads[2] = kWgThreads;
        smem_bytes[2] = WgLayout<P, N>::bytes;
      }
  } else if (dtype != 0) {
    return (int)cudaErrorInvalidValue;
  }
  for (int i = 0; i < 3; ++i) {
    blocks[i] = 0;
    if (fns[i] == nullptr) continue;
    cudaError_t err = cudaFuncSetAttribute(
        fns[i], cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes[i]);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks[i], fns[i],
                                                          threads[i], smem_bytes[i]);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// the bf16 chunk-scan kernel of (P, N, Q): 1 for ssd_wgmma_chunk_scan
// (with the query tiles of consumer 0 as a bit mask, the ring's tile slots
// and S_in buffers), 0 for ssd_kernel_chunk_scan (the other three 0)
template <int P, int N>
int bf16_chunk_scan(int Q, int* wgmma, int* consumer0, int* slots, int* s_bufs) {
  *wgmma = *consumer0 = *slots = *s_bufs = 0;
  if constexpr (wgmma_pn<P, N>())
    if (use_wgmma_scan<P, N>(Q)) {
      *wgmma = 1;
      *consumer0 = (int)consumer_tiles((Q + 63) / 64, 0);
      *slots = WgLayout<P, N>::slots;
      *s_bufs = WgLayout<P, N>::s_bufs;
    }
  return 0;
}

// (P, N) pairs compiled in: ../ssd_scan.py SUPPORTED_PN
#define SSD_SHAPES(X) X(16, 16) X(32, 64) X(64, 64) X(64, 128) X(128, 128)

}  // namespace

extern "C" {

// dtype of x, bmat and cmat: 0 float32, 1 bfloat16.  chunk (Q) divides S
// and is at most kMaxChunk.  The bfloat16 path takes three scratches from
// the caller, cum (B, H, S) float32, states (B, H, S / Q, P, N) float32 and
// states_in (B, H, S / Q, 2, P, N) bfloat16, and bfloat16 operands that
// start 16-byte aligned (the wrapper checks); float32 ignores them.
// Returns 0 or the first cudaError_t of an attribute call or a launch.
int ssd_scan_launch(const void* x, const void* dt, const void* a,
                    const void* bm, const void* cm, void* y, void* state,
                    void* cum, void* states, void* states_in, int B, int H,
                    int G, int S, int P, int N, int chunk, int dtype,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunk < 1 || chunk > kMaxChunk || S % chunk != 0 || H % G != 0)
    return (int)cudaErrorInvalidValue;
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(state);
#define SSD_CASE(PP, NN)                                                       \
  if (P == PP && N == NN) {                                                    \
    if (dtype == 0)                                                            \
      return launch_f32<PP, NN>(x, dtf, af, bm, cm, yf, sf, B, H, G, S, chunk, \
                                s);                                            \
    if (dtype == 1)                                                            \
      return launch_mma<PP, NN>(x, dtf, af, bm, cm, yf, sf,                    \
                                static_cast<float*>(cum),                      \
                                static_cast<float*>(states),                   \
                                static_cast<bf16*>(states_in), B, H, G, S,     \
                                chunk, s);                                     \
    return (int)cudaErrorInvalidValue;                                         \
  }
  SSD_SHAPES(SSD_CASE)
#undef SSD_CASE
  return (int)cudaErrorInvalidValue;
}

// blocks per SM, threads per block and dynamic shared memory of the
// kernels of one call (three entries each; see occupancy above)
int ssd_scan_occupancy(int P, int N, int chunk, int dtype, int* blocks,
                       int* threads, int* smem_bytes) {
  if (chunk < 1 || chunk > kMaxChunk) return (int)cudaErrorInvalidValue;
#define SSD_OCC(PP, NN)                                                    \
  if (P == PP && N == NN)                                                  \
    return occupancy<PP, NN>(chunk, dtype, blocks, threads, smem_bytes);
  SSD_SHAPES(SSD_OCC)
#undef SSD_OCC
  return (int)cudaErrorInvalidValue;
}

// the bf16 chunk-scan kernel of a call (bf16_chunk_scan above)
int ssd_scan_bf16_chunk_scan(int P, int N, int chunk, int* wgmma, int* consumer0,
                             int* slots, int* s_bufs) {
  if (chunk < 1 || chunk > kMaxChunk) return (int)cudaErrorInvalidValue;
#define SSD_PICK(PP, NN)                                                   \
  if (P == PP && N == NN)                                                  \
    return bf16_chunk_scan<PP, NN>(chunk, wgmma, consumer0, slots, s_bufs);
  SSD_SHAPES(SSD_PICK)
#undef SSD_PICK
  return (int)cudaErrorInvalidValue;
}

const char* ssd_scan_error_string(int err) {
  if (const char* text = tma::error_string(err)) return text;
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
