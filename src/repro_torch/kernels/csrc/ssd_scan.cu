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
// ../ssd_scan.py.
//
// Design.  The TPU kernel makes the chunk axis the innermost, sequential
// grid axis and carries S in VMEM scratch.  Here one block owns one
// (batch, head) and loops over the chunks in order: gridDim = B * H,
// 256 threads as a 16 x 16 grid.  The state is held twice: each thread
// keeps its P/16 x N/16 share of S in registers across the whole scan
// (rows ty + 16*i, columns tx + 16*j) and updates it there; after each
// chunk the block writes it to shared memory, where every thread reads it
// for the next chunk's inter-chunk term (64 x 64 float32 = 16 KB at
// zamba2's widths).  At chunk 256 the Q x Q matrix (C B^T) o L is 256 KB
// and does not fit in shared memory, so it is formed in 64 x 64 tiles: for
// each 64-row tile of queries the block walks the key tiles j <= i, loads
// the B rows and the dt-weighted x rows of that tile (float32), forms the
// masked score tile in shared memory and accumulates its product with dax
// into a 4 x P/16 register tile per thread.  B and C are group-mapped
// (h / (H / G)).  The decay is selected by the causal mask, never
// multiplied by it: for j > i, exp(cum_i - cum_j) can be inf, and inf * 0
// is NaN (the TPU kernel's where).  A chunk shorter than 64 steps (S <
// chunk at decode-sized prompts) is masked.
//
// What bounds it.  At zamba2-7b's prefill (B = 2, H = 112, S = 4096,
// P = N = 64, chunk 256) the function moves ~360 MB (y in float32 is most
// of it) against ~7.5e10 flop, so it is bound by bytes on paper (~0.11 ms
// at 3.35 TB/s).  This first version forms every product on the CUDA
// cores in float32 from shared memory and is bound by that far above the
// byte bound; tensor-core tiles and a split into chunk-state,
// state-passing and chunk-scan kernels are later work.
//
// Built without -fmad=false (contraction allowed) and without fast-math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;           // rows of a query or key tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kMaxChunk = 1024;  // ../ssd_scan.py MAX_CHUNK

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int P, int N>
struct Layout {
  static constexpr int NS = N + 1;     // odd stride: column reads conflict-free
  static constexpr int GS = kT + 4;    // score tile stride
  static constexpr int floats_fixed =
      P * NS + 2 * kT * NS + kT * P + kT * GS;
  static size_t bytes(int q) { return sizeof(float) * (floats_fixed + 2 * q); }
};

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a, const T* __restrict__ bm,
           const T* __restrict__ cm, float* __restrict__ y,
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
  const T* xg = x + (size_t)bh * S * P;
  const float* dtg = dt + (size_t)bh * S;
  const T* bg = bm + (size_t)(b * G + g) * S * N;
  const T* cg = cm + (size_t)(b * G + g) * S * N;
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
          if (jt + r < Q) bv = to_f32(bg[(size_t)(t0 + jt + r) * N + n]);
          bs[r * L::NS + n] = bv;
          if (jt == 0) {
            float cv = 0.f;
            if (it + r < Q) cv = to_f32(cg[(size_t)(t0 + it + r) * N + n]);
            cs[r * L::NS + n] = cv;
          }
        }
        for (int e = tid; e < kT * P; e += kThreads) {
          const int r = e / P, p = e % P;
          float xv = 0.f;
          if (jt + r < Q) xv = to_f32(xg[(size_t)(t0 + jt + r) * P + p]) * dts[jt + r];
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
        if (jt + r < Q) bv = to_f32(bg[(size_t)(t0 + jt + r) * N + n]);
        bs[r * L::NS + n] = bv;
      }
      for (int e = tid; e < kT * P; e += kThreads) {
        const int r = e / P, p = e % P;
        const int j = jt + r;
        float xv = 0.f;
        if (j < Q)
          xv = to_f32(xg[(size_t)(t0 + j) * P + p]) * dts[j] * expf(cum_end - cum[j]);
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

template <typename T, int P, int N>
int launch(const void* x, const float* dt, const float* a, const void* bm,
           const void* cm, float* y, float* state, int B, int H, int G, int S,
           int Q, cudaStream_t stream) {
  const size_t bytes = Layout<P, N>::bytes(Q);
  auto kernel = ssd_kernel<T, P, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * H, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(bm),
      static_cast<const T*>(cm), y, state, H, G, S, Q);
  return (int)cudaGetLastError();
}

// (P, N) pairs compiled in: ../ssd_scan.py SUPPORTED_PN
#define SSD_SHAPES(X) X(16, 16) X(32, 64) X(64, 64) X(64, 128) X(128, 128)

template <typename T>
int dispatch(int p, int n, const void* x, const float* dt, const float* a,
             const void* bm, const void* cm, float* y, float* state, int B,
             int H, int G, int S, int Q, cudaStream_t s) {
#define SSD_CASE(PP, NN)                                                      \
  if (p == PP && n == NN)                                                     \
    return launch<T, PP, NN>(x, dt, a, bm, cm, y, state, B, H, G, S, Q, s);
  SSD_SHAPES(SSD_CASE)
#undef SSD_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype of x, bmat and cmat: 0 float32, 1 bfloat16.  chunk (Q) divides S
// and is at most kMaxChunk.  Returns 0 or the cudaError_t of the attribute
// call or the launch.
int ssd_scan_launch(const void* x, const void* dt, const void* a,
                    const void* bm, const void* cm, void* y, void* state,
                    int B, int H, int G, int S, int P, int N, int chunk,
                    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunk < 1 || chunk > kMaxChunk || S % chunk != 0 || H % G != 0)
    return (int)cudaErrorInvalidValue;
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(state);
  if (dtype == 0)
    return dispatch<float>(P, N, x, dtf, af, bm, cm, yf, sf, B, H, G, S, chunk, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(P, N, x, dtf, af, bm, cm, yf, sf, B, H, G, S,
                                   chunk, s);
  return (int)cudaErrorInvalidValue;
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
