// The Mamba2 mixer's causal depthwise conv for Hopper (sm_90a): the (x, B, C)
// stream read once through the in projection's row stride, the W taps, the
// bias and the SiLU in one pass to fresh rows.
//
// Replaces no Pallas kernel: the JAX package leaves this chain to XLA
// (src/repro/models/ssm.py _causal_conv), which fuses it.  The port's eager
// PyTorch ran it as about 13 launches a layer (a pad, a fill, W multiplies
// and W adds, the bias, the SiLU), each a full pass over (tokens x C).  The
// plain PyTorch version of the same function is causal_conv_reference in
// ../causal_conv.py.  Operands, T float32 or bfloat16 (the model's type):
//   x (B, S, C) T through its batch and row strides, channels contiguous
//     (on the main path the xBC column slice of the in projection's output);
//   w (W, C) T and b (C,) T, contiguous;  -> out (B, S, C) T, contiguous.
// At the rounding points of the PyTorch chain (models/ssm.py), for each
// (b, t, c), with x[t'] = 0 for t' < 0:
//   o = T(0 + T(x[t-W+1] * w[0]))         the chain's zeros_like start: +0
//   o = T(o + T(x[t-W+1+i] * w[i]))       i = 1 .. W-1, in that order
//   v = T(o + b)
//   out = T(silu(v))                      v / (1 + exp(-v)), as PyTorch's
// Every product is the chain's float32 multiply and every sum rounds where
// the chain stores a tensor in T: a float32 accumulation would be more
// precise, and a different result.  FMA_FLAGS let nvcc contract a * b + c
// into one fma, so every rounding point is written out (__fmul_rn,
// __fadd_rn, __hadd2_rn, __fdiv_rn).  The 0 + p of the first tap stays: it
// turns a product of -0 into +0, as the chain's sum into zeros does.
//
// Bound: bytes.  x is read once and the output written once, 2 x 2 B a
// channel in bf16: 1.41 GB a layer at mamba2-2.7b's prefill (65,536 tokens
// x 5,376), 0.421 ms at 3.35 TB/s.  The exact SiLU (expf and an IEEE
// division, ~20 of the ~35 instructions a channel) puts the instruction
// stream close behind the bytes (~0.35 ms of instructions at that shape),
// so the design keeps both going at once:
//  - one thread owns one 16-byte vector of channels (8 bf16 or 4 float32)
//    over a segment of `seg` consecutive tokens of one sequence, with its
//    W vectors of weights in registers as floats;
//  - its rows come through a ring of kStages shared-memory stages of kRows
//    rows (cp.async, 16 bytes a row, kStages - 1 stages in flight while it
//    computes one); each thread reads back only the slots it filled, so no
//    barrier is needed, and the ring costs no registers;
//  - the last W-1 input rows stay in registers as floats; each row out is
//    one 16-byte store;
//  - a warp is a block: neighbouring lanes take neighbouring vectors (a
//    warp reads 512 contiguous bytes of a row in bf16 and writes 512), and
//    a channel count no multiple of 256 leaves no idle warp behind;
//  - a segment also reads the W-1 rows before it (its halo, in the ring's
//    first group), which the segment before reads at about the same time:
//    mostly L2 hits, W-1 rows in `seg` (3 in 64, under 5 %) otherwise.
// Grid: (vector blocks of kThreads, segments, batch).  The wrapper derives
// `seg` from the shape; C is a multiple of 8 and every pointer and row stride
// a multiple of 16 bytes (the wrapper checks both).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kThreads = 32;              // channel vectors a block: one warp
constexpr int kRows = 4;                  // rows a stage of the copy ring
constexpr int kStages = 3;                // stages: kStages - 1 in flight

struct Args {
  const void* x;
  const void* w;
  const void* b;
  void* out;
  long long xb, xs;                       // x's batch and row strides (elements)
  int seq, channels, seg;                 // S, C, tokens a thread
};

// the channels of one 16-byte vector
template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

// 16 bytes of T as floats
template <typename T>
__device__ __forceinline__ void unpack(const uint4 raw, float (&v)[kVec<T>]) {
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h2[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
    v[0] = __uint_as_float(raw.x); v[1] = __uint_as_float(raw.y);
    v[2] = __uint_as_float(raw.z); v[3] = __uint_as_float(raw.w);
  }
}

// floats to 16 bytes of T, each rounded to nearest even
template <typename T>
__device__ __forceinline__ uint4 pack(const float (&v)[kVec<T>]) {
  uint4 raw;
  if constexpr (sizeof(T) == 2) {
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h2[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  } else {
    raw = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                     __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
  return raw;
}

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// One output row of 16 bytes from the W input rows rows[r .. r+W-1] (as
// floats; the last the row's own token), the weights and the bias, at the
// chain's rounding points.  float32: every product and sum one float32
// operation.  bfloat16: each product the chain's float32 multiply, rounded
// to bf16 in pairs; each sum one bf16x2 add rounded to nearest
// (add.rn.bf16x2).  That add rounds the exact sum of two bf16 once, where
// the chain rounds it to float32 and then to bf16: the same value, since
// the float32 sum is exact unless the exponents lie 16 or more apart, and
// then the smaller operand is under 2^-15 of the larger, too little to
// move it to or past a bf16 midpoint either way.
template <typename T, int W, int R>
__device__ __forceinline__ uint4 conv_row(const float (&rows)[R][kVec<T>], const int r,
                                          const float (&wt)[W][kVec<T>],
                                          const uint4 bias) {
  constexpr int N = kVec<T>;
  float v[N];
  if constexpr (sizeof(T) == 2) {
    __nv_bfloat162 o[N / 2];
    const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);
#pragma unroll
    for (int i = 0; i < W; ++i) {
#pragma unroll
      for (int k = 0; k < N / 2; ++k) {
        const __nv_bfloat162 p = __floats2bfloat162_rn(
            __fmul_rn(rows[r + i][2 * k], wt[i][2 * k]),
            __fmul_rn(rows[r + i][2 * k + 1], wt[i][2 * k + 1]));
        o[k] = __hadd2_rn(i == 0 ? zero : o[k], p);
      }
    }
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&bias);
#pragma unroll
    for (int k = 0; k < N / 2; ++k) {
      const float2 f = __bfloat1622float2(__hadd2_rn(o[k], b2[k]));
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  } else {
    float b[N];
    unpack<T>(bias, b);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float o = __fadd_rn(0.f, __fmul_rn(rows[r][k], wt[0][k]));
#pragma unroll
      for (int i = 1; i < W; ++i) o = __fadd_rn(o, __fmul_rn(rows[r + i][k], wt[i][k]));
      v[k] = __fadd_rn(o, b[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = __fdiv_rn(v[k], __fadd_rn(1.f, expf(-v[k])));
  return pack<T>(v);
}

template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
causal_conv_kernel(const Args a) {
  constexpr int N = kVec<T>;
  // each thread's own slots: stage, row of the stage, thread; the halo
  __shared__ uint4 stage[kStages][kRows][kThreads];
  __shared__ uint4 halo[W - 1][kThreads];
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v * N >= a.channels) return;
  const int t0 = blockIdx.y * a.seg;
  const int t1 = min(t0 + a.seg, a.seq);
  const T* __restrict__ x =
      static_cast<const T*>(a.x) + blockIdx.z * a.xb + (long long)v * N;
  T* __restrict__ out = static_cast<T*>(a.out)
      + (long long)blockIdx.z * a.seq * a.channels + (long long)v * N;

  // queue the copies of the kRows rows from t into stage slot st (zeros past
  // the segment, from a valid address), as one group
  auto fetch = [&](int st, int t) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      mma::cp_async16(&stage[st][r][threadIdx.x], t + r < t1 ? x + (t + r) * a.xs : x,
                      t + r < t1);
    mma::cp_async_commit();
  };
  // the W-1 rows before the segment (zeros before the sequence) go with
  // the first stage's group
#pragma unroll
  for (int i = 0; i < W - 1; ++i) {
    const int t = t0 - (W - 1) + i;
    mma::cp_async16(&halo[i][threadIdx.x], t >= 0 ? x + t * a.xs : x, t >= 0);
  }
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) fetch(st, t0 + st * kRows);

  float wt[W][N];
#pragma unroll
  for (int i = 0; i < W; ++i)
    unpack<T>(load16(static_cast<const T*>(a.w) + (long long)i * a.channels + v * N), wt[i]);
  const uint4 bias = load16(static_cast<const T*>(a.b) + v * N);
  // rows[i]: x[t - (W-1) + i] for the step's first row t, then the step's
  // kRows rows; zeros before the sequence
  float rows[W - 1 + kRows][N];
  mma::cp_async_wait<kStages - 2>();     // the first group: the halo's
#pragma unroll
  for (int i = 0; i < W - 1; ++i) unpack<T>(halo[i][threadIdx.x], rows[i]);

  int st = 0;
  for (int t = t0; t < t1; t += kRows) {
    // the stage kStages - 1 steps ahead reuses the slot read a step ago
    fetch(st == 0 ? kStages - 1 : st - 1, t + (kStages - 1) * kRows);
    mma::cp_async_wait<kStages - 1>();
#pragma unroll
    for (int r = 0; r < kRows; ++r) unpack<T>(stage[st][r][threadIdx.x], rows[W - 1 + r]);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const uint4 o = conv_row<T, W>(rows, r, wt, bias);
      if (t + r < t1) *reinterpret_cast<uint4*>(out + (long long)(t + r) * a.channels) = o;
    }
#pragma unroll
    for (int i = 0; i < W - 1; ++i)
#pragma unroll
      for (int k = 0; k < N; ++k) rows[i][k] = rows[kRows + i][k];
    st = st == kStages - 1 ? 0 : st + 1;
  }
}

template <typename T, int W>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const int vecs = a.channels / kVec<T>;
  const dim3 grid((vecs + kThreads - 1) / kThreads, (a.seq + a.seg - 1) / a.seg, batch);
  causal_conv_kernel<T, W><<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_width(const Args& a, int width, int batch, cudaStream_t stream) {
  switch (width) {
    case 2: return launch<T, 2>(a, batch, stream);
    case 3: return launch<T, 3>(a, batch, stream);
    case 4: return launch<T, 4>(a, batch, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype of x, w, b and out: 0 float32, 1 bfloat16.  Taps 2 to 4; C a
// multiple of 8; every pointer 16-byte aligned and every stride a multiple
// of 16 bytes (the wrapper checks); batch and segments up to 65535 (the
// grid's z and y).  Returns 0 or the launch's cudaError_t;
// cudaErrorInvalidValue for shapes it does not take.
int causal_conv_launch(const void* x, const void* w, const void* b, void* out,
                       long long batch, long long seq, long long channels,
                       long long xb, long long xs, int width, int seg, int dtype,
                       void* stream) {
  if (batch < 1 || batch > 65535 || seq < 1 || seq > (1LL << 30) || channels < 8 ||
      channels % 8 != 0 || channels > (1LL << 30) || seg < 1 ||
      (seq + seg - 1) / seg > 65535 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const Args a{x, w, b, out, xb, xs, (int)seq, (int)channels, seg};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_width<float>(a, width, (int)batch, s)
                    : launch_width<__nv_bfloat16>(a, width, (int)batch, s);
}

const char* causal_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
