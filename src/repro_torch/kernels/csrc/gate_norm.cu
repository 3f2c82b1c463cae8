// The Mamba2 mixer's gated norm for Hopper (sm_90a): from the SSD scan's
// float32 y to the normed rows the out projection reads, in one pass.
//
// Replaces no Pallas kernel: the JAX package leaves this chain to XLA
// (src/repro/models/ssm.py ssm_mixer, after the scan), which fuses it.  The
// port's eager PyTorch ran it as about 16 launches a layer, each a full pass
// over (tokens x d_inner).  The plain PyTorch version of the same function
// is gate_norm_reference in ../gate_norm.py.  Operands, per token (b, s)
// and channel c of head h = c / P, T float32 or bfloat16 (the model's type):
//   y (B, S, H, P) float32 through its strides: on the main path the
//     transposed view of the SSD kernel's (B, H, S, P) buffer;
//   x (B, S, H P) T and z (B, S, H P) T through their row strides (column
//     slices of the conv's and the in projection's outputs);
//   d (H,) float32, w (H P,) T;  -> out (B S, H P) T, contiguous.
// At the rounding points of the PyTorch chain (models/ssm.py, layers.py
// rms_norm), for each group of `width` channels:
//   t = T(y + d[h] * float(x))            the product rounded, then the sum
//   g = T(silu(float(z)))                 z / (1 + exp(-z)), as PyTorch's
//   v = T(float(t) * float(g))
//   r = rsqrt(sum over the group of float(v)^2 / width + eps)
//   out = T((float(v) * r) * (1 + float(w)))
// Sums in float32; only the order of the sum of squares differs from
// PyTorch's.  FMA_FLAGS let nvcc contract a * b + c into one fma, so every
// rounding point is written with __fmul_rn / __fadd_rn / __fdiv_rn.
//
// Bound: bytes.  Each operand is read once and the output written once,
// (4 + 2 + 2 + 2) B a channel in bf16: 3.36 GB a layer at mamba2-2.7b's
// prefill (65,536 tokens x 5,120), 1.00 ms at 3.35 TB/s, at ~2 flop a byte
// counting the exp.  The design moves those bytes and no others:
//  - one warp a token, kWarps consecutive tokens a block.  A lane takes 8
//    consecutive channels at a time: one 16-byte load each of x, z and w,
//    two of y, one 16-byte store.  A warp's step covers 256 channels, and
//    in the SSD layout the block's tokens make each head's y one run of
//    kWarps x P floats;
//  - one group at a time.  Pass 1 forms v, keeps it in the warp's row of
//    shared memory (width x sizeof(T)) and sums v^2 per lane; shuffles
//    reduce the group's sum; pass 2 reads v back with w and writes the
//    row.  v never goes to device memory;
//  - no barrier across warps: a token count that is no multiple of kWarps
//    only leaves warps idle.
// The group width is a multiple of 8 and P of 4, so a lane's 8 channels lie
// in one group and each 4 of them in one head; every pointer and row stride
// is a multiple of 16 bytes (the wrapper checks all three).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;                 // tokens a block, one a warp
constexpr int kMaxSmem = 232448;          // a block's shared memory on sm_90

struct Args {
  const float* y;
  const void* x;
  const float* d;
  const void* z;
  const void* w;
  void* out;
  long long tokens, seq;                  // B S, S
  long long yb, ys, yh;                   // y's strides in elements (P: 1)
  long long xb, xs, zb, zs;               // x's and z's row strides
  int heads, p, width, groups;
  float eps;
};

// v rounded to T and back: where the PyTorch chain stores a tensor in T
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 8 consecutive elements of T at p (16-byte aligned), as floats
template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&v)[8]) {
  if constexpr (sizeof(T) == 2) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h2[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
}

// 8 floats to 8 consecutive elements of T at p (16-byte aligned), each
// rounded to nearest even
template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&v)[8]) {
  if constexpr (sizeof(T) == 2) {
    uint4 raw;
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h2[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// one channel of pass 1: v = T(T(y + d x) * T(silu(z))), v^2 added to sq
template <typename T>
__device__ __forceinline__ float gated(float y, float d, float x, float z, float& sq) {
  const float t = round_to<T>(__fadd_rn(y, __fmul_rn(d, x)));
  const float g = round_to<T>(__fdiv_rn(z, __fadd_rn(1.f, expf(-z))));
  const float v = round_to<T>(__fmul_rn(t, g));
  sq = __fadd_rn(sq, __fmul_rn(v, v));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
ssm_gate_norm_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long tok = (long long)blockIdx.x * kWarps + warp;
  if (tok >= a.tokens) return;            // the whole warp: one token
  const long long b = tok / a.seq, s = tok - b * a.seq;
  const float* __restrict__ y = a.y + b * a.yb + s * a.ys;
  const T* __restrict__ x = static_cast<const T*>(a.x) + b * a.xb + s * a.xs;
  const T* __restrict__ z = static_cast<const T*>(a.z) + b * a.zb + s * a.zs;
  const T* __restrict__ w = static_cast<const T*>(a.w);
  T* __restrict__ out = static_cast<T*>(a.out) + tok * (long long)(a.heads * a.p);
  T* row = reinterpret_cast<T*>(smem) + (size_t)warp * a.width;
  const int units = a.width / 8;

  for (int g = 0; g < a.groups; ++g) {
    const int c0 = g * a.width;
    float sq = 0.f;
#pragma unroll 4
    for (int u = lane; u < units; u += 32) {
      const int c = c0 + 8 * u, h0 = c / a.p, h1 = (c + 4) / a.p;
      float xv[8], zv[8], v[8];
      load8(x + c, xv);
      load8(z + c, zv);
      const float4 y0 = *reinterpret_cast<const float4*>(y + h0 * a.yh + (c - h0 * a.p));
      const float4 y1 = *reinterpret_cast<const float4*>(y + h1 * a.yh + (c + 4 - h1 * a.p));
      const float d0 = a.d[h0], d1 = a.d[h1];
      v[0] = gated<T>(y0.x, d0, xv[0], zv[0], sq);
      v[1] = gated<T>(y0.y, d0, xv[1], zv[1], sq);
      v[2] = gated<T>(y0.z, d0, xv[2], zv[2], sq);
      v[3] = gated<T>(y0.w, d0, xv[3], zv[3], sq);
      v[4] = gated<T>(y1.x, d1, xv[4], zv[4], sq);
      v[5] = gated<T>(y1.y, d1, xv[5], zv[5], sq);
      v[6] = gated<T>(y1.z, d1, xv[6], zv[6], sq);
      v[7] = gated<T>(y1.w, d1, xv[7], zv[7], sq);
      store8(row + 8 * u, v);              // exact: v is already in T
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float r = rsqrtf(__fadd_rn(__fdiv_rn(sq, (float)a.width), a.eps));
#pragma unroll 2
    for (int u = lane; u < units; u += 32) {
      const int c = c0 + 8 * u;
      float v[8], wv[8];
      load8(row + 8 * u, v);               // the lane's own, written above
      load8(w + c, wv);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] = __fmul_rn(__fmul_rn(v[i], r), __fadd_rn(1.f, wv[i]));
      store8(out + c, v);
    }
  }
}

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  const int smem = kWarps * a.width * (int)sizeof(T);
  auto kernel = ssm_gate_norm_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // the rows decide how many warps an SM holds: take all of its shared memory
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (a.tokens + kWarps - 1) / kWarps;
  kernel<<<(unsigned)blocks, kWarps * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype of x, z, w and out: 0 float32, 1 bfloat16.  Every pointer is
// 16-byte aligned and every stride a multiple of 16 bytes (the wrapper
// checks).  Returns 0 or the first cudaError_t of an attribute call or the
// launch; cudaErrorInvalidValue for shapes it does not take.
int gate_norm_launch(const void* y, const void* x, const void* d, const void* z,
                     const void* w, void* out, long long tokens, long long seq,
                     long long yb, long long ys, long long yh, long long xb,
                     long long xs, long long zb, long long zs, int heads, int p,
                     int groups, float eps, int dtype, void* stream) {
  if (tokens < 1 || seq < 1 || heads < 1 || p < 4 || p % 4 != 0 || groups < 1 ||
      (heads * p) % groups != 0)
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const float*>(y), x, static_cast<const float*>(d), z, w, out,
         tokens, seq, yb, ys, yh, xb, xs, zb, zs, heads, p, heads * p / groups,
         groups, eps};
  const int elem = dtype == 0 ? 4 : 2;
  if (dtype < 0 || dtype > 1 || a.width % 8 != 0 ||
      (long long)kWarps * a.width * elem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(a, s) : launch<__nv_bfloat16>(a, s);
}

const char* gate_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
