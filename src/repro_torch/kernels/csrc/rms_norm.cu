// RMSNorm for Hopper (sm_90a): every row read once and written once.
//
// Replaces no Pallas kernel: the JAX package leaves this chain to XLA
// (src/repro/models/layers.py rms_norm), which fuses it.  The port's eager
// PyTorch ran it as about ten launches a call (cast, square, mean, + eps,
// rsqrt, multiply, weight cast, 1 + w, multiply, cast back), each a full
// pass over (rows x D).  The plain PyTorch version of the same function is
// models/layers.py rms_norm.  Operands, T float32 or bfloat16 (the model's
// type), W float32 or bfloat16:
//   x (rows, D) T through its row stride, channels contiguous;
//   w (D,) W;  -> out (rows, D) T, contiguous.
// At the rounding points of the PyTorch chain, per row:
//   r = rsqrt(sum over the row of float(x)^2 / D + eps)
//   out = T((float(x) * r) * (1 + float(w)))
// Sums in float32; only the order of the sum of squares differs from
// PyTorch's.  FMA_FLAGS let nvcc contract a * b + c into one fma, so every
// rounding point is written with __fmul_rn / __fadd_rn / __fdiv_rn.
//
// Bound: bytes, 2 x D x sizeof(T) a row (w is read from L1/L2): 0.200 ms
// at mamba2-2.7b's prefill (65,536 rows x 2,560, bf16) at 3.35 TB/s, ~1
// flop a byte.  The design moves those bytes and no others:
//  - a row's `tpr` threads (a power of two, 1-512) each hold up to kVec
//    vectors of 8 channels, strided by tpr so a step of the row's threads
//    is one coalesced run: 16-byte loads in bf16 (two in float32), kept raw
//    in registers between the sum of squares and the scale, so x is read
//    from device memory once;
//  - the entry point picks tpr, the smallest with tpr x kVec x 8 >= D, so
//    a thread holds 2-4 vectors (4-8 KB in flight a 128-thread block in
//    bf16) at every width past 32; a block is max(tpr, 128) threads, 128 /
//    tpr rows where a row takes fewer;
//  - the row's sum by shuffles within its lanes, and past a warp through
//    one float a warp in shared memory and one barrier;
//  - w and 1 + w in float32 per vector, through the read-only cache: D x
//    sizeof(W) bytes every row shares.
// D is a multiple of 8 up to kMaxWidth; every pointer and row stride is a
// multiple of 16 bytes (the wrapper checks all three).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kVec = 4;                    // 8-channel vectors a thread, at most
constexpr int kMinThreads = 128;           // a block's threads, at least
constexpr int kMaxThreads = 512;           // a row's threads, at most
constexpr int kMaxWidth = kMaxThreads * kVec * 8;   // 16,384

struct Args {
  const void* x;
  const void* w;
  void* out;
  long long rows, stride;                  // x's row stride in elements
  int width, shift;                        // D; log2 of a row's threads
  float eps;
};

// 8 consecutive elements of T, as loaded: 16 bytes of bf16, 32 of float
template <typename T>
struct Pack;
template <>
struct Pack<__nv_bfloat16> {
  uint4 raw;
};
template <>
struct Pack<float> {
  float4 lo, hi;
};

// the 8 elements at p (16-byte aligned)
template <typename T>
__device__ __forceinline__ Pack<T> load8(const T* p);
template <>
__device__ __forceinline__ Pack<__nv_bfloat16> load8(const __nv_bfloat16* p) {
  return {__ldg(reinterpret_cast<const uint4*>(p))};
}
template <>
__device__ __forceinline__ Pack<float> load8(const float* p) {
  return {__ldg(reinterpret_cast<const float4*>(p)),
          __ldg(reinterpret_cast<const float4*>(p + 4))};
}

// a pack as 8 floats (exact)
__device__ __forceinline__ void unpack(const Pack<__nv_bfloat16>& k, float (&v)[8]) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&k.raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack(const Pack<float>& k, float (&v)[8]) {
  v[0] = k.lo.x; v[1] = k.lo.y; v[2] = k.lo.z; v[3] = k.lo.w;
  v[4] = k.hi.x; v[5] = k.hi.y; v[6] = k.hi.z; v[7] = k.hi.w;
}

// 8 floats to 8 consecutive elements of T at p (16-byte aligned), each
// rounded to nearest even
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 raw;
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h2[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

template <typename T, typename W>
__global__ void __launch_bounds__(kMaxThreads)
rms_norm_kernel(const Args a) {
  __shared__ float partial[kMaxThreads / 32];
  const int tpr = 1 << a.shift;
  const int t = threadIdx.x & (tpr - 1);   // the thread's place in its row
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> a.shift;
  // a row past the end still joins its warp's shuffles and the barrier
  const bool live = row < a.rows;
  const int units = a.width >> 3;
  const T* __restrict__ x = static_cast<const T*>(a.x) + (live ? row : 0) * a.stride;

  Pack<T> held[kVec];
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int u = t + (i << a.shift);
    if (live && u < units) held[i] = load8(x + 8 * u);
  }
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int u = t + (i << a.shift);
    if (live && u < units) {
      float v[8];
      unpack(held[i], v);
#pragma unroll
      for (int j = 0; j < 8; ++j) sq = __fadd_rn(sq, __fmul_rn(v[j], v[j]));
    }
  }
  // the row's lanes: an aligned group of min(tpr, 32) in one warp
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (o < tpr) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  if (tpr > 32) {
    const int warp = threadIdx.x >> 5, per_row = tpr >> 5;
    if ((threadIdx.x & 31) == 0) partial[warp] = sq;
    __syncthreads();
    const int first = warp & ~(per_row - 1);
    sq = 0.f;
    for (int k = 0; k < per_row; ++k) sq += partial[first + k];
  }
  if (!live) return;
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(sq, (float)a.width), a.eps));

  const W* __restrict__ w = static_cast<const W*>(a.w);
  T* __restrict__ out = static_cast<T*>(a.out) + row * (long long)a.width;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int u = t + (i << a.shift);
    if (u < units) {
      float v[8], wv[8];
      unpack(held[i], v);
      unpack(load8(w + 8 * u), wv);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = __fmul_rn(__fmul_rn(v[j], r), __fadd_rn(1.f, wv[j]));
      store8(out + 8 * u, v);
    }
  }
}

template <typename T, typename W>
int launch(const Args& a, cudaStream_t stream) {
  const int threads = (1 << a.shift) > kMinThreads ? (1 << a.shift) : kMinThreads;
  const long long rows_per_block = threads >> a.shift;
  const long long blocks = (a.rows + rows_per_block - 1) / rows_per_block;
  rms_norm_kernel<T, W><<<(unsigned)blocks, threads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_w(const Args& a, int w_dtype, cudaStream_t stream) {
  return w_dtype == 0 ? launch<T, float>(a, stream) : launch<T, __nv_bfloat16>(a, stream);
}

}  // namespace

extern "C" {

// dtype of x and out, and w_dtype of w: 0 float32, 1 bfloat16.  Every
// pointer is 16-byte aligned and the row stride a multiple of 16 bytes (the
// wrapper checks).  Returns 0 or the launch's cudaError_t;
// cudaErrorInvalidValue for shapes it does not take.
int rms_norm_launch(const void* x, const void* w, void* out, long long rows,
                    long long stride, int width, float eps, int dtype, int w_dtype,
                    void* stream) {
  if (rows < 1 || width < 8 || width % 8 != 0 || width > kMaxWidth ||
      stride < width || dtype < 0 || dtype > 1 || w_dtype < 0 || w_dtype > 1)
    return (int)cudaErrorInvalidValue;
  // a row's threads: the fewest, a power of two, with threads x kVec x 8 >= D
  int shift = 0;
  while ((kVec * 8) << shift < width) ++shift;
  Args a{x, w, out, rows, stride, width, shift, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_w<float>(a, w_dtype, s)
                    : launch_w<__nv_bfloat16>(a, w_dtype, s);
}

const char* rms_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
