// Causal GQA flash attention (optional sliding window) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_bhsd / _kernel).  Operands are in kernel layout:
// q (BH, Sq, D) pre-scaled by D**-0.5, k and v (BK, Sk, D) with
// BK = BH / group, float32 or bfloat16; the output is (BH, Sq, D) in q's
// type.  Arithmetic is float32 throughout.  The plain PyTorch version of
// the same function is flash_attention_reference in ../flash_attention.py.
//
// Design.  The TPU kernel walks the key blocks as the innermost, sequential
// grid axis and keeps the online-softmax state (m, l, acc) in VMEM scratch
// between grid steps.  Blocks of a CUDA grid run in no order, so here one
// block owns 64 query rows of one (batch, head) and walks the key blocks in
// a loop inside the program: gridDim = (BH, ceil(Sq / 64)), 256 threads as a
// 16 x 16 grid.  Thread (ty, tx) owns rows 4*ty .. 4*ty+3 of the tile; for
// those rows it holds a 4 x 4 block of the 64 x 64 score tile (key columns
// tx + 16*j) and a 4 x D/16 block of the accumulator (columns tx + 16*j),
// both in registers.  m and l of each row are replicated in the 16 threads
// that share the row and reduced with xor shuffles inside the half-warp,
// which gives every lane the same bits.  Shared memory holds the Q tile,
// the K and V tiles (converted to float32 on load) and the probability tile
// that feeds the P.V product; row strides are padded so that the lanes of a
// warp hit distinct banks.  The KV head is bh / group, as the TPU kernel's
// index_map.  Key blocks that every row of the tile masks are not visited
// (the TPU kernel's pl.when skip); a ragged tail (Sq or Sk not a multiple
// of 64) is masked here, so the kernel takes every length.
//
// Numerics, as the TPU kernel: masked scores are -1e30, not -inf.  A row
// that a visited block masks whole takes exp(0) terms while its running max
// is still -1e30; the first block with a real key rescales them by
// alpha = exp(-1e30 - m) = 0, where -inf would make NaN.  The final
// division is by max(l, 1e-30).  K/V rows past Sk load as 0, so such terms
// never carry NaN.
//
// What bounds it.  At zamba2-7b's prefill (BH = 64, S = 4096, D = 112,
// bf16) the function needs ~2.4e11 flop against ~235 MB of operands, so on
// paper it is bound by the tensor cores (~0.24 ms at 989 TFLOP/s).  This
// first version runs its products on the CUDA cores in float32 from shared
// memory (each 4 x 4 register tile reads 8 operands per 16 fma), so it is
// bound by shared-memory bandwidth and the float32 rate far above that;
// wgmma, TMA and pipelining are later work.
//
// Built without -fmad=false (contraction allowed) and without fast-math:
// expf and the final division are IEEE.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per step of the in-program loop
constexpr int kThreads = 256;    // 16 x 16
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int D>
struct Layout {
  static constexpr int QS = D + 4;     // Q row stride: rows 4 apart -> other banks
  static constexpr int KS = D + 1;     // K row stride: odd, column reads conflict-free
  static constexpr int PS = kBK + 4;   // probability row stride
  static constexpr int floats = kBQ * QS + kBK * KS + kBK * D + kBQ * PS;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int sq, int sk,
             int group, int causal, int window) {
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
  const T* qg = q + (size_t)bh * sq * D;
  const T* kg = k + (size_t)(bh / group) * sk * D;
  const T* vg = v + (size_t)(bh / group) * sk * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    float qv = 0.f;
    if (q0 + r < sq) qv = to_f32(qg[(size_t)(q0 + r) * D + c]);
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
        kv = to_f32(kg[(size_t)(k0 + r) * D + c]);
        vv = to_f32(vg[(size_t)(k0 + r) * D + c]);
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

  T* og = out + (size_t)bh * sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    const float denom = fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int d = 0; d < ND; ++d)
      store(&og[(size_t)row * D + tx + 16 * d], acc[i][d] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int sq, int sk, int group, int causal, int window,
           cudaStream_t stream) {
  const size_t bytes = sizeof(float) * Layout<D>::floats;
  auto kernel = flash_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, (sq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, sk, group, causal,
      window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v, void* out,
               int bh, int sq, int sk, int group, int causal, int window,
               cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, out, bh, sq, sk, group, causal, window, s);
    case 32: return launch<T, 32>(q, k, v, out, bh, sq, sk, group, causal, window, s);
    case 64: return launch<T, 64>(q, k, v, out, bh, sq, sk, group, causal, window, s);
    case 112: return launch<T, 112>(q, k, v, out, bh, sq, sk, group, causal, window, s);
    case 128: return launch<T, 128>(q, k, v, out, bh, sq, sk, group, causal, window, s);
    case 256: return launch<T, 256>(q, k, v, out, bh, sq, sk, group, causal, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  window <= 0: no sliding window.
// Returns 0 or the cudaError_t of the attribute call or the launch.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int bh, int sq, int sk, int d,
                           int group, int causal, int window, int dtype,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(d, q, k, v, out, bh, sq, sk, group, causal, window, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, out, bh, sq, sk, group, causal,
                                     window, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
