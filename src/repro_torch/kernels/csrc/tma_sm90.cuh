// Tensor maps for TMA tile copies (sm_90a), built on the host.  Shared by
// flash_attention.cu (flash_wgmma_kernel: Q, K, V and the output) and
// ssd_scan.cu (ssd_wgmma_chunk_scan: C, B, x and the entering states).
//
// cuTensorMapEncodeTiled is taken from the driver at run time (no -lcuda);
// a driver without it, or one that refuses a map, makes the launch return
// kErrNoEncoder or kErrEncode, whose text error_string gives.  Nothing
// falls back.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums (types only; no -lcuda)
#include <cuda_runtime.h>
#include <stdint.h>

namespace tma {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
constexpr int kErrNoEncoder = -1;   // the driver has no cuTensorMapEncodeTiled
constexpr int kErrEncode = -2;      // it refused a map

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Map of a contiguous bf16 tensor of `rank` dimensions (dims[0] the
// innermost, a row of dims[0] elements) in boxes of 64 columns x box_rows
// rows x 1 along each outer dimension, 128-byte swizzle.  A box reaching
// past any dimension's edge reads zeros there, never the next row, chunk
// or head.
inline int bf16_map(CUtensorMap* map, const void* ptr, int rank,
                    const cuuint64_t* dims, int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return kErrNoEncoder;
  cuuint64_t strides[4];
  cuuint32_t box[5], unit[5];
  cuuint64_t stride = 2;
  for (int i = 0; i < rank; ++i) {
    if (i + 1 < rank) strides[i] = stride *= dims[i];
    box[i] = i == 0 ? 64 : i == 1 ? (cuuint32_t)box_rows : 1;
    unit[i] = 1;
  }
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kErrEncode;
}

// 3-D map (d, rows, heads) of a contiguous (heads, rows, d) bf16 tensor
inline int bf16_map(CUtensorMap* map, const void* ptr, int d, int rows, int heads,
                    int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)heads};
  return bf16_map(map, ptr, 3, dims, box_rows);
}

// the text of kErrNoEncoder or kErrEncode, else nullptr
inline const char* error_string(int err) {
  if (err == kErrNoEncoder)
    return "the CUDA driver has no cuTensorMapEncodeTiled (TMA needs CUDA 12)";
  if (err == kErrEncode)
    return "cuTensorMapEncodeTiled refused a tensor map of the operands";
  return nullptr;
}

}  // namespace tma
