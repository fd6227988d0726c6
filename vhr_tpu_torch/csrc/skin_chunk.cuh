// Device code shared by K1 (fused_detect.cu) and K4 (fused_slots.cu): the
// chroma skin test, and the reads of a 16-pixel group (48 bytes of BGR u8,
// three 16-byte loads) whose bytes become the test's floats.
//
// The chroma test is an explicit __fmaf_rn chain that rounds exactly as the
// JAX reference does on XLA:CPU under jit (which contracts the float32
// expressions into fused multiply-adds); any other rounding can flip a
// threshold decision and move a box edge.  The library is built with
// --fmad=false so that nvcc contracts nothing else.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vhr {

struct SkinBox {
  float cb_min, cb_max, cr_min, cr_max, y_min;
};

__device__ __forceinline__ bool is_skin(float b, float g, float r,
                                        const SkinBox& s) {
  // y  = 0.299 r + 0.587 g + 0.114 b
  // cb = 128 - 0.168736 r - 0.331264 g + 0.5 b
  // cr = 128 + 0.5 r - 0.418688 g - 0.081312 b
  // rounded as XLA:CPU evaluates them under jit (LLVM contracts them into
  // this fma chain); models/skin_detector.py::ycbcr_from_bgr is the same.
  const float y = __fmaf_rn(0.114f, b, __fmaf_rn(0.299f, r,
                                                 __fmul_rn(0.587f, g)));
  const float cb = __fmaf_rn(0.5f, b, __fmaf_rn(-0.331264f, g,
                                                __fmaf_rn(-0.168736f, r, 128.0f)));
  const float cr = __fmaf_rn(-0.081312f, b, __fmaf_rn(-0.418688f, g,
                                                      __fmaf_rn(0.5f, r, 128.0f)));
  return cb >= s.cb_min && cb <= s.cb_max && cr >= s.cr_min &&
         cr <= s.cr_max && y >= s.y_min;
}

constexpr int kGroupPixels = 16;
constexpr int kGroupWords = 3 * kGroupPixels / 4;   // 12 words a group row
constexpr float kTwo23 = 8388608.0f;

// One row of a 16-pixel group: 48 bytes from a 16-byte aligned address.
__device__ __forceinline__ void load_row(const uint8_t* row, uint4 (&v)[3]) {
  const uint4* q = reinterpret_cast<const uint4*>(row);
#pragma unroll
  for (int i = 0; i < 3; ++i) v[i] = __ldg(q + i);
}

// Byte k (0..47) of a group row as a float: the byte goes into the mantissa
// of 2^23, which is then taken off (exact, no int-to-float conversion).
__device__ __forceinline__ float byte_f32(const uint32_t (&w)[kGroupWords],
                                          int k) {
  return __uint_as_float(__byte_perm(w[k >> 2], 0x4B000000u,
                                     0x7440u | (k & 3))) - kTwo23;
}

// The same for byte k of rows summed as 16-bit lanes: e holds bytes 0 and
// 2 of each word, o bytes 1 and 3 (sums of 8 rows stay below 2^16).
__device__ __forceinline__ float lane_f32(const uint32_t (&e)[kGroupWords],
                                          const uint32_t (&o)[kGroupWords],
                                          int k) {
  const uint32_t src = (k & 1) ? o[k >> 2] : e[k >> 2];
  return __uint_as_float(__byte_perm(src, 0x4B000000u,
                                     (k & 2) ? 0x7432u : 0x7410u)) - kTwo23;
}

}  // namespace vhr
