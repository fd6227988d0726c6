// Device code shared by K1 (fused_detect.cu) and K4 (fused_slots.cu): the
// chroma skin test, and one block's skin pass over one row chunk of one
// frame with K1's chunk geometry.
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

// The calling block's skin test of row chunk `chunk` of one (H, W*3) u8
// frame.  The chunk covers rb rows from min(chunk * rb, H - rb); rows above
// the unclamped origin chunk * rb belong to the previous chunk and are
// skipped.  Rows are mean-pooled `pool` at a time (pool divides 8, so the
// mean is exact).  Writes colcnt[0, W): skin cells per column, and
// stat[0..2]: [cells, rmin, rmax] (rmin = H, rmax = -1 when no pooled row
// holds >= 2 skin cells).  Every thread of the block must call it; it needs
// rb / pool ints of dynamic shared memory and blockDim.x a multiple of 32.
__device__ __forceinline__ void skin_chunk(const uint8_t* __restrict__ frame,
                                           int chunk, int H, int W, int rb,
                                           int pool, const SkinBox& skin,
                                           int32_t* __restrict__ colcnt,
                                           int32_t* __restrict__ stat) {
  extern __shared__ int rowsum[];  // rb / pool pooled rows
  __shared__ int s_cells, s_rmin, s_rmax;
  const int tid = threadIdx.x, lane = tid & 31;
  const int row0 = chunk * rb;            // unclamped origin
  const int start = min(row0, H - rb);    // clamped origin
  const int rbp = rb / pool;
  const int q0 = (row0 - start) / pool;   // pooled rows above q0 were done
  for (int q = tid; q < rbp; q += blockDim.x) rowsum[q] = 0;
  if (tid == 0) { s_cells = 0; s_rmin = H; s_rmax = -1; }
  __syncthreads();

  const long long row_bytes = 3LL * W;
  const float inv = 1.0f / (float)pool;   // exact: pool is a power of two
  int cells = 0;
  for (int w0 = 0; w0 < W; w0 += blockDim.x) {
    const int w = w0 + tid;
    const bool active = w < W;
    int cnt = 0;
    for (int q = q0; q < rbp; ++q) {
      bool s = false;
      if (active) {
        const uint8_t* px = frame + (start + q * pool) * row_bytes + 3LL * w;
        int sb = 0, sg = 0, sr = 0;
        for (int k = 0; k < pool; ++k, px += row_bytes) {
          sb += px[0]; sg += px[1]; sr += px[2];
        }
        s = is_skin(__fmul_rn((float)sb, inv), __fmul_rn((float)sg, inv),
                    __fmul_rn((float)sr, inv), skin);
      }
      const unsigned bal = __ballot_sync(0xffffffffu, s);
      if (lane == 0 && bal) atomicAdd(&rowsum[q], __popc(bal));
      cnt += s;
    }
    if (active) colcnt[w] = cnt;
    cells += cnt;
  }
  for (int off = 16; off > 0; off >>= 1)
    cells += __shfl_down_sync(0xffffffffu, cells, off);
  if (lane == 0) atomicAdd(&s_cells, cells);
  __syncthreads();
  for (int q = q0 + tid; q < rbp; q += blockDim.x) {
    if (rowsum[q] >= 2) {
      atomicMin(&s_rmin, start + q * pool);
      atomicMax(&s_rmax, start + q * pool + pool - 1);
    }
  }
  __syncthreads();
  if (tid == 0) {
    stat[0] = s_cells; stat[1] = s_rmin; stat[2] = s_rmax;
  }
}

}  // namespace vhr
