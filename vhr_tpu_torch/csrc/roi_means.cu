// K2: per-frame ROI channel means of u8 frames, for Hopper (sm_90a).
//
// Replaces vhr_tpu/ops/pallas_roi.py::roi_channel_means_pallas
// (body _roi_mean_kernel).  Plain version: ops/reduce.py::roi_channel_means.
//
// Bound: device-memory bytes.  A frame is (H, W*C) u8; the cheek ROI is a
// small rectangle of it, so the kernel reads only the ROI's rows and, in
// each row, only the bytes [x1*C, x2*C): at 1080p about 0.2 MB of a 6.2 MB
// frame.  Arithmetic is one integer add per byte.
//
// Design: one block per frame, 32 x 8 threads.  threadIdx.x walks the
// ROI's columns (neighbouring threads read neighbouring pixels), threadIdx.y
// walks its rows.  Per-channel sums are integers, so they are exact and
// independent of summation order; they are reduced across the block with
// warp shuffles and shared memory.  The ROI is clamped to the frame for the
// reads; `count` is the unclipped area, as in the JAX kernel.  The mean is
// the float32 division (float)sum / max(count, 1).
//
// `roi_ok`, when not null, zeroes `count` where roi_ok[t * ok_stride] == 0
// (the fused kernel K1 reuses this kernel for its ROI sums that way).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxC = 4;
constexpr int kBx = 32;
constexpr int kBy = 8;

__global__ void __launch_bounds__(kBx * kBy)
roi_means_kernel(const uint8_t* __restrict__ frames,
                 const int32_t* __restrict__ rois,
                 const int32_t* __restrict__ roi_ok, int ok_stride,
                 float* __restrict__ means, float* __restrict__ count,
                 int H, int W, int C) {
  const long long t = blockIdx.x;
  const int x1 = rois[4 * t], y1 = rois[4 * t + 1];
  const int x2 = rois[4 * t + 2], y2 = rois[4 * t + 3];
  const int cx1 = max(x1, 0), cx2 = min(x2, W);
  const int cy1 = max(y1, 0), cy2 = min(y2, H);
  const long long row_stride = (long long)W * C;
  const uint8_t* base = frames + t * (long long)H * row_stride;

  unsigned int acc[kMaxC] = {0u, 0u, 0u, 0u};
  for (int r = cy1 + threadIdx.y; r < cy2; r += kBy) {
    const uint8_t* row = base + r * row_stride;
    for (int c = cx1 + threadIdx.x; c < cx2; c += kBx) {
      const uint8_t* px = row + (long long)c * C;
#pragma unroll
      for (int k = 0; k < kMaxC; ++k)
        if (k < C) acc[k] += px[k];
    }
  }

  __shared__ unsigned long long part[kBx * kBy / 32][kMaxC];
  const int tid = threadIdx.y * kBx + threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int k = 0; k < kMaxC; ++k) {
    unsigned long long v = acc[k];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) part[warp][k] = v;
  }
  __syncthreads();
  if (tid == 0) {
    const float n = (float)((long long)max(y2 - y1, 0) * max(x2 - x1, 0));
    const float denom = fmaxf(n, 1.0f);
    for (int k = 0; k < C; ++k) {
      unsigned long long s = 0;
      for (int w = 0; w < kBx * kBy / 32; ++w) s += part[w][k];
      means[t * C + k] = (float)s / denom;
    }
    const bool ok = roi_ok == nullptr || roi_ok[t * ok_stride] != 0;
    count[t] = ok ? n : 0.0f;
  }
}

}  // namespace

extern "C" int vhr_roi_means_u8(const uint8_t* frames, const int32_t* rois,
                                const int32_t* roi_ok, int ok_stride,
                                float* means, float* count,
                                int T, int H, int W, int C,
                                cudaStream_t stream) {
  if (C < 1 || C > kMaxC) return (int)cudaErrorInvalidValue;
  if (T > 0) {
    roi_means_kernel<<<T, dim3(kBx, kBy), 0, stream>>>(
        frames, rois, roi_ok, ok_stride, means, count, H, W, C);
  }
  return (int)cudaGetLastError();
}
