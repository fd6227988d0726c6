// K3: per-frame ROI channel means of u8 frames, 8 frames per block, for
// Hopper (sm_90a).
//
// Replaces vhr_tpu/ops/pallas_roi.py::roi_channel_means_pallas_batched
// (body _roi_mean_batched_kernel, pallas_call at :324).  Plain version:
// ops/reduce.py::roi_channel_means.  Same result as K2 (roi_means.cu).
//
// Bound: device-memory bytes.  A frame is (H, W*C) u8 rows; the cheek ROI
// is a small rectangle of it (about 0.2 MB of a 6.2 MB frame at 1080p), so
// the least traffic is the ROI's own bytes.  Arithmetic is a few integer
// operations per byte.
//
// Design.  The TPU kernel gives 8 frames one grid step and one slab DMA
// over the union of their ROI row spans, to amortise a DMA and a grid-step
// cost.  On the card every frame's bytes are separate memory anyway, so
// there is no union slab: one block takes a batch of 8 frames and each
// frame's ROI gets its own 4 warps.  The frame's 128 threads walk the
// (row, 16-byte vector) pairs of its ROI: only the ROI's rows are read, and
// in each row only the byte span [x1*C, x2*C), with 16-byte loads at
// addresses aligned down and up to 16 bytes.  Each 32-bit word of a load is
// masked per byte by the span (SIMD byte compares) and by channel (the
// channel of a byte follows from its offset in the row), and its bytes are
// summed with __dp4a into per-channel integer sums: exact, and independent
// of order.  Rows are addressed through a row pitch and a frame stride, so
// padded rows need no copy.  The ragged last batch is masked inside the
// same launch.  Reads are clamped to the frame; `count` is the unclipped
// area and the mean is the float32 division (float)sum / max(count, 1), as
// in reduce.roi_channel_means.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFrames = 8;                 // frames per block
constexpr int kThreads = 4 * 32;           // threads per frame (4 warps)

// Word j of a 16-byte vector with 0xFF in the bytes k = 4j+b whose
// k % C == q, else 0.
template <int C>
__device__ __forceinline__ uint32_t phase_word(int q, int j) {
  uint32_t m = 0u;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if ((4 * j + b) % C == q) m |= 0xFFu << (8 * b);
  return m;
}

template <int C>
__global__ void __launch_bounds__(kFrames * kThreads)
roi_means_batched_kernel(const uint8_t* __restrict__ frames,
                         long long frame_stride, long long row_pitch,
                         const int32_t* __restrict__ rois,
                         float* __restrict__ means, float* __restrict__ count,
                         int T, int H, int W) {
  __shared__ unsigned long long sums[kFrames][C];
  const int f = threadIdx.y;
  const int tid = threadIdx.x;
  const long long t = (long long)blockIdx.x * kFrames + f;
  if (tid < C) sums[f][tid] = 0ull;
  __syncthreads();

  unsigned int acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0u;
  int x1 = 0, y1 = 0, x2 = 0, y2 = 0;
  if (t < T) {                              // the ragged batch's tail idles
    x1 = rois[4 * t];
    y1 = rois[4 * t + 1];
    x2 = rois[4 * t + 2];
    y2 = rois[4 * t + 3];
  }
  const int cx1 = max(x1, 0), cx2 = min(x2, W);
  const int cy1 = max(y1, 0), cy2 = min(y2, H);
  if (t < T && cx2 > cx1 && cy2 > cy1) {
    const uint8_t* base = frames + t * frame_stride;
    const long long b0 = (long long)cx1 * C, b1 = (long long)cx2 * C;
    // 16-byte vectors per row: the most a span of b1-b0 bytes can touch at
    // any alignment; the one past a row's end is skipped.
    const int nv = (int)((b1 - b0 + 15) / 16) + 1;
    const int items = (cy2 - cy1) * nv;
    const int dr = kThreads / nv, dv = kThreads % nv;
    int r = tid / nv, v = tid % nv;
    for (int it = tid; it < items; it += kThreads) {
      const uint8_t* row = base + (long long)(cy1 + r) * row_pitch;
      const uintptr_t lo_addr = reinterpret_cast<uintptr_t>(row + b0);
      const uintptr_t hi_addr = reinterpret_cast<uintptr_t>(row + b1);
      const uintptr_t a = (lo_addr & ~(uintptr_t)15) + 16u * (uintptr_t)v;
      if (a < hi_addr) {
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(a));
        const long long rel = (long long)a - (long long)lo_addr;
        const uint32_t lo4 = (uint32_t)(rel < 0 ? -rel : 0) * 0x01010101u;
        const long long left = (long long)hi_addr - (long long)a;
        const uint32_t hi4 = (uint32_t)(left < 16 ? left : 16) * 0x01010101u;
        // Channel of the vector's first byte: its offset in the row mod C.
        int ph = (int)((rel + b0) % C);
        if (ph < 0) ph += C;
        const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t idx = 0x03020100u + (uint32_t)j * 0x04040404u;
          const uint32_t x = words[j] & __vcmpgeu4(idx, lo4)
                             & __vcmpltu4(idx, hi4);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            // Byte k holds channel (ph + k) % C: channel c's bytes are
            // those with k % C == (c - ph) mod C.
            const int q = (c - ph + C) % C;
            uint32_t m = phase_word<C>(0, j);
#pragma unroll
            for (int p = 1; p < C; ++p)
              m = q == p ? phase_word<C>(p, j) : m;
            acc[c] = __dp4a(x & m, 0x01010101u, acc[c]);
          }
        }
      }
      r += dr;
      v += dv;
      if (v >= nv) {
        v -= nv;
        ++r;
      }
    }
  }

#pragma unroll
  for (int c = 0; c < C; ++c) {
    unsigned long long s = acc[c];
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if ((tid & 31) == 0 && s != 0ull) atomicAdd(&sums[f][c], s);
  }
  __syncthreads();
  if (t < T && tid < C) {
    const float n = (float)((long long)max(y2 - y1, 0) * max(x2 - x1, 0));
    means[t * C + tid] = (float)sums[f][tid] / fmaxf(n, 1.0f);
    if (tid == 0) count[t] = n;
  }
}

template <int C>
void launch(const uint8_t* frames, long long frame_stride,
            long long row_pitch, const int32_t* rois, float* means,
            float* count, int T, int H, int W, cudaStream_t stream) {
  const dim3 grid((T + kFrames - 1) / kFrames), block(kThreads, kFrames);
  roi_means_batched_kernel<C><<<grid, block, 0, stream>>>(
      frames, frame_stride, row_pitch, rois, means, count, T, H, W);
}

}  // namespace

extern "C" int vhr_roi_means_batched_u8(const uint8_t* frames,
                                        long long frame_stride,
                                        long long row_pitch,
                                        const int32_t* rois, float* means,
                                        float* count, int T, int H, int W,
                                        int C, cudaStream_t stream) {
  if (T > 0) {
    switch (C) {
      case 1: launch<1>(frames, frame_stride, row_pitch, rois, means, count,
                        T, H, W, stream); break;
      case 2: launch<2>(frames, frame_stride, row_pitch, rois, means, count,
                        T, H, W, stream); break;
      case 3: launch<3>(frames, frame_stride, row_pitch, rois, means, count,
                        T, H, W, stream); break;
      case 4: launch<4>(frames, frame_stride, row_pitch, rois, means, count,
                        T, H, W, stream); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
