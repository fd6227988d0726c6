// K6: EVM front-end -- 5-tap binomial blur, 2x decimation and BGR -> YIQ of
// u8 frames, for Hopper (sm_90a).
//
// Replaces vhr_tpu/ops/pallas_evm.py::yiq_pyrdown_pallas (body _kernel).
// Plain version: ops/evm_cuda.py::yiq_pyrdown_plain.
//
//   out[t, c, j, i] = YIQ_c(sum_a sum_b w_a w_b x[t, cl(2j+a-2), cl(2i+b-2)])
//                     * f32(1/255),   w = [1, 4, 6, 4, 1] / 16,
//
// with rows and columns clamped to the frame (edge replicate), h_out = H/2
// and w_out = W/2 (floor), as the Pallas kernel computes them.
//
// Bound: device-memory bytes.  A 1080p frame is 6.2 MB of u8 in and 6.2 MB
// of f32 out (a quarter of the pixels, 3 floats each); the arithmetic is a
// few integer adds per input byte.  The Pallas kernel needs planar input
// with 128-lane rows and an 8-row edge pad (Mosaic layout); this kernel reads
// the interleaved (T, H, W, 3) frames directly, any W >= 2 and H >= 2.
//
// Design: one block per (frame, tile of 16 output rows x 64 output columns).
// The block stages its (2*16+3) x (2*64+3) x 3 u8 input window in shared
// memory, clamping indices on load, then runs the vertical 5-tap pass into a
// uint16 tile (sums <= 16 * 255) and the horizontal pass in int32 (<= 65280).
// The blur is integer and so exact; dividing by 256 is exact in float32, so
// the blur equals the float32 matrix products of the Pallas kernel bit for
// bit.  Only the YIQ combine rounds; it is written in the Pallas kernel's
// order, and the build's --fmad=false keeps every product rounded on its
// own, as the plain PyTorch version rounds it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTR = 16;               // output rows per block
constexpr int kTC = 64;               // output columns per block
constexpr int kInR = 2 * kTR + 3;     // staged input rows
constexpr int kInB = (2 * kTC + 3) * 3;  // staged input bytes per row
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
yiq_pyrdown_kernel(const uint8_t* __restrict__ frames,
                   float* __restrict__ out, int H, int W, int h_out,
                   int w_out, int tiles_x, int tiles_y) {
  __shared__ uint8_t win[kInR][kInB];
  __shared__ uint16_t vsum[kTR][kInB];

  const long long tile = blockIdx.x;
  const int tx = (int)(tile % tiles_x);
  const int ty = (int)((tile / tiles_x) % tiles_y);
  const long long t = tile / ((long long)tiles_x * tiles_y);
  const int j0 = ty * kTR, i0 = tx * kTC;
  const int r0 = 2 * j0 - 2, c0 = 2 * i0 - 2;
  const uint8_t* src = frames + t * (long long)H * W * 3;

  for (int k = threadIdx.x; k < kInR * kInB; k += kThreads) {
    const int ir = k / kInB, b = k - ir * kInB;
    const int ic = b / 3, ch = b - ic * 3;
    const int gr = min(max(r0 + ir, 0), H - 1);
    const int gc = min(max(c0 + ic, 0), W - 1);
    win[ir][b] = src[((long long)gr * W + gc) * 3 + ch];
  }
  __syncthreads();

  for (int k = threadIdx.x; k < kTR * kInB; k += kThreads) {
    const int jr = k / kInB, b = k - jr * kInB;
    const int r = 2 * jr;
    vsum[jr][b] = (uint16_t)(win[r][b] + 4 * win[r + 1][b] + 6 * win[r + 2][b]
                             + 4 * win[r + 3][b] + win[r + 4][b]);
  }
  __syncthreads();

  const float scale = (float)(1.0 / 255.0);
  const long long plane = (long long)h_out * w_out;
  float* dst = out + t * 3 * plane;
  for (int k = threadIdx.x; k < kTR * kTC; k += kThreads) {
    const int jr = k / kTC, ic = k - jr * kTC;
    const int j = j0 + jr, i = i0 + ic;
    if (j >= h_out || i >= w_out) continue;
    const uint16_t* p = &vsum[jr][6 * ic];
    float bgr[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const int s = p[ch] + 4 * p[3 + ch] + 6 * p[6 + ch] + 4 * p[9 + ch]
                    + p[12 + ch];
      bgr[ch] = (float)s * (1.0f / 256.0f);
    }
    const float b = bgr[0], g = bgr[1], r = bgr[2];
    const float y = (float)0.30 * r + (float)0.59 * g + (float)0.11 * b;
    const float iq1 = (float)0.74 * (r - y) - (float)0.27 * (b - y);
    const float iq2 = (float)0.48 * (r - y) + (float)0.41 * (b - y);
    const long long o = (long long)j * w_out + i;
    dst[o] = y * scale;
    dst[plane + o] = iq1 * scale;
    dst[2 * plane + o] = iq2 * scale;
  }
}

}  // namespace

extern "C" int vhr_yiq_pyrdown(const uint8_t* frames, float* out, int T,
                               int H, int W, cudaStream_t stream) {
  if (H < 2 || W < 2) return (int)cudaErrorInvalidValue;
  const int h_out = H / 2, w_out = W / 2;
  const int tiles_x = (w_out + kTC - 1) / kTC;
  const int tiles_y = (h_out + kTR - 1) / kTR;
  const long long blocks = (long long)T * tiles_x * tiles_y;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (blocks > 0) {
    yiq_pyrdown_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
        frames, out, H, W, h_out, w_out, tiles_x, tiles_y);
  }
  return (int)cudaGetLastError();
}
