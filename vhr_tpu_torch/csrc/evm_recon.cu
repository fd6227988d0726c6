// K7: EVM reconstruction -- u8 BGR -> YIQ, + bilinear upsample of the
// amplified band, -> BGR, clamp, u8, for Hopper (sm_90a).
//
// Replaces vhr_tpu/ops/pallas_evm_recon.py::evm_reconstruct_pallas (body
// _kernel).  Plain version: ops/evm_recon_cuda.py::evm_reconstruct_plain.
//
// Per output pixel (t, r, x):
//   1. YIQ from the u8 BGR pixel times f32(1/255);
//   2. + the band's bilinear sample (half-pixel centres, edge clamp), rows
//      first: v[c, k] = Uv[r, :] @ band[t, c, :, k], then up = v[c, :] @
//      Uh[:, x].  Each row of Uv and column of Uh has at most two non-zero
//      weights; the host passes them as tables (lo, hi, w_lo, w_hi) taken
//      from resize_matrix, so they are the plain version's weights exactly.
//      Each two-term product is rounded as a sequential dot product rounds
//      it, fma(w_hi, x_hi, w_lo * x_lo);
//   3. inverse YIQ, then clip(x * 255 + 0.5, 0, 255) truncated to u8.
//
// Bound: device-memory bytes.  A 1080p frame is 6.2 MB of u8 in and 6.2 MB
// out; the band (98 KB a frame at 4 levels) is read once per block from L2.
// Pixels are addressed by element strides (t, c, h, w), so one kernel reads
// and writes the interleaved (T, H, W, 3) frames of the EVM path with no
// transposes, and the planar (T, 3, H, W) layout of the Pallas contract.
//
// Design: one block per (frame, tile of `rows` output rows).  The block
// first interpolates its rows of the band vertically into shared memory
// (rows x 3 x wb floats), then each thread walks the columns of each row.
// --fmad=false keeps every other product rounded on its own, as the plain
// PyTorch version rounds it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 8;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;

struct Strides {
  long long t, c, h, w;
};

__device__ __forceinline__ uint8_t to_u8(float v) {
  v = fminf(fmaxf(v * 255.0f + 0.5f, 0.0f), 255.0f);
  return (uint8_t)(int)v;
}

__global__ void __launch_bounds__(kThreads)
evm_reconstruct_kernel(const uint8_t* __restrict__ in, Strides is,
                       uint8_t* __restrict__ out, Strides os,
                       const float* __restrict__ band, int hb, int wb,
                       const int32_t* __restrict__ v_lo,
                       const int32_t* __restrict__ v_hi,
                       const float* __restrict__ v_wlo,
                       const float* __restrict__ v_whi,
                       const int32_t* __restrict__ h_lo,
                       const int32_t* __restrict__ h_hi,
                       const float* __restrict__ h_wlo,
                       const float* __restrict__ h_whi,
                       int H, int W, int rows, int tiles_y) {
  extern __shared__ float vrow[];  // [rows][3][wb]
  const long long t = blockIdx.x / tiles_y;
  const int r0 = (int)(blockIdx.x % tiles_y) * rows;
  const int nr = min(rows, H - r0);
  const float* bt = band + t * 3LL * hb * wb;

  for (int k = threadIdx.x; k < nr * 3 * wb; k += kThreads) {
    const int rr = k / (3 * wb), rem = k - rr * 3 * wb;
    const int c = rem / wb, col = rem - c * wb;
    const int r = r0 + rr;
    const float* plane = bt + (long long)c * hb * wb;
    vrow[k] = __fmaf_rn(v_whi[r], plane[(long long)v_hi[r] * wb + col],
                        v_wlo[r] * plane[(long long)v_lo[r] * wb + col]);
  }
  __syncthreads();

  const float scale = (float)(1.0 / 255.0);
  for (int rr = 0; rr < nr; ++rr) {
    const long long r = r0 + rr;
    const uint8_t* src = in + t * is.t + r * is.h;
    uint8_t* dst = out + t * os.t + r * os.h;
    const float* vy = vrow + rr * 3 * wb;
    const float* vi = vy + wb;
    const float* vq = vi + wb;
    for (int x = threadIdx.x; x < W; x += kThreads) {
      const uint8_t* p = src + x * is.w;
      const float b = (float)p[0] * scale;
      const float g = (float)p[is.c] * scale;
      const float r_ = (float)p[2 * is.c] * scale;
      float y = (float)0.30 * r_ + (float)0.59 * g + (float)0.11 * b;
      float iq1 = (float)0.74 * (r_ - y) - (float)0.27 * (b - y);
      float iq2 = (float)0.48 * (r_ - y) + (float)0.41 * (b - y);
      const int lo = h_lo[x], hi = h_hi[x];
      const float wl = h_wlo[x], wh = h_whi[x];
      y = y + __fmaf_rn(vy[hi], wh, vy[lo] * wl);
      iq1 = iq1 + __fmaf_rn(vi[hi], wh, vi[lo] * wl);
      iq2 = iq2 + __fmaf_rn(vq[hi], wh, vq[lo] * wl);
      const float r2 = y + (float)0.9468822170900693 * iq1
                       + (float)0.6235565819861433 * iq2;
      const float g2 = y - (float)0.27478764629897834 * iq1
                       - (float)0.6356910791873801 * iq2;
      const float b2 = y - (float)1.1085450346420322 * iq1
                       + (float)1.7090069284064666 * iq2;
      uint8_t* q = dst + x * os.w;
      q[0] = to_u8(b2);
      q[os.c] = to_u8(g2);
      q[2 * os.c] = to_u8(r2);
    }
  }
}

}  // namespace

extern "C" int vhr_evm_reconstruct(
    const uint8_t* in, long long ist, long long isc, long long ish,
    long long isw, uint8_t* out, long long ost, long long osc, long long osh,
    long long osw, const float* band, const int32_t* v_lo,
    const int32_t* v_hi, const float* v_wlo, const float* v_whi,
    const int32_t* h_lo, const int32_t* h_hi, const float* h_wlo,
    const float* h_whi, int T, int H, int W, int hb, int wb,
    cudaStream_t stream) {
  if (H < 1 || W < 1 || hb < 1 || wb < 1) return (int)cudaErrorInvalidValue;
  const size_t per_row = 3 * (size_t)wb * sizeof(float);
  if (per_row > kMaxSmem) return (int)cudaErrorInvalidValue;
  int rows = (int)(kDefaultSmem / per_row);
  rows = rows < 1 ? 1 : (rows > kMaxRows ? kMaxRows : rows);
  const size_t smem = rows * per_row;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        evm_reconstruct_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles_y = (H + rows - 1) / rows;
  const long long blocks = (long long)T * tiles_y;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (blocks > 0) {
    evm_reconstruct_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
        in, Strides{ist, isc, ish, isw}, out, Strides{ost, osc, osh, osw},
        band, hb, wb, v_lo, v_hi, v_wlo, v_whi, h_lo, h_hi, h_wlo, h_whi, H,
        W, rows, tiles_y);
  }
  return (int)cudaGetLastError();
}
