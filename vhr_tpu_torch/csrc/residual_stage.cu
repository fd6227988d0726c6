// K5: one residual bottleneck stage of the MediaPipe face-mesh net, for
// Hopper (sm_90a).
//
// Replaces vhr_tpu/ops/pallas_meshblocks.py::residual_stage_pallas (body
// _kernel).  Plain version: ops/meshblocks_cuda.py::residual_stage_plain.
//
//   x = prelu(x, a0)
//   for each of the N blocks k:
//     h = prelu(w1[k] . x + b1[k], a1[k])                     (Cm channels)
//     d = bdw[k] + sum_taps dw[k][t] * h(y+dy, x+dx)           (SAME, zero pad)
//     x = prelu(x + (w2[k] . d + b2[k]), a2[k])                (C channels)
//
// on x (B, C, H*W): a frame's NCHW planes, read once and written once, in
// float32 or bfloat16, with float32 arithmetic inside.
//
// Bound.  Per pixel and block the two 1x1 convs are 4*C*Cm operations and
// the depthwise conv 18*Cm; a stage's input and output are 2*C*4 bytes a
// pixel in float32.  The mesh net's four stages (128x128 C=16 Cm=8, 64x64
// 32/16, 32x32 64/32, 16x16 128/64, N=4) do 12 to 36 operations per byte:
// against 67 TFLOP/s of float32 on the CUDA cores and 3.35 TB/s, the first
// stage is balanced and the other three are bound by operations.
//
// Design.  One thread block per (frame, band of output rows).  The block
// loads its band of x plus N halo rows on each side (each 3x3 depthwise conv
// widens the rows it needs by one; rows beyond the frame are not loaded)
// into shared memory as float32, applies the entry PReLU, and runs the N
// blocks there: step A writes h for every row whose x is current into a
// second shared buffer; step B computes, for each pixel, d in registers from
// the nine neighbours of h (a neighbour outside the frame contributes
// nothing, which is SAME zero padding of h), then the C outputs of the
// second 1x1 conv, the residual add and the PReLU in place in x.  After
// block k the rows that are current shrink by one on each side that is not
// the frame's edge, so after N blocks exactly the band is right, and only it
// is written.  Each thread owns one pixel at a time and keeps Cm float32
// accumulators in registers (Cm is a template argument); the weights are
// read through the read-only cache, the same address across a warp, four at
// a time as float4.  The band is the largest whose x and h fit the card's
// shared memory (ops/meshblocks_cuda.py::stage_rows); the mesh net's four
// stages all need 12 KB a row, so bands of 10 rows (plus 8 halo rows) at
// 128x128 and 64x64, 8 at 32x32, and whole frames at 16x16.  No tensor
// cores: making it fast (bf16 mma on the 1x1 convs, less recomputed halo) is
// later work.  Products are fused multiply-adds (__fmaf_rn): the sums differ
// from the plain version's only in rounding order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float prelu(float v, float a) {
  return v >= 0.f ? v : v * a;
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

template <int CM, typename T>
__global__ void __launch_bounds__(kThreads)
residual_stage_kernel(const T* __restrict__ x, T* __restrict__ out,
                      const float* __restrict__ a0,
                      const float* __restrict__ w1,
                      const float* __restrict__ b1,
                      const float* __restrict__ a1,
                      const float* __restrict__ dw,
                      const float* __restrict__ bdw,
                      const float* __restrict__ w2,
                      const float* __restrict__ b2,
                      const float* __restrict__ a2, int C, int H, int W,
                      int n_blocks, int rows) {
  extern __shared__ float smem[];
  const int r0 = blockIdx.x * rows;
  const int r1 = min(H, r0 + rows);
  const int lo = max(0, r0 - n_blocks);  // rows held: [lo, hi)
  const int hi = min(H, r1 + n_blocks);
  const int plane = (hi - lo) * W;
  const long long frame = (long long)C * H * W;
  float* xs = smem;                        // [C][hi - lo][W]
  float* hs = smem + (long long)C * plane;  // [CM][hi - lo][W]

  const T* src = x + blockIdx.y * frame + (long long)lo * W;
  for (int i = threadIdx.x; i < C * plane; i += kThreads) {
    const int c = i / plane;
    xs[i] = prelu(load_f32(src + (long long)c * H * W + (i - c * plane)),
                  a0[c]);
  }
  __syncthreads();

  int vlo = lo, vhi = hi;  // rows whose x is current
  for (int k = 0; k < n_blocks; ++k) {
    const float* w1k = w1 + (long long)k * CM * C;
    const float* b1k = b1 + k * CM;
    const float* a1k = a1 + k * CM;
    const float* dwk = dw + k * 9 * CM;
    const float* bdwk = bdw + k * CM;
    const float* w2k = w2 + (long long)k * C * CM;
    const float* b2k = b2 + k * C;
    const float* a2k = a2 + k * C;

    // Step A: h = prelu(w1 . x + b1, a1) on the current rows.
    const int offA = (vlo - lo) * W;
    for (int p = threadIdx.x; p < (vhi - vlo) * W; p += kThreads) {
      const int q = offA + p;
      float acc[CM];
#pragma unroll
      for (int m = 0; m < CM; ++m) acc[m] = 0.f;
      for (int c = 0; c < C; c += 4) {
        const float x0 = xs[(c + 0) * plane + q];
        const float x1 = xs[(c + 1) * plane + q];
        const float x2 = xs[(c + 2) * plane + q];
        const float x3 = xs[(c + 3) * plane + q];
#pragma unroll
        for (int m = 0; m < CM; ++m) {
          const float4 w = ldg4(w1k + m * C + c);
          acc[m] = __fmaf_rn(w.x, x0, acc[m]);
          acc[m] = __fmaf_rn(w.y, x1, acc[m]);
          acc[m] = __fmaf_rn(w.z, x2, acc[m]);
          acc[m] = __fmaf_rn(w.w, x3, acc[m]);
        }
      }
#pragma unroll
      for (int m = 0; m < CM; ++m)
        hs[m * plane + q] = prelu(acc[m] + b1k[m], a1k[m]);
    }
    __syncthreads();

    // Step B on the rows that stay right: depthwise 3x3 into registers,
    // then the second 1x1 conv, the residual add and the PReLU in place.
    const int nlo = vlo > 0 ? vlo + 1 : vlo;
    const int nhi = vhi < H ? vhi - 1 : vhi;
    const int offB = (nlo - lo) * W;
    for (int p = threadIdx.x; p < (nhi - nlo) * W; p += kThreads) {
      const int q = offB + p;
      const int yy = nlo + p / W, xx = p % W;
      float d[CM];
#pragma unroll
      for (int m = 0; m < CM; ++m) d[m] = bdwk[m];
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int dy = t / 3 - 1, dx = t % 3 - 1;
        if (yy + dy < 0 || yy + dy >= H || xx + dx < 0 || xx + dx >= W)
          continue;
        const int qs = q + dy * W + dx;
#pragma unroll
        for (int m = 0; m < CM; m += 4) {
          const float4 w = ldg4(dwk + t * CM + m);
          d[m + 0] = __fmaf_rn(w.x, hs[(m + 0) * plane + qs], d[m + 0]);
          d[m + 1] = __fmaf_rn(w.y, hs[(m + 1) * plane + qs], d[m + 1]);
          d[m + 2] = __fmaf_rn(w.z, hs[(m + 2) * plane + qs], d[m + 2]);
          d[m + 3] = __fmaf_rn(w.w, hs[(m + 3) * plane + qs], d[m + 3]);
        }
      }
      for (int c = 0; c < C; ++c) {
        float acc = 0.f;
#pragma unroll
        for (int m = 0; m < CM; m += 4) {
          const float4 w = ldg4(w2k + c * CM + m);
          acc = __fmaf_rn(w.x, d[m + 0], acc);
          acc = __fmaf_rn(w.y, d[m + 1], acc);
          acc = __fmaf_rn(w.z, d[m + 2], acc);
          acc = __fmaf_rn(w.w, d[m + 3], acc);
        }
        float* xc = xs + c * plane + q;
        *xc = prelu(*xc + (acc + b2k[c]), a2k[c]);
      }
    }
    __syncthreads();
    vlo = nlo;
    vhi = nhi;
  }

  T* dst = out + blockIdx.y * frame + (long long)r0 * W;
  const int n_out = (r1 - r0) * W, off = (r0 - lo) * W;
  for (int i = threadIdx.x; i < C * n_out; i += kThreads) {
    const int c = i / n_out, p = i - c * n_out;
    store_f32(dst + (long long)c * H * W + p, xs[c * plane + off + p]);
  }
}

template <int CM, typename T>
int launch(const void* x, void* out, const float* const* w, int B, int C,
           int H, int W, int n_blocks, int rows, int smem,
           cudaStream_t stream) {
  auto kernel = residual_stage_kernel<CM, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H + rows - 1) / rows, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), w[0], w[1], w[2], w[3],
      w[4], w[5], w[6], w[7], w[8], C, H, W, n_blocks, rows);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int Cm, const void* x, void* out, const float* const* w, int B,
             int C, int H, int W, int n_blocks, int rows, int smem,
             cudaStream_t stream) {
  switch (Cm) {
    case 8:
      return launch<8, T>(x, out, w, B, C, H, W, n_blocks, rows, smem,
                          stream);
    case 16:
      return launch<16, T>(x, out, w, B, C, H, W, n_blocks, rows, smem,
                           stream);
    case 32:
      return launch<32, T>(x, out, w, B, C, H, W, n_blocks, rows, smem,
                           stream);
    case 64:
      return launch<64, T>(x, out, w, B, C, H, W, n_blocks, rows, smem,
                           stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, out: (B, C, H*W) float32 (bf16 == 0) or bfloat16 (bf16 == 1); the nine
// weights as StageWeights orders them, contiguous float32, 16-byte aligned.
// Cm in {8, 16, 32, 64}, C % 4 == 0; rows and smem from stage_rows.
extern "C" int vhr_residual_stage(const void* x, void* out, int bf16,
                                  const float* a0, const float* w1,
                                  const float* b1, const float* a1,
                                  const float* dw, const float* bdw,
                                  const float* w2, const float* b2,
                                  const float* a2, int B, int C, int Cm,
                                  int H, int W, int n_blocks, int rows,
                                  int smem, cudaStream_t stream) {
  if (B <= 0 || C <= 0 || C % 4 != 0 || H <= 0 || W <= 0 || rows <= 0 ||
      n_blocks < 0)
    return (int)cudaErrorInvalidValue;
  const float* w[9] = {a0, w1, b1, a1, dw, bdw, w2, b2, a2};
  return bf16 ? dispatch<__nv_bfloat16>(Cm, x, out, w, B, C, H, W, n_blocks,
                                        rows, smem, stream)
              : dispatch<float>(Cm, x, out, w, B, C, H, W, n_blocks, rows,
                                smem, stream);
}
