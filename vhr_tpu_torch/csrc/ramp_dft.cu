// The acquisition ramp: the DFT peak of every growing window x[:N], for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: vhr_tpu/ops/windows.py::_ramp_bpm is plain jnp,
// left to XLA.  The port's plain version, ops/windows.py::_ramp_bpm, builds
// a (lengths, bins, N) angle tensor a chunk of 64 lengths and multiplies it
// into every trace: some 6 ms of PyTorch kernels a skin call (601 lengths,
// 8 traces, N up to 900), launched from the host chunk by chunk.  This is
// one launch for every length and stream, written straight into the
// estimate's rows.
//
// For each length N in [n_first, n_last] and stream s, exactly what the
// plain version computes (the float32 order of operations the port keeps
// from JAX):
//   mean = sum(x[:N]) / N, xm = x[:N] - mean;
//   c = -2pi_f32 / N, ang = (c * k) * n, re = sum cos(ang) * xm,
//   im = sum sin(ang) * xm, mag = sqrt(re * re + im * im);
//   freq = k * (fps / N), in band where low <= freq <= high and
//   1 <= k <= min(k_max, (N - 1) / 2);
//   the first in-band bin of the largest magnitude (NaN the largest, as
//   torch.argmax takes it); bpm = freq * 60; valid = some bin in band and
//   N >= 8.  No bin in band: bpm 0, valid false.
// sincosf is the precise one (no fast math) and --fmad=false rounds every
// product but the accumulations, which are fused multiply-adds: the sums
// run in another order than the plain version's anyway, so a bpm may
// differ only where two in-band magnitudes lie within rounding of each
// other.
//
// Bound: float32 instruction throughput.  At the skin cell's shapes (N =
// 300..900, 8 streams, 30 fps, 40-200 BPM) some 20.8M in-band (k, n)
// pairs, each one sincosf and 2 * 8 multiply-adds: 0.67 GFLOP of
// multiply-adds, 10 us at 67 TFLOP/s, but the sincosf takes some 30
// instructions a pair, so the kernel is bound by those instructions, not
// by the multiply-adds.  The design keeps everything else off that path:
// - A block is one (length, tile of streams) pair, the longest lengths
//   first so that the short blocks fill the tail.  The host picks the tile
//   (ops/ramp_cuda.py::ramp_plan) from S and n_last alone: rows x pitch x
//   4 bytes of shared memory, balanced tiles of at most 16 streams.
// - The block loads x[:N] of its streams once, 16 bytes a load, from a
//   (S, pitch) copy, demeans it in shared memory (rows past the tile zero).
// - Only in-band bins are evaluated (an excluded bin is -inf in the plain
//   version and can never be the argmax): 20.8M pairs against the plain
//   version's 54.6M angles.  The block's warps take the in-band bins round
//   robin; a warp's lanes walk n, each (k, n) angle's sincosf computed once
//   for every stream of the tile, with the tile's re and im accumulators in
//   registers and the shared loads conflict-free (neighbouring lanes,
//   neighbouring n).
// - A bin's sums are reduced by warp shuffles; lane 0 keeps the warp's best
//   bin of each stream in shared memory; the block combines its warps'
//   bests (first bin on ties) and writes bpm and valid.
// The launch allocates nothing, runs on the caller's stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegTwoPi = -6.28318530717958647692f;  // f32(-2 pi)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

// Whether bin ka of magnitude a comes before bin kb of magnitude b in
// torch.argmax's order: NaN above all, then the larger, then the first.
// kb < 0 is no bin yet; ka < 0 never wins.
__device__ __forceinline__ bool beats(float a, int ka, float b, int kb) {
  if (ka < 0) return false;
  if (kb < 0) return true;
  const bool na = isnan(a), nb = isnan(b);
  if (na != nb) return na;
  if (na || a == b) return ka < kb;
  return a > b;
}

template <int ROWS>
__global__ void __launch_bounds__(kThreads)
ramp_dft_kernel(const float* __restrict__ x, int S, int pitch, int n_first,
                int n_last, int k_max, float fps, float low, float high,
                int tile, float* __restrict__ bpm,
                uint8_t* __restrict__ valid) {
  extern __shared__ float4 smem[];
  float* xm = reinterpret_cast<float*>(smem);        // [ROWS][pitch]
  __shared__ float s_mean[ROWS];
  __shared__ float s_mag[kWarps][ROWS];
  __shared__ int s_k[kWarps][ROWS];

  const int N = n_last - (int)blockIdx.x;            // the longest first
  const int s0 = (int)blockIdx.y * tile;
  const int ns = min(tile, S - s0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // x[:N] of the tile's streams, 16 bytes a load (the pitch holds the
  // last vector); rows past the tile zero.
  const int nv = (N + 3) >> 2;
  for (int i = threadIdx.x; i < ROWS * nv; i += kThreads) {
    const int s = i / nv, v = i - s * nv;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < ns)
      val = __ldg(reinterpret_cast<const float4*>(x + (size_t)(s0 + s) * pitch)
                  + v);
    reinterpret_cast<float4*>(xm + s * pitch)[v] = val;
  }
  if (threadIdx.x < kWarps * ROWS) {
    s_mag[threadIdx.x / ROWS][threadIdx.x % ROWS] = -INFINITY;
    s_k[threadIdx.x / ROWS][threadIdx.x % ROWS] = -1;
  }
  __syncthreads();
  for (int s = warp; s < ROWS; s += kWarps) {
    float sum = 0.f;
    for (int n = lane; n < N; n += 32) sum = __fadd_rn(sum, xm[s * pitch + n]);
    sum = warp_sum(sum);
    if (lane == 0) s_mean[s] = __fdiv_rn(sum, (float)N);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ROWS * N; i += kThreads) {
    const int s = i / N, n = i - s * N;
    xm[s * pitch + n] = __fsub_rn(xm[s * pitch + n], s_mean[s]);
  }
  __syncthreads();

  const float c = __fdiv_rn(kNegTwoPi, (float)N);
  const float step = __fdiv_rn(fps, (float)N);
  const int k_top = min(k_max, (N - 1) / 2);
  int j = 0;                                   // in-band bins seen so far
  for (int k = 1; k <= k_top; ++k) {
    const float f = __fmul_rn((float)k, step);
    if (!(f >= low && f <= high)) continue;
    if (j++ % kWarps != warp) continue;
    const float ck = __fmul_rn(c, (float)k);
    float re[ROWS], im[ROWS];
#pragma unroll
    for (int s = 0; s < ROWS; ++s) re[s] = im[s] = 0.f;
    for (int n = lane; n < N; n += 32) {
      float sn, cs;
      sincosf(__fmul_rn(ck, (float)n), &sn, &cs);
      const float* col = xm + n;
#pragma unroll
      for (int s = 0; s < ROWS; ++s) {
        const float v = col[s * pitch];
        re[s] = __fmaf_rn(cs, v, re[s]);
        im[s] = __fmaf_rn(sn, v, im[s]);
      }
    }
#pragma unroll
    for (int s = 0; s < ROWS; ++s) {
      re[s] = warp_sum(re[s]);
      im[s] = warp_sum(im[s]);
    }
    if (lane == 0) {
#pragma unroll
      for (int s = 0; s < ROWS; ++s) {
        const float mag = __fsqrt_rn(__fadd_rn(__fmul_rn(re[s], re[s]),
                                               __fmul_rn(im[s], im[s])));
        if (beats(mag, k, s_mag[warp][s], s_k[warp][s])) {
          s_mag[warp][s] = mag;
          s_k[warp][s] = k;
        }
      }
    }
  }
  __syncthreads();

  if ((int)threadIdx.x < ns) {
    const int s = threadIdx.x;
    float m = -INFINITY;
    int kb = -1;
    for (int w = 0; w < kWarps; ++w) {
      if (beats(s_mag[w][s], s_k[w][s], m, kb)) {
        m = s_mag[w][s];
        kb = s_k[w][s];
      }
    }
    const size_t o = (size_t)(N - n_first) * S + s0 + s;
    bpm[o] = kb < 0 ? 0.f : __fmul_rn(__fmul_rn((float)kb, step), 60.f);
    valid[o] = (kb >= 0 && N >= 8) ? 1 : 0;
  }
}

template <int ROWS>
cudaError_t launch(const float* x, int S, int pitch, int n_first, int n_last,
                   int k_max, float fps, float low, float high, int tile,
                   float* bpm, uint8_t* valid, cudaStream_t stream) {
  const size_t smem = (size_t)ROWS * pitch * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ramp_dft_kernel<ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(n_last - n_first + 1, (S + tile - 1) / tile);
  ramp_dft_kernel<ROWS><<<grid, kThreads, smem, stream>>>(
      x, S, pitch, n_first, n_last, k_max, fps, low, high, tile, bpm, valid);
  return cudaGetLastError();
}

}  // namespace

// x: (S, pitch) float32, 16-byte aligned, pitch % 4 == 0 and >= n_last;
// bpm (float32) and valid (bool) rows N - n_first of S values.  rows is
// the kernel's instance (1, 2, 4, 8 or 16 streams; ops/ramp_cuda.py owns
// the limit, any other is refused), tile <= rows the streams a block.
extern "C" int vhr_ramp_dft(const float* x, int S, int pitch, int n_first,
                            int n_last, int k_max, float fps, float low,
                            float high, int tile, int rows, float* bpm,
                            uint8_t* valid, cudaStream_t stream) {
  if (S < 1 || n_first < 1 || n_last < n_first || pitch < n_last
      || pitch % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0
      || tile < 1 || tile > rows)
    return (int)cudaErrorInvalidValue;
  switch (rows) {
    case 1: return (int)launch<1>(x, S, pitch, n_first, n_last, k_max, fps,
                                  low, high, tile, bpm, valid, stream);
    case 2: return (int)launch<2>(x, S, pitch, n_first, n_last, k_max, fps,
                                  low, high, tile, bpm, valid, stream);
    case 4: return (int)launch<4>(x, S, pitch, n_first, n_last, k_max, fps,
                                  low, high, tile, bpm, valid, stream);
    case 8: return (int)launch<8>(x, S, pitch, n_first, n_last, k_max, fps,
                                  low, high, tile, bpm, valid, stream);
    case 16: return (int)launch<16>(x, S, pitch, n_first, n_last, k_max, fps,
                                    low, high, tile, bpm, valid, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
