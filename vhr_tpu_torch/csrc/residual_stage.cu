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
// float32 or bfloat16, with float32 results inside.
//
// Bound.  Per pixel and block the two 1x1 convs are 4*C*Cm operations (82%
// of a stage's) and the rest 21*Cm + 4*C; a stage's input and output are
// 2*C*2 bytes a pixel in bfloat16.  With the convs on the tensor cores (495
// TFLOP/s in TF32) and the rest on the CUDA cores (67 TFLOP/s of float32)
// the mesh net's four stages (128x128 C=16 Cm=8, 64x64 32/16, 32x32 64/32,
// 16x16 128/64, N=4) need less time for their operations than for their
// bytes at 3.35 TB/s: the stage is bound by bytes.
//
// Design.  One thread block per (frame, band of output rows).  The block
// loads its band of x plus N halo rows on each side (each 3x3 depthwise conv
// widens the rows it needs by one; rows beyond the frame are not loaded)
// into shared memory as float32 planes xs[c][pixel], applies the entry
// PReLU, and runs the N blocks there.  After block k the rows that are
// current shrink by one on each side that is not the frame's edge, so after
// N blocks exactly the band is right, and only it is written.
//
// The 1x1 convs run on the tensor cores as mma.sync m16n8k8 in TF32 with
// float32 accumulators, three passes a product: every float32 operand v is
// split into big = tf32(v) and small = tf32(v - big), and big*small,
// small*big and big*big go into the same accumulator in that order, which
// keeps about 22 bits of each product.  M is 16 pixels of the band's
// flattened index, N is 8 output channels, K is 8 input channels.  A warp
// works on a tile of 16*MT pixels at a time (MT m-tiles): lane (g = lane/4,
// t = lane%4) owns the 2*MT neighbouring pixels p..p+2*MT-1, p = tile*16*MT
// + g*2*MT; m-tile m's rows g and g+8 are pixels p+2m and p+2m+1.  The
// columns of every B matrix are permuted so that the accumulator's columns
// 2t, 2t+1 are output channels 8n+t, 8n+t+4.  So in every fragment, A, C
// and D alike, a lane holds channels 8j+t and 8j+t+4 of its own pixels: one
// vector load or store of 2*MT floats a channel, free of bank conflicts
// because the planes' stride is 8 modulo 32 words, and the second conv's A
// fragment is made where the first one's accumulators' layout left off.
//
// Per block: the thread block copies w1[k] into shared memory, split into
// big and small and laid out in the order the B fragments are read (one
// 16-byte load a lane and fragment), with dw, the biases and the slopes;
// step A multiplies every tile whose x is current by it and writes h =
// prelu(. + b1, a1) to hs[m][pixel]; w2[k] takes w1's place; step B
// computes d for the lane's own pixels and channels straight into the
// second conv's A fragment (per channel and row one vector load of hs and
// the two pixels beside it; a row or pixel outside the frame contributes
// nothing, which is SAME zero padding), multiplies, and writes prelu(x +
// (. + b2), a2) back into xs in place.  d never goes to memory.  Tiles run
// over whole multiples of 16*MT pixels: a tile that straddles the current
// rows is computed whole and stored only where it is current.  The depthwise
// conv, the biases, the PReLUs and the residual add are float32 on the CUDA
// cores (__fmaf_rn).
//
// The band, the planes' stride and the shared memory come from
// ops/meshblocks_cuda.py::stage_rows, which counts the planes and one
// conv's split weights: bands of 10 rows (18 held) at 128x128 and 64x64, 8
// (16 held) at 32x32, and two bands of 8 (12 held) at 16x16, 218,112 to
// 227,840 bytes a block, so one block an SM.  Its warps are all there is to hide latency
// with: 24 warps of two m-tiles at Cm = 8, 16 at Cm = 16 and 32, 16 warps of
// one m-tile at Cm = 64, where a band has only 12 tiles (KERNEL_TILING in
// the wrapper's module; the shapes compiled are listed at the end of this
// file, each with an 8-warp one to time against).
//
// -DK5_PROBE_ONE_TAP, -DK5_PROBE_ONE_PASS and -DK5_PROBE_CLOCKS build timing
// probes (tools/k5_profile.py --define): the depthwise conv cut to its
// centre tap, the convs cut to one TF32 pass (both give wrong results), and
// one thread block's clocks per phase printed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#ifdef K5_PROBE_CLOCKS
#include <cstdio>
#endif

namespace {

__device__ __forceinline__ float prelu(float v, float a) {
  return v >= 0.f ? v : v * a;
}

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(v));
  return u;
}

// v = big + small, up to about 2^-22 of v.
__device__ __forceinline__ void split(float v, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(v);
  small = tf32(v - __uint_as_float(big));
}

// d += a . b for a (16x8, row-major fragment) and b (8x8, column-major).
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[m][nt] += a[m] . w[nt] for MT m-tiles and NT n-tiles in the three
// passes, small terms first; the B fragments wb[f0 + nt] hold {b0 big, b1
// big, b0 small, b1 small}.  The n-tiles go in groups of four, a pass over
// the whole group at a time, so that successive mma's are independent: the
// three that add into one accumulator are a group apart.  Where the
// accumulators already take 64 registers the group is two m-tiles' worth
// (two n-tiles of one m-tile, one of two), or registers spill.
template <int MT, int NT>
__device__ __forceinline__ void mma_3x(float (&acc)[MT][NT][4],
                                       const uint32_t (&big)[MT][4],
                                       const uint32_t (&small)[MT][4],
                                       const uint4* wb, int f0, int lane) {
  constexpr int G = MT * NT >= 16 ? (MT == 1 ? 2 : 1) : (NT < 4 ? NT : 4);
#pragma unroll
  for (int n0 = 0; n0 < NT; n0 += G) {
    uint4 w[G];
#pragma unroll
    for (int q = 0; q < G; ++q) w[q] = wb[(f0 + n0 + q) * 32 + lane];
#ifndef K5_PROBE_ONE_PASS   // a timing probe, not the function
#pragma unroll
    for (int q = 0; q < G; ++q)
#pragma unroll
      for (int m = 0; m < MT; ++m)
        mma_tf32(acc[m][n0 + q], small[m], w[q].x, w[q].y);
#pragma unroll
    for (int q = 0; q < G; ++q)
#pragma unroll
      for (int m = 0; m < MT; ++m)
        mma_tf32(acc[m][n0 + q], big[m], w[q].z, w[q].w);
#endif
#pragma unroll
    for (int q = 0; q < G; ++q)
#pragma unroll
      for (int m = 0; m < MT; ++m)
        mma_tf32(acc[m][n0 + q], big[m], w[q].x, w[q].y);
  }
}

template <int NP>
__device__ __forceinline__ void load_px(const float* p, float* v) {
  if constexpr (NP == 2) {
    const float2 r = *reinterpret_cast<const float2*>(p);
    v[0] = r.x, v[1] = r.y;
  } else {
    const float4 r = *reinterpret_cast<const float4*>(p);
    v[0] = r.x, v[1] = r.y, v[2] = r.z, v[3] = r.w;
  }
}

template <int NP>
__device__ __forceinline__ void store_px(float* p, const float* v) {
  if constexpr (NP == 2)
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Four neighbouring values at element offset off of a float32 or bfloat16
// array.
__device__ __forceinline__ float4 load4(const void* base, int bf16,
                                        long long off) {
  if (!bf16)
    return __ldg(reinterpret_cast<const float4*>(
        static_cast<const float*>(base) + off));
  const uint2 r = __ldg(reinterpret_cast<const uint2*>(
      static_cast<const __nv_bfloat16*>(base) + off));
  return make_float4(__uint_as_float(r.x << 16),
                     __uint_as_float(r.x & 0xffff0000u),
                     __uint_as_float(r.y << 16),
                     __uint_as_float(r.y & 0xffff0000u));
}

__device__ __forceinline__ void store4(void* base, int bf16, long long off,
                                       float4 v) {
  if (!bf16) {
    *reinterpret_cast<float4*>(static_cast<float*>(base) + off) = v;
    return;
  }
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(base) + off) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                 *reinterpret_cast<const uint32_t*>(&hi));
}

// Copy w (NOUT x KIN, row-major) into shared memory as the B fragments of
// an (pixels x KIN) . (KIN x NOUT) product, split into big and small:
// fragment (k-step ks, n-tile nt) is 32 uint4, lane (g, t) holding w[8nt +
// perm(g)][8ks + t] and w[8nt + perm(g)][8ks + t + 4], perm(2i) = i,
// perm(2i + 1) = i + 4.
template <int NOUT, int KIN, int THREADS>
__device__ __forceinline__ void stage_frags(float* wb,
                                            const float* __restrict__ w,
                                            int tid) {
  constexpr int NT = NOUT / 8;
  for (int i = tid; i < NOUT * KIN / 2; i += THREADS) {
    const int lane = i & 31, f = i >> 5;
    const int nt = f % NT, ks = f / NT;
    const int g = lane >> 2, t = lane & 3;
    const float* src = w + (nt * 8 + (g >> 1) + 4 * (g & 1)) * KIN + ks * 8 + t;
    uint4 o;
    split(__ldg(src), o.x, o.z);
    split(__ldg(src + 4), o.y, o.w);
    reinterpret_cast<uint4*>(wb)[i] = o;
  }
}

// A timing probe: thread 0 of one thread block adds up the clocks of each
// phase (to the barrier that ends it) and prints them.
#ifdef K5_PROBE_CLOCKS
#define K5_TICK(slot)                                       \
  if (tid == 0 && blockIdx.y == 0 && blockIdx.x == gridDim.x / 2) { \
    const long long now = clock64();                        \
    ticks[slot] += now - last;                              \
    last = now;                                             \
  }
#else
#define K5_TICK(slot)
#endif

template <int C, int CM, int MT, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
residual_stage_kernel(const void* __restrict__ x, void* __restrict__ out,
                      int bf16, const float* __restrict__ a0,
                      const float* __restrict__ w1,
                      const float* __restrict__ b1,
                      const float* __restrict__ a1,
                      const float* __restrict__ dw,
                      const float* __restrict__ bdw,
                      const float* __restrict__ w2,
                      const float* __restrict__ b2,
                      const float* __restrict__ a2, int H, int W,
                      int n_blocks, int rows, int stride) {
  constexpr int NP = 2 * MT;    // pixels a lane
  constexpr int TP = 16 * MT;   // pixels a tile
  constexpr int THREADS = WARPS * 32;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                  // [C][stride]
  float* hs = xs + C * stride;       // [CM][stride]
  float* wb = hs + CM * stride;      // one conv's B fragments, 2*C*CM floats
  float* dws = wb + 2 * C * CM;      // [9][CM]
  float* b1s = dws + 9 * CM;
  float* a1s = b1s + CM;
  float* bdws = a1s + CM;
  float* b2s = bdws + CM;
  float* a2s = b2s + C;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * rows;
  const int r1 = min(H, r0 + rows);
  const int lo = max(0, r0 - n_blocks);  // rows held: [lo, hi)
  const int hi = min(H, r1 + n_blocks);
  const long long S = (long long)H * W;
  const long long frame = (long long)blockIdx.y * C * S;
#ifdef K5_PROBE_CLOCKS
  long long ticks[6] = {}, last = clock64();
#endif

  {
    const int nq = (hi - lo) * W / 4;
    const long long base = frame + (long long)lo * W;
    for (int i = tid; i < C * nq; i += THREADS) {
      const int c = i / nq, p = (i - c * nq) * 4;
      float4 v = load4(x, bf16, base + c * S + p);
      const float a = __ldg(a0 + c);
      v.x = prelu(v.x, a), v.y = prelu(v.y, a);
      v.z = prelu(v.z, a), v.w = prelu(v.w, a);
      *reinterpret_cast<float4*>(xs + c * stride + p) = v;
    }
  }

  K5_TICK(0)
  int vlo = lo, vhi = hi;  // rows whose x is current
  for (int k = 0; k < n_blocks; ++k) {
    // dw, b1, a1, bdw, b2, a2 of block k lie in that order from dws on.
    // Their loads are in flight while w1 is staged.
    constexpr int NS = 12 * CM + 2 * C;
    float sv[(NS + THREADS - 1) / THREADS];
#pragma unroll
    for (int u = 0; u * THREADS < NS; ++u) {
      const int i = tid + u * THREADS;
      const float* src =
          i < 9 * CM    ? dw + k * 9 * CM + i
          : i < 10 * CM ? b1 + k * CM + (i - 9 * CM)
          : i < 11 * CM ? a1 + k * CM + (i - 10 * CM)
          : i < 12 * CM ? bdw + k * CM + (i - 11 * CM)
          : i < 12 * CM + C ? b2 + k * C + (i - 12 * CM)
                            : a2 + k * C + (i - 12 * CM - C);
      sv[u] = i < NS ? __ldg(src) : 0.f;
    }
    stage_frags<CM, C, THREADS>(wb, w1 + (long long)k * CM * C, tid);
#pragma unroll
    for (int u = 0; u * THREADS < NS; ++u)
      if (tid + u * THREADS < NS) dws[tid + u * THREADS] = sv[u];
    __syncthreads();
    K5_TICK(1)

    // Step A: h = prelu(x . w1 + b1, a1) on every tile that holds a
    // current row.
    const int tA1 = ((vhi - lo) * W + TP - 1) / TP;
    for (int tile = (vlo - lo) * W / TP + warp; tile < tA1; tile += WARPS) {
      const int p = tile * TP + g * NP;
      float acc[MT][CM / 8][4] = {};
#pragma unroll 2
      for (int ks = 0; ks < C / 8; ++ks) {
        float v0[NP], v1[NP];
        load_px<NP>(xs + (ks * 8 + t) * stride + p, v0);
        load_px<NP>(xs + (ks * 8 + t + 4) * stride + p, v1);
        uint32_t big[MT][4], small[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          split(v0[2 * m], big[m][0], small[m][0]);
          split(v0[2 * m + 1], big[m][1], small[m][1]);
          split(v1[2 * m], big[m][2], small[m][2]);
          split(v1[2 * m + 1], big[m][3], small[m][3]);
        }
        mma_3x<MT, CM / 8>(acc, big, small,
                           reinterpret_cast<const uint4*>(wb),
                           ks * (CM / 8), lane);
      }
#pragma unroll
      for (int nt = 0; nt < CM / 8; ++nt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int ch = nt * 8 + t + 4 * half;
          const float bias = b1s[ch], slope = a1s[ch];
          float o[NP];
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            o[2 * m] = prelu(acc[m][nt][half] + bias, slope);
            o[2 * m + 1] = prelu(acc[m][nt][2 + half] + bias, slope);
          }
          store_px<NP>(hs + ch * stride + p, o);
        }
      }
    }
    __syncthreads();
    K5_TICK(2)
    stage_frags<C, CM, THREADS>(wb, w2 + (long long)k * C * CM, tid);
    __syncthreads();
    K5_TICK(3)

    // Step B on the rows that stay right: the depthwise 3x3 conv of h into
    // the A fragments, the second 1x1 conv, the residual add and the PReLU
    // in place.
    const int nlo = vlo > 0 ? vlo + 1 : vlo;
    const int nhi = vhi < H ? vhi - 1 : vhi;
    const int qlo = (nlo - lo) * W, qhi = (nhi - lo) * W;
    const int tB1 = (qhi + TP - 1) / TP;
    for (int tile = qlo / TP + warp; tile < tB1; tile += WARPS) {
      const int p = tile * TP + g * NP;
      // NP divides W, so a lane's pixels lie in one row.
      const bool valid = p >= qlo && p < qhi;
      const int row = p / W, xx = p - row * W;
      const bool left = xx > 0, right = xx + NP < W;
      const bool rowok[3] = {valid && lo + row > 0, valid,
                             valid && lo + row < H - 1};
      float acc[MT][C / 8][4] = {};
#pragma unroll 1
      for (int j = 0; j < CM / 8; ++j) {
        float d[2][NP];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int ch = j * 8 + t + 4 * half;
          const float bias = bdws[ch];
#pragma unroll
          for (int i = 0; i < NP; ++i) d[half][i] = bias;
#ifdef K5_PROBE_ONE_TAP   // a timing probe, not the function: centre tap only
#pragma unroll
          for (int r = 1; r < 2; ++r) {
#else
#pragma unroll
          for (int r = 0; r < 3; ++r) {
#endif
            const float* hp = hs + ch * stride + p + (r - 1) * W;
            float v[NP + 2];   // the pixel to the left, the lane's, to the right
#pragma unroll
            for (int i = 0; i < NP + 2; ++i) v[i] = 0.f;
            if (rowok[r]) {
              load_px<NP>(hp, v + 1);
#ifndef K5_PROBE_ONE_TAP
              if (left) v[0] = hp[-1];
              if (right) v[NP + 1] = hp[NP];
#endif
            }
            const float wl = dws[(r * 3 + 0) * CM + ch];
            const float wc = dws[(r * 3 + 1) * CM + ch];
            const float wr = dws[(r * 3 + 2) * CM + ch];
#pragma unroll
            for (int i = 0; i < NP; ++i) {
              d[half][i] = __fmaf_rn(wl, v[i], d[half][i]);
              d[half][i] = __fmaf_rn(wc, v[i + 1], d[half][i]);
              d[half][i] = __fmaf_rn(wr, v[i + 2], d[half][i]);
            }
          }
        }
        uint32_t big[MT][4], small[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          split(d[0][2 * m], big[m][0], small[m][0]);
          split(d[0][2 * m + 1], big[m][1], small[m][1]);
          split(d[1][2 * m], big[m][2], small[m][2]);
          split(d[1][2 * m + 1], big[m][3], small[m][3]);
        }
        mma_3x<MT, C / 8>(acc, big, small,
                          reinterpret_cast<const uint4*>(wb), j * (C / 8),
                          lane);
      }
      if (valid) {
#pragma unroll
        for (int nt = 0; nt < C / 8; ++nt) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int ch = nt * 8 + t + 4 * half;
            const float bias = b2s[ch], slope = a2s[ch];
            float* xp = xs + ch * stride + p;
            float o[NP];
            load_px<NP>(xp, o);
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              o[2 * m] = prelu(o[2 * m] + (acc[m][nt][half] + bias), slope);
              o[2 * m + 1] =
                  prelu(o[2 * m + 1] + (acc[m][nt][2 + half] + bias), slope);
            }
            store_px<NP>(xp, o);
          }
        }
      }
    }
    __syncthreads();
    K5_TICK(4)
    vlo = nlo;
    vhi = nhi;
  }

  if (n_blocks == 0) __syncthreads();
  const int nq = (r1 - r0) * W / 4;
  const int off = (r0 - lo) * W;
  const long long base = frame + (long long)r0 * W;
  for (int i = tid; i < C * nq; i += THREADS) {
    const int c = i / nq, p = (i - c * nq) * 4;
    store4(out, bf16, base + c * S + p,
           *reinterpret_cast<const float4*>(xs + c * stride + off + p));
  }
#ifdef K5_PROBE_CLOCKS
  K5_TICK(5)
  if (tid == 0 && blockIdx.y == 0 && blockIdx.x == gridDim.x / 2)
    printf("K5 clocks C=%d bf16=%d: load %lld, stage w1 %lld, step A %lld, "
           "stage w2 %lld, step B %lld, store %lld\n", C, bf16, ticks[0],
           ticks[1], ticks[2], ticks[3], ticks[4], ticks[5]);
#endif
}

template <int C, int CM, int MT, int WARPS>
int launch(const void* x, void* out, int bf16, const float* const* w, int B,
           int H, int W, int n_blocks, int rows, int stride, int smem,
           cudaStream_t stream) {
  auto kernel = residual_stage_kernel<C, CM, MT, WARPS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H + rows - 1) / rows, B);
  kernel<<<grid, WARPS * 32, smem, stream>>>(
      x, out, bf16, w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7], w[8], H,
      W, n_blocks, rows, stride);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (B, C, H*W) float32 (bf16 == 0) or bfloat16 (bf16 == 1), 16-byte
// aligned; the nine weights as StageWeights orders them, contiguous
// float32.  C == 2 * Cm, Cm in {8, 16, 32, 64}; W % 4 == 0; rows, stride
// (of a shared-memory plane, in floats) and smem from stage_rows at a tile
// of 16 * mt pixels; (mt, warps) one of the shapes compiled below.
extern "C" int vhr_residual_stage(const void* x, void* out, int bf16,
                                  const float* a0, const float* w1,
                                  const float* b1, const float* a1,
                                  const float* dw, const float* bdw,
                                  const float* w2, const float* b2,
                                  const float* a2, int B, int C, int Cm,
                                  int H, int W, int n_blocks, int rows,
                                  int stride, int smem, int mt, int warps,
                                  cudaStream_t stream) {
  if (B <= 0 || C != 2 * Cm || H <= 0 || W <= 0 || W % 4 != 0 || rows <= 0 ||
      n_blocks < 0 || stride % 32 != 8)
    return (int)cudaErrorInvalidValue;
  const float* w[9] = {a0, w1, b1, a1, dw, bdw, w2, b2, a2};
#define K5_SHAPE(CM_, MT_, WARPS_)                                          \
  if (Cm == CM_ && mt == MT_ && warps == WARPS_)                            \
    return launch<2 * CM_, CM_, MT_, WARPS_>(x, out, bf16, w, B, H, W,      \
                                             n_blocks, rows, stride, smem,  \
                                             stream);
  K5_SHAPE(8, 2, 24)
  K5_SHAPE(8, 2, 8)
  K5_SHAPE(16, 2, 16)
  K5_SHAPE(16, 2, 8)
  K5_SHAPE(32, 2, 16)
  K5_SHAPE(32, 2, 8)
  K5_SHAPE(64, 1, 16)
  K5_SHAPE(64, 1, 8)
#undef K5_SHAPE
  return (int)cudaErrorInvalidValue;
}
