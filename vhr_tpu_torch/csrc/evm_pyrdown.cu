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
// few integer operations per input byte.  At 3.35 TB/s the card needs some
// 2-3 MB of reads in flight, so the design keeps many bytes in flight with
// few instructions, and keeps the blocks that run together on neighbouring
// bytes:
//
// - Strips and segments.  A block owns a strip of 128 output columns (256
//   input pixels, 780 bytes of a row with the 2-pixel halo on each side)
//   and a segment of output rows of one frame, and walks down it 8 output
//   rows (16 input rows) a step, one output row a warp.  A block reads each
//   of its input rows once.  The segment is short (ops/evm_cuda.py's
//   KERNEL_SHAPE: 2 steps, 16 output rows): the blocks resident at once
//   then cover about two whole frames, so the 3 rows two segments share
//   and the 12 bytes two strips share come from L2, and device memory is
//   read in order.  At 1080p x 64 shorter segments were faster down to
//   2 steps (tools/k6_profile.py --max-steps N).
// - A ring of input rows in shared memory (kRing rows of kRowBytes),
//   filled kDepth - 1 groups ahead by 16-byte cp.async.cg copies with a
//   256-byte L2 prefetch (4-byte cp.async.ca where the row pitch or the
//   base is not 16-byte aligned, plain byte loads where it is not 4-byte
//   aligned): the next rows' copies fly while the warps compute on the
//   current ones, with one barrier a step.  Rows are clamped when their
//   ring slot is filled; the two pixels left of column 0 and right of
//   column W-1 are patched in shared memory by the thread that copied the
//   row's first or last chunk, after its own copies landed.
// - Integer blur on packed words.  A lane reads its 40-byte window of each
//   of 5 rows as 64-bit words and runs the vertical taps on two 16-bit
//   lanes a word (even and odd bytes; sums <= 16 * 255); the horizontal
//   taps add those sums (<= 65280).  The blur is integer and exact, and
//   dividing by 256 is exact in float32, so it equals the float32 matrix
//   products of the Pallas kernel bit for bit.  Only the YIQ combine rounds;
//   it is written in the Pallas kernel's order, and the build's
//   --fmad=false keeps every product rounded on its own, as the plain
//   PyTorch version rounds it.
// - A lane computes 4 neighbouring output pixels and writes each plane's 4
//   floats as one streaming 16-byte store (st.global.cs: the output is
//   read back by the next pass, not from L2), where w_out % 4 == 0.
//
// Probe builds (not right; for timing what holds the kernel back):
// -DK6_PROBE_LOAD_ONLY skips the blur and the stores, -DK6_PROBE_NO_STORE
// computes but stores nothing, -DK6_PROBE_NO_LOAD copies nothing into the
// ring.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStripCols = 128;           // output columns a strip, 4 a lane
constexpr int kWarps = 8;                 // output rows a step, one a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kDepth = 2;                 // load groups in the ring
constexpr int kGroupRows = 2 * kWarps;    // input rows a step adds
constexpr int kRing = kGroupRows * kDepth + 3;
constexpr int kRowBytes = 800;            // staged bytes of a row (16 x 50)
constexpr int kWinBytes = 3 * (2 * kStripCols + 4);   // 780 needed

// Ring row layout: shared byte o of a slot holds the row's byte
// g0 + o, g0 = 3 * x0 - 6 - Ph(V) (x0 = the strip's first input pixel), so
// that a lane's window starts on an 8-byte boundary 2 bytes before its
// first needed byte, and 16-byte chunks of the row land 16-byte aligned.
template <int V> struct Copy {
  static constexpr int kPh = V == 16 ? 10 : 2;
  static constexpr int kSpan = V == 16 ? 800 : (V == 4 ? 784 : kWinBytes);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int V>
__device__ __forceinline__ void cp_async(uint8_t* dst, const uint8_t* src) {
  if constexpr (V == 16) {
    asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16;\n"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows [lo, hi) of the segment's virtual row numbers v: group 0 is rows
// [0, kGroupRows + 3) (the 2 halo rows above the segment included), group
// g >= 1 is [kGroupRows * g + 3, kGroupRows * (g + 1) + 3); step s reads
// rows [kGroupRows * s, kGroupRows * s + kGroupRows + 2], all in groups
// <= s.  Rows past v_end (the last one the segment needs) are not loaded.
__device__ __forceinline__ int group_lo(int g) {
  return g == 0 ? 0 : kGroupRows * g + 3;
}

struct Strip {
  const uint8_t* frame;   // the frame's first byte
  int H, W, row_bytes;    // row_bytes = 3 * W
  int r0;                 // input row of v = 0 (2 * j0 - 2)
  int x0;                 // first input pixel of the strip
  int v_end;              // rows v < v_end are loaded
};

__device__ __forceinline__ const uint8_t* src_row(const Strip& st, int v) {
  const int r = min(max(st.r0 + v, 0), st.H - 1);
  return st.frame + (long long)r * st.row_bytes;
}

// Start the copies of group g into the ring.  With V >= 4 the chunks that
// hold a row's first or last byte are copied by thread (v - lo), which
// patches the halo beside them in patch_group once they have landed.
template <int V>
__device__ __forceinline__ void load_group(uint8_t* ring, const Strip& st,
                                           int g) {
#ifndef K6_PROBE_NO_LOAD
  const int lo = group_lo(g);
  const int hi = min(group_lo(g + 1), st.v_end);
  if (hi <= lo) return;
  const int tid = threadIdx.x;
  const int g0 = 3 * st.x0 - 6 - Copy<V>::kPh;
  if constexpr (V == 1) {
    constexpr int n = Copy<V>::kSpan;
    for (int k = tid; k < (hi - lo) * n; k += kThreads) {
      const int ir = k / n, b = k - ir * n;
      const int px = b / 3, c = b - 3 * px;
      const int gx = min(max(st.x0 - 2 + px, 0), st.W - 1);
      ring[((lo + ir) % kRing) * kRowBytes + Copy<V>::kPh + b] =
          __ldg(src_row(st, lo + ir) + 3 * gx + c);
    }
  } else {
    constexpr int n = Copy<V>::kSpan / V;
    for (int k = tid; k < (hi - lo) * n; k += kThreads) {
      const int ir = k / n, o = (k - ir * n) * V;
      const int g = g0 + o;
      if (g <= 0 || g + V >= st.row_bytes) continue;    // edges: below
      cp_async<V>(ring + ((lo + ir) % kRing) * kRowBytes + o,
                  src_row(st, lo + ir) + g);
    }
    if (tid < hi - lo) {
      uint8_t* slot = ring + ((lo + tid) % kRing) * kRowBytes;
      const uint8_t* row = src_row(st, lo + tid);
      if (g0 < 0) cp_async<V>(slot - g0, row);
      const int o_end = st.row_bytes - V - g0;
      if (o_end >= 0 && o_end + V <= Copy<V>::kSpan)
        cp_async<V>(slot + o_end, row + st.row_bytes - V);
    }
  }
#endif
}

// Edge replicate for the rows of group g: the 2 pixels left of column 0
// and right of column W-1, by the thread that copied the edge chunks.
template <int V>
__device__ __forceinline__ void patch_group(uint8_t* ring, const Strip& st,
                                            int g) {
#ifndef K6_PROBE_NO_LOAD
  if constexpr (V != 1) {
    const int lo = group_lo(g);
    const int hi = min(group_lo(g + 1), st.v_end);
    const int tid = threadIdx.x;
    if (tid >= hi - lo) return;
    uint8_t* slot = ring + ((lo + tid) % kRing) * kRowBytes;
    const int g0 = 3 * st.x0 - 6 - Copy<V>::kPh;
    if (g0 < 0) {
      uint8_t* p = slot - g0;                     // pixel 0
      const uint8_t b = p[0], gr = p[1], r = p[2];
      p[-6] = b; p[-5] = gr; p[-4] = r;
      p[-3] = b; p[-2] = gr; p[-1] = r;
    }
    const int o_end = st.row_bytes - g0;          // pixel W
    if (o_end - V >= 0 && o_end <= Copy<V>::kSpan) {
      uint8_t* p = slot + o_end;
      const uint8_t b = p[-3], gr = p[-2], r = p[-1];
#pragma unroll
      for (int k = 0; k < 6; k += 3) {
        if (o_end + k + 2 < kRowBytes) {
          p[k] = b; p[k + 1] = gr; p[k + 2] = r;
        }
      }
    }
  }
#endif
}

// One output row of the strip for one lane: 4 pixels at output columns
// col .. col + 3, from ring rows v0 .. v0 + 4.
template <int V, bool kVec>
__device__ __forceinline__ void compute_row(const uint8_t* ring, int v0,
                                            int lane, float* dst,
                                            long long plane, int col,
                                            int w_out) {
  // Vertical taps: the lane's 10 words of each row (bytes 2..37 of them
  // are its 12 pixels), even and odd bytes as two 16-bit lanes a word.
  uint32_t E[10], O[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) E[k] = O[k] = 0u;
  const int o_w = 24 * lane + Copy<V>::kPh - 2;
#pragma unroll
  for (int a = 0; a < 5; ++a) {
    const uint2* p = reinterpret_cast<const uint2*>(
        ring + ((v0 + a) % kRing) * kRowBytes + o_w);
    const uint32_t wt = (a == 0 || a == 4) ? 1u : (a == 2 ? 6u : 4u);
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const uint2 q = p[k];
      E[2 * k] += wt * __byte_perm(q.x, 0u, 0x4240);
      O[2 * k] += wt * __byte_perm(q.x, 0u, 0x4341);
      E[2 * k + 1] += wt * __byte_perm(q.y, 0u, 0x4240);
      O[2 * k + 1] += wt * __byte_perm(q.y, 0u, 0x4341);
    }
  }
  // Window byte b's vertical sum.
  auto vs = [&](int b) -> int {
    const uint32_t w = (b & 1) ? O[b >> 2] : E[b >> 2];
    return (int)((b & 2) ? (w >> 16) : (w & 0xFFFFu));
  };
  const float scale = (float)(1.0 / 255.0);
  float y[4], iq1[4], iq2[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float bgr[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const int b = 2 + 6 * q + ch;       // pixel 2q, the first tap
      const int s = vs(b) + 4 * vs(b + 3) + 6 * vs(b + 6) + 4 * vs(b + 9)
                    + vs(b + 12);
      bgr[ch] = (float)s * (1.0f / 256.0f);
    }
    const float bl = bgr[0], g = bgr[1], r = bgr[2];
    const float yy = (float)0.30 * r + (float)0.59 * g + (float)0.11 * bl;
    y[q] = yy * scale;
    iq1[q] = ((float)0.74 * (r - yy) - (float)0.27 * (bl - yy)) * scale;
    iq2[q] = ((float)0.48 * (r - yy) + (float)0.41 * (bl - yy)) * scale;
  }
#ifdef K6_PROBE_NO_STORE
  if (y[0] != -1.0f) return;              // never true: keeps the math
#endif
  if (col >= w_out) return;
  if constexpr (kVec) {
    __stcs(reinterpret_cast<float4*>(dst + col),
           make_float4(y[0], y[1], y[2], y[3]));
    __stcs(reinterpret_cast<float4*>(dst + plane + col),
           make_float4(iq1[0], iq1[1], iq1[2], iq1[3]));
    __stcs(reinterpret_cast<float4*>(dst + 2 * plane + col),
           make_float4(iq2[0], iq2[1], iq2[2], iq2[3]));
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (col + q < w_out) {
        __stcs(dst + col + q, y[q]);
        __stcs(dst + plane + col + q, iq1[q]);
        __stcs(dst + 2 * plane + col + q, iq2[q]);
      }
    }
  }
}

template <int V, bool kVec>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
yiq_pyrdown_kernel(const uint8_t* __restrict__ frames,
                   float* __restrict__ out, int H, int W, int h_out,
                   int w_out, int strips, int segments, int seg_steps) {
  __shared__ __align__(16) uint8_t ring[kRing * kRowBytes];

  const int strip = blockIdx.x % strips;
  const int rest = blockIdx.x / strips;
  const int seg = rest % segments;
  const long long t = rest / segments;
  const int j0 = seg * seg_steps * kWarps;
  if (j0 >= h_out) return;
  const int j_end = min(j0 + seg_steps * kWarps, h_out);
  const int steps = (j_end - j0 + kWarps - 1) / kWarps;

  Strip st;
  st.frame = frames + t * (long long)H * W * 3;
  st.H = H;
  st.W = W;
  st.row_bytes = 3 * W;
  st.r0 = 2 * j0 - 2;
  st.x0 = strip * 2 * kStripCols;
  st.v_end = 2 * (j_end - 1 - j0) + 5;

  const long long plane = (long long)h_out * w_out;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = strip * kStripCols + 4 * lane;
  float* dst_t = out + t * 3 * plane;

#pragma unroll
  for (int g = 0; g < kDepth - 1; ++g) {
    load_group<V>(ring, st, g);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kDepth - 2>();
    patch_group<V>(ring, st, s);
    __syncthreads();
    if (s + kDepth - 1 < steps) load_group<V>(ring, st, s + kDepth - 1);
    cp_async_commit();
#ifndef K6_PROBE_LOAD_ONLY
    const int j = j0 + s * kWarps + warp;
    if (j < j_end) {
      compute_row<V, kVec>(ring, 2 * (j - j0), lane,
                           dst_t + (long long)j * w_out, plane, col, w_out);
    }
#endif
  }
  cp_async_wait<0>();
}

template <int V, bool kVec>
cudaError_t launch(const uint8_t* frames, float* out, int H, int W,
                   unsigned blocks, int strips, int segments, int seg_steps,
                   cudaStream_t stream) {
  yiq_pyrdown_kernel<V, kVec><<<blocks, kThreads, 0, stream>>>(
      frames, out, H, W, H / 2, W / 2, strips, segments, seg_steps);
  return cudaGetLastError();
}

}  // namespace

// The launch shape comes from ops/evm_cuda.py::k6_geometry; the kernel's
// compiled constants must match it (strip_cols, warps, ring_rows), and the
// copy width must suit the pointer and the row pitch.
extern "C" int vhr_yiq_pyrdown(const uint8_t* frames, float* out, int T,
                               int H, int W, int copy_bytes, int strip_cols,
                               int warps, int ring_rows, int strips,
                               int segments, int seg_steps,
                               cudaStream_t stream) {
  const int steps = (H / 2 + kWarps - 1) / kWarps;
  if (H < 2 || W < 2 || T < 0 || strip_cols != kStripCols
      || warps != kWarps || ring_rows != kRing || seg_steps < 1
      || strips != (W / 2 + kStripCols - 1) / kStripCols
      || segments != (steps + seg_steps - 1) / seg_steps)
    return (int)cudaErrorInvalidValue;
  const uintptr_t base = reinterpret_cast<uintptr_t>(frames);
  if ((copy_bytes != 1 && copy_bytes != 4 && copy_bytes != 16)
      || base % copy_bytes != 0 || (3LL * W) % copy_bytes != 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)T * segments * strips;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return (int)cudaGetLastError();
  const bool vec = (W / 2) % 4 == 0
                   && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const unsigned nb = (unsigned)blocks;
  cudaError_t err;
  if (copy_bytes == 16)
    err = vec ? launch<16, true>(frames, out, H, W, nb, strips, segments,
                                 seg_steps, stream)
              : launch<16, false>(frames, out, H, W, nb, strips, segments,
                                  seg_steps, stream);
  else if (copy_bytes == 4)
    err = vec ? launch<4, true>(frames, out, H, W, nb, strips, segments,
                                seg_steps, stream)
              : launch<4, false>(frames, out, H, W, nb, strips, segments,
                                 seg_steps, stream);
  else
    err = vec ? launch<1, true>(frames, out, H, W, nb, strips, segments,
                                seg_steps, stream)
              : launch<1, false>(frames, out, H, W, nb, strips, segments,
                                 seg_steps, stream);
  return (int)err;
}
