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
// --fmad=false keeps every other product rounded on its own, as the plain
// PyTorch version rounds it.  Pixels are addressed by element strides
// (t, c, h, w): the EVM path reads and writes interleaved (T, H, W, 3)
// frames with no transposes, the Pallas contract planar (T, 3, H, W) ones.
//
// Bound: device-memory bytes on paper (a 1080p frame is 6.2 MB of u8 in
// and 6.2 MB out; the band, 98 KB a frame at 4 levels, comes from L2), but
// on the H100 the instruction rate: a pixel takes 49 float32 operations that
// no rounding lets merge and some 60 instructions in all, which alone take
// ~0.35 ms at 1080p x 64 against the bytes' 0.24 ms (tools/k7_profile.py,
// K7_PROBE_MATH_ONLY).  So the design spends few instructions on anything
// but that arithmetic, and overlaps the copies with it.  Two instances,
// chosen on the host (ops/evm_recon_cuda.py::k7_instance):
//
// Vectorised (interleaved frames, base and row and frame pitches 16-byte
// aligned, W % 16 == 0: every frame of the EVM kernel route):
// - A block owns a strip of 128 columns (8 groups of 16 pixels, 384 bytes a
//   row) and a segment of seg_rows rows of one frame (the host's choice, a
//   multiple of 32), which it walks in passes of 32 rows.  Blocks run
//   strip-fastest, so those resident at once sit on a few frames.
// - Rows arrive by 16-byte cp.async.cg copies, in order and coalesced, into
//   a ring of kRing pass tiles in shared memory (row pitch kPitch = 400
//   bytes: 128-bit reads of 8 neighbouring rows fall on disjoint 4-bank
//   groups), kRing - 1 passes ahead, so the copies fly while the warps
//   compute.  (Without the ring the blocks resident on an SM load, compute
//   and store in step, and the memory idles while they compute.)
// - While the first copies fly, the block stages the horizontal taps of
//   its columns (8 bytes a column of byte offsets of lo and hi into the
//   staged band, 8 of the two weights) and the band's vertically
//   interpolated rows (the generic instance's vrow, the same expression)
//   for its segment and the band columns its strip reads, laid out [band
//   column][row][channel]: a tap's three channels lie at fixed offsets
//   from one address, and 32 neighbouring rows on 32 distinct banks.
// - Warp w takes group w, lane l row l of the pass: a lane reads its 48
//   bytes as three 16-byte shared loads; the taps are the same for every
//   lane (broadcasts, 4 loads a quad of pixels).  Shared memory is
//   addressed in 32 bits with immediate offsets (inline PTX), so a band
//   value costs no address arithmetic beyond one add a tap.  u8 -> float
//   by byte_perm into 0x4B0000nn and one exact fma (unorm); float -> u8 by
//   adding 2^23 rounded toward zero, which truncates as the int conversion
//   does, then an integer min with 0x4B0000FF and byte_perm packing.
//   Where a quad's four pixels share their band columns (every quad of the
//   EVM path), the band's six values are loaded once for the four.  The
//   results overwrite the lane's own bytes of the tile.
// - After a barrier the pass's rows leave as coalesced 16-byte streaming
//   stores (st.global.cs.v4).
//
// Generic (any strides, base and width: planar frames, W = 1000, odd
// sizes, misaligned views): one block per (frame, tile of up to 8 rows),
// the tile's vertically interpolated band rows in shared memory, a thread
// per pixel with byte loads and stores at the given strides.
//
// Both instances compute every value with the same expressions in the same
// order, so they agree bit for bit.
//
// Probe builds (not right; for timing what holds the kernel back):
// -DK7_PROBE_LOAD_ONLY copies the rows in and stores nothing,
// -DK7_PROBE_STORE_ONLY stores the tile without loading or computing,
// -DK7_PROBE_NO_MATH loads and stores the tile without computing,
// -DK7_PROBE_MATH_ONLY computes on the tile without loading or storing it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 8;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;

// The vectorised instance's shape (ops/evm_recon_cuda.py::KERNEL_SHAPE).
constexpr int kStripCols = 128;
constexpr int kGroups = kStripCols / 16;        // one warp a group
constexpr int kPassRows = 32;                   // one lane a row
constexpr int kRing = 2;                        // pass tiles in the ring
constexpr int kPitch = 3 * kStripCols + 16;     // tile row, bytes
static_assert(kGroups * 32 == kThreads, "a warp a group");

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

// ---------------------------------------------------------------------
// The vectorised instance.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void st_cs16(void* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n"
               :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// Blocks an SM the vectorised kernel is compiled for: 3 allows 80
// registers a thread.  At 4 (64 registers) it spilled 12 bytes and was
// 1-3 % slower on the H100; a ring of 3 tiles was no faster than 2.
constexpr int kMinBlocks = 3;

// Shared-memory accesses at 32-bit addresses with immediate offsets, so
// that a load costs no address arithmetic beyond one add a tap.
template <int kOff>
__device__ __forceinline__ float lds_f32(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1+%2];\n"
               : "=f"(v) : "r"(a), "n"(kOff) : "memory");
  return v;
}

template <int kOff>
__device__ __forceinline__ uint4 lds_v4(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4+%5];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a), "n"(kOff) : "memory");
  return v;
}

template <int kOff>
__device__ __forceinline__ void sts_v4(uint32_t a, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0+%1], {%2, %3, %4, %5};\n"
               :: "r"(a), "n"(kOff), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

template <int kOff>
__device__ __forceinline__ uint2 lds_v2(uint32_t a) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2+%3];\n"
               : "=r"(v.x), "=r"(v.y) : "r"(a), "n"(kOff) : "memory");
  return v;
}

// Byte k (0..3) of w times f32(1/255), rounded once as (float)byte * scale
// rounds it: byte_perm makes the float 2^23 + byte, and fma(2^23 + byte,
// scale, -2^23 * scale) holds byte * scale exactly before its one rounding
// (2^23 * scale is exact).
__device__ __forceinline__ float unorm(uint32_t w, int k) {
  constexpr float scale = (float)(1.0 / 255.0);
  return __fmaf_rn(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650u | k)),
                   scale, -8388608.0f * scale);
}

// to_u8 of the generic instance as 0x4B0000nn: clip(v * 255 + 0.5, 0, 255)
// truncated.  Adding 2^23 rounded toward zero keeps floor(x) in the low
// bits for 0 <= x < 2^23, and inf maps above 0x4B0000FF.
__device__ __forceinline__ uint32_t to_u8_bits(float v) {
  const float x = fmaxf(v * 255.0f + 0.5f, 0.0f);
  return min(__float_as_uint(__fadd_rz(x, 8388608.0f)), 0x4B0000FFu);
}

// Bytes 0-3 of a word from the low bytes of four 0x4B0000nn values.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040u), __byte_perm(c, d, 0x0040u),
                     0x5410u);
}

// The float32 arithmetic of one pixel: its bytes' unit values b, g, r_
// from w, the tap's weights wl and wh, and the band's six values at the
// tap's lo and hi columns.  Writes the pixel's three 0x4B0000nn values.
template <int Q, int J>
__device__ __forceinline__ void recon_math(const uint32_t (&w)[12], float wl,
                                           float wh, const float (&lo)[3],
                                           const float (&hi)[3],
                                           uint32_t* o) {
  constexpr int k = 12 * Q + 3 * J;        // the pixel's first byte
  const float b = unorm(w[k / 4], k % 4);
  const float g = unorm(w[(k + 1) / 4], (k + 1) % 4);
  const float r_ = unorm(w[(k + 2) / 4], (k + 2) % 4);
  float y = (float)0.30 * r_ + (float)0.59 * g + (float)0.11 * b;
  float iq1 = (float)0.74 * (r_ - y) - (float)0.27 * (b - y);
  float iq2 = (float)0.48 * (r_ - y) + (float)0.41 * (b - y);
  y = y + __fmaf_rn(hi[0], wh, lo[0] * wl);
  iq1 = iq1 + __fmaf_rn(hi[1], wh, lo[1] * wl);
  iq2 = iq2 + __fmaf_rn(hi[2], wh, lo[2] * wl);
  const float r2 = y + (float)0.9468822170900693 * iq1
                   + (float)0.6235565819861433 * iq2;
  const float g2 = y - (float)0.27478764629897834 * iq1
                   - (float)0.6356910791873801 * iq2;
  const float b2 = y - (float)1.1085450346420322 * iq1
                   + (float)1.7090069284064666 * iq2;
  o[3 * J] = to_u8_bits(b2);
  o[3 * J + 1] = to_u8_bits(g2);
  o[3 * J + 2] = to_u8_bits(r2);
}

// The band's Y, I, Q values of this row at a tap column's byte offset.
__device__ __forceinline__ void band_at(uint32_t a, float (&v)[3]) {
  v[0] = lds_f32<0>(a);
  v[1] = lds_f32<4>(a);
  v[2] = lds_f32<8>(a);
}

// Pixel J of quad Q with its own band values at byte offsets off.
template <int Q, int J>
__device__ __forceinline__ void recon_pixel(const uint32_t (&w)[12], float wl,
                                            float wh, uint2 off, uint32_t row,
                                            uint32_t* o) {
  float lo[3], hi[3];
  band_at(row + off.x, lo);
  band_at(row + off.y, hi);
  recon_math<Q, J>(w, wl, wh, lo, hi, o);
}

// Quad Q (4 pixels, words 3Q .. 3Q + 2) of a group, in place.  offs and
// wts are the shared addresses of the group's first column's band offsets
// (lo, hi) and weights (wl, wh), 8 bytes a column each; row that of this
// row's band values at band column 0.  lo and hi never decrease along a
// row, so where the quad's first and last pixels share them, all four do,
// and the band values are loaded once (the same branch for every lane of
// the warp: its lanes share their columns).  On the EVM path, whose band
// is 1/16 of the frame's width, every quad takes that branch.
template <int Q>
__device__ __forceinline__ void recon_quad(uint32_t (&w)[12], uint32_t offs,
                                           uint32_t wts, uint32_t row) {
  uint32_t o[12];
  const uint2 f0 = lds_v2<8 * (4 * Q)>(offs);
  const uint2 f3 = lds_v2<8 * (4 * Q + 3)>(offs);
  const uint4 w01 = lds_v4<8 * (4 * Q)>(wts);
  const uint4 w23 = lds_v4<8 * (4 * Q + 2)>(wts);
  const float wl0 = __uint_as_float(w01.x), wh0 = __uint_as_float(w01.y);
  const float wl1 = __uint_as_float(w01.z), wh1 = __uint_as_float(w01.w);
  const float wl2 = __uint_as_float(w23.x), wh2 = __uint_as_float(w23.y);
  const float wl3 = __uint_as_float(w23.z), wh3 = __uint_as_float(w23.w);
  if (f0.x == f3.x && f0.y == f3.y) {
    float lo[3], hi[3];
    band_at(row + f0.x, lo);
    band_at(row + f0.y, hi);
    recon_math<Q, 0>(w, wl0, wh0, lo, hi, o);
    recon_math<Q, 1>(w, wl1, wh1, lo, hi, o);
    recon_math<Q, 2>(w, wl2, wh2, lo, hi, o);
    recon_math<Q, 3>(w, wl3, wh3, lo, hi, o);
  } else {
    recon_pixel<Q, 0>(w, wl0, wh0, f0, row, o);
    recon_pixel<Q, 1>(w, wl1, wh1, lds_v2<8 * (4 * Q + 1)>(offs), row, o);
    recon_pixel<Q, 2>(w, wl2, wh2, lds_v2<8 * (4 * Q + 2)>(offs), row, o);
    recon_pixel<Q, 3>(w, wl3, wh3, f3, row, o);
  }
  w[3 * Q] = pack4(o[0], o[1], o[2], o[3]);
  w[3 * Q + 1] = pack4(o[4], o[5], o[6], o[7]);
  w[3 * Q + 2] = pack4(o[8], o[9], o[10], o[11]);
}

// A pass tile is kPassRows rows of kRowChunks 16-byte chunks (a full
// strip), kChunks a thread: chunk i of a thread is k = tid + kThreads * i,
// row k / kRowChunks (a constant divisor), column chunk k % kRowChunks.
// Chunks past a part strip's cpr or a part pass's pr are skipped.
constexpr int kRowChunks = 3 * kStripCols / 16;
constexpr int kChunks = kPassRows * kRowChunks / kThreads;
static_assert(kChunks * kThreads == kPassRows * kRowChunks, "chunks");

// Start the copies of pass p's rows (pr of them) into ring slot p % kRing.
__device__ __forceinline__ void load_pass(uint8_t* ring, const uint8_t* src,
                                          long long ish, int p, int pr,
                                          int cpr) {
#if !defined(K7_PROBE_STORE_ONLY) && !defined(K7_PROBE_MATH_ONLY)
  uint8_t* slot = ring + (p % kRing) * kPassRows * kPitch;
  const uint8_t* rows = src + (long long)p * kPassRows * ish;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int k = threadIdx.x + kThreads * i;
    const int rr = k / kRowChunks, ch = k - rr * kRowChunks;
    if (rr < pr && ch < cpr)
      cp_async16(slot + rr * kPitch + 16 * ch, rows + rr * ish + 16 * ch);
  }
#endif
}

// Store the pr rows of a reconstructed pass tile.
__device__ __forceinline__ void store_pass(uint8_t* rows, long long osh,
                                           const uint8_t* slot, int pr,
                                           int cpr) {
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int k = threadIdx.x + kThreads * i;
    const int rr = k / kRowChunks, ch = k - rr * kRowChunks;
    if (rr < pr && ch < cpr)
      st_cs16(rows + rr * osh + 16 * ch,
              *reinterpret_cast<const uint4*>(slot + rr * kPitch + 16 * ch));
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
evm_reconstruct_vec_kernel(const uint8_t* __restrict__ in, long long ist,
                           long long ish, uint8_t* __restrict__ out,
                           long long ost, long long osh,
                           const float* __restrict__ band, int hb, int wb,
                           const int32_t* __restrict__ v_lo,
                           const int32_t* __restrict__ v_hi,
                           const float* __restrict__ v_wlo,
                           const float* __restrict__ v_whi,
                           const int32_t* __restrict__ h_lo,
                           const int32_t* __restrict__ h_hi,
                           const float* __restrict__ h_wlo,
                           const float* __restrict__ h_whi, int H, int W,
                           int seg_rows, int strips, int segments) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem;                     // [kRing][kPassRows][kPitch]
  uint2* offs = reinterpret_cast<uint2*>(smem + kRing * kPassRows * kPitch);
  float2* wts = reinterpret_cast<float2*>(offs + kStripCols);
  float* vrow = reinterpret_cast<float*>(wts + kStripCols);
  // vrow: [band column][seg_rows][3 channels]

  const int strip = blockIdx.x % strips;
  const int rest = blockIdx.x / strips;
  const int seg = rest % segments;
  const long long t = rest / segments;
  const int x0 = strip * kStripCols;
  const int ncols = min(kStripCols, W - x0);
  const int groups = ncols / 16;
  const int cpr = 3 * groups;                    // 16-byte chunks a row
  const int r0 = seg * seg_rows;
  const int nr = min(seg_rows, H - r0);
  const int passes = (nr + kPassRows - 1) / kPassRows;
  const int tid = threadIdx.x;
  const uint8_t* src = in + t * ist + (long long)r0 * ish + 3 * x0;
  uint8_t* dst = out + t * ost + (long long)r0 * osh + 3 * x0;

  // 1. The first kRing - 1 passes' rows into the ring, a commit group each.
#pragma unroll
  for (int p = 0; p < kRing - 1; ++p) {
    if (p < passes)
      load_pass(ring, src, ish, p, min(kPassRows, nr - p * kPassRows), cpr);
    cp_async_commit();
  }

  // 2. The strip's taps and the band's rows for the whole segment, while
  // the copies fly.  The tables' lo is non-decreasing and hi is lo or
  // lo + 1, so the strip reads band columns cb0 .. min(lo[last] + 1,
  // wb - 1) alone.
  const int cb0 = h_lo[x0];
  const int nb = min(h_lo[x0 + ncols - 1] + 1, wb - 1) - cb0 + 1;
  if (tid < ncols) {
    const int x = x0 + tid;
    offs[tid] = make_uint2((h_lo[x] - cb0) * 12 * seg_rows,
                           (h_hi[x] - cb0) * 12 * seg_rows);
    wts[tid] = make_float2(h_wlo[x], h_whi[x]);
  }
  {
    // Lane l of warp q: rows l, l + 32, ..., values k = q, q + 8, ... of
    // k = 3 * column + channel.
    const float* bt = band + t * 3LL * hb * wb + cb0;
    const long long pl = (long long)hb * wb;
    for (int rr = tid & 31; rr < nr; rr += 32) {
      const int r = r0 + rr;
      const long long lo = (long long)v_lo[r] * wb;
      const long long hi = (long long)v_hi[r] * wb;
      const float wl = v_wlo[r], wh = v_whi[r];
#pragma unroll 4
      for (int k = tid >> 5; k < 3 * nb; k += kThreads / 32) {
        const int col = k / 3, c = k - 3 * col;
        const float* b = bt + c * pl + col;
        vrow[(col * seg_rows + rr) * 3 + c] = __fmaf_rn(wh, b[hi],
                                                        wl * b[lo]);
      }
    }
  }

  // 3. Each pass: wait for its rows, start the copies kRing - 1 passes
  // ahead into the slot the last pass freed, reconstruct in place, store.
  const int warp = tid >> 5, lane = tid & 31;
  const uint32_t offs_a = smem_addr(offs + 16 * warp);
  const uint32_t wts_a = smem_addr(wts + 16 * warp);
  for (int p = 0; p < passes; ++p) {
    cp_async_wait<kRing - 2>();
    __syncthreads();
    const int q = p + kRing - 1;
    if (q < passes)
      load_pass(ring, src, ish, q, min(kPassRows, nr - q * kPassRows), cpr);
    cp_async_commit();
    uint8_t* slot = ring + (p % kRing) * kPassRows * kPitch;
    const int rr = p * kPassRows + lane;
#if !defined(K7_PROBE_LOAD_ONLY) && !defined(K7_PROBE_STORE_ONLY) \
    && !defined(K7_PROBE_NO_MATH)
    if (warp < groups && rr < nr) {
      const uint32_t px = smem_addr(slot + lane * kPitch + 48 * warp);
      const uint32_t row = smem_addr(vrow + 3 * rr);
      uint32_t w[12];
      const uint4 a = lds_v4<0>(px), b = lds_v4<16>(px), c = lds_v4<32>(px);
      w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
      w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
      w[8] = c.x; w[9] = c.y; w[10] = c.z; w[11] = c.w;
      recon_quad<0>(w, offs_a, wts_a, row);
      recon_quad<1>(w, offs_a, wts_a, row);
      recon_quad<2>(w, offs_a, wts_a, row);
      recon_quad<3>(w, offs_a, wts_a, row);
      sts_v4<0>(px, make_uint4(w[0], w[1], w[2], w[3]));
      sts_v4<16>(px, make_uint4(w[4], w[5], w[6], w[7]));
      sts_v4<32>(px, make_uint4(w[8], w[9], w[10], w[11]));
    }
    __syncthreads();
#endif
#if !defined(K7_PROBE_LOAD_ONLY) && !defined(K7_PROBE_MATH_ONLY)
    store_pass(dst + (long long)p * kPassRows * osh, osh, slot,
               min(kPassRows, nr - p * kPassRows), cpr);
#endif
  }
  cp_async_wait<0>();
}

int generic(const uint8_t* in, Strides is, uint8_t* out, Strides os,
            const float* band, const int32_t* v_lo, const int32_t* v_hi,
            const float* v_wlo, const float* v_whi, const int32_t* h_lo,
            const int32_t* h_hi, const float* h_wlo, const float* h_whi,
            int T, int H, int W, int hb, int wb, cudaStream_t stream) {
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
        in, is, out, os, band, hb, wb, v_lo, v_hi, v_wlo, v_whi, h_lo, h_hi,
        h_wlo, h_whi, H, W, rows, tiles_y);
  }
  return (int)cudaGetLastError();
}

bool aligned16(const void* p, long long a, long long b) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && a % 16 == 0
         && b % 16 == 0;
}

}  // namespace

// instance 0 is the generic kernel (the geometry arguments are not read);
// instance 1 the vectorised one, whose launch comes from
// ops/evm_recon_cuda.py::k7_geometry and which refuses a layout, alignment
// or shape it was not written for.
extern "C" int vhr_evm_reconstruct(
    const uint8_t* in, long long ist, long long isc, long long ish,
    long long isw, uint8_t* out, long long ost, long long osc, long long osh,
    long long osw, const float* band, const int32_t* v_lo,
    const int32_t* v_hi, const float* v_wlo, const float* v_whi,
    const int32_t* h_lo, const int32_t* h_hi, const float* h_wlo,
    const float* h_whi, int T, int H, int W, int hb, int wb, int instance,
    int ring, int seg_rows, int strips, int segments, int band_cols,
    cudaStream_t stream) {
  if (T < 0 || H < 1 || W < 1 || hb < 1 || wb < 1)
    return (int)cudaErrorInvalidValue;
  if (instance == 0)
    return generic(in, Strides{ist, isc, ish, isw}, out,
                   Strides{ost, osc, osh, osw}, band, v_lo, v_hi, v_wlo,
                   v_whi, h_lo, h_hi, h_wlo, h_whi, T, H, W, hb, wb, stream);
  if (instance != 1 || isc != 1 || isw != 3 || osc != 1 || osw != 3
      || W % 16 != 0 || !aligned16(in, ist, ish) || !aligned16(out, ost, osh)
      || ring != kRing || seg_rows < kPassRows || seg_rows % kPassRows != 0
      || strips != (W + kStripCols - 1) / kStripCols
      || segments != (H + seg_rows - 1) / seg_rows || band_cols < 1
      || band_cols > wb)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kRing * kPassRows * kPitch
                      + kStripCols * (sizeof(uint2) + sizeof(float2))
                      + 3 * (size_t)band_cols * seg_rows * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)T * segments * strips;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return (int)cudaGetLastError();
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        evm_reconstruct_vec_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  evm_reconstruct_vec_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      in, ist, ish, out, ost, osh, band, hb, wb, v_lo, v_hi, v_wlo, v_whi,
      h_lo, h_hi, h_wlo, h_whi, H, W, seg_rows, strips, segments);
  return (int)cudaGetLastError();
}
