// K1: skin-chroma face detection + holdover tracking + cheek-ROI means,
// for Hopper (sm_90a).
//
// Replaces vhr_tpu/ops/pallas_fused.py::fused_detect_roi_carry (body
// _kernel, wrapped by fused_detect_roi_pallas).  Plain version:
// ops/fused_cuda.py::fused_detect_roi_plain.  The outputs equal the Pallas
// kernel's: boxes, flags, carry and ROI counts exactly, means as exact
// integer sums divided in float32.
//
// Bound: device-memory bytes.  Every detection frame is read once in full
// (H x W*3 u8, 6.2 MB at 1080p) for the skin test, plus the cheek-ROI rows
// once more for the channel sums; the arithmetic is ~30 float ops per
// (pooled) pixel, which without pooling bounds the pass by its instruction
// rate instead.
//
// Design.  On the TPU the frames run in order on one core and the tracking
// state rides in SMEM from one grid step to the next.  On Hopper the frames
// need not run in order: the state serialises only the ROI box, the gate
// band and the holdover budget, while the skin test of a row chunk depends
// on its pixels alone.  So K1 is two launches:
//
//   1. pass_kernel.  Blocks 1.. are the skin pass, one per (frame, row
//      chunk) of the frames that detect, in frame order.  Chunks use K1's
//      geometry (rb rows, the last chunk's start clamped to H - rb, rows
//      below the unclamped origin skipped).  A thread takes whole work
//      items: one 16-pixel group of one pooled row, read as three 16-byte
//      loads a row (the vector instance; the scalar one reads bytes, for
//      rows off the 16-byte grid), the pool's rows summed exactly as
//      packed 16-bit lanes in registers, then vhr::is_skin on
//      sum * (1/pool).  The next item's first rows are loaded before this
//      item's pixels are tested, so the tests run under the loads.  A
//      chunk's summary is [cells, rmin, rmax, xmin, xmax] and two column
//      bitmasks of ceil(W/32) words: `once` marks the columns with a skin
//      cell (xmin, xmax are its extent), `twice` (pool 1 only) those with
//      two or more.  A column's test `cells * pool >= 2`
//      over any set of chunks is then exact: with pooling it is `once`, so
//      the extent is the min and max of the chunks' extents; without, it
//      is `twice` after twice |= m2 | (once & m1); once |= m1 over the
//      chunks.  The block publishes its summary by a release on the frame's
//      ready count; the frame's last chunk block to count (an atomic
//      ticket) adds the frame's chunks up into the frame's own summary (the
//      answer whenever the whole frame is scanned) and counts once more.
//      Block 0 is the tracker: its first warp walks the frames in order,
//      32 at a time, a lane waiting with acquire loads for its frame's
//      summary and loading it.  A detection whose gate band holds every
//      chunk takes that summary; otherwise the warp adds the band's chunks
//      up (__reduce_*_sync, no block barrier).  Then it applies K1's state
//      update, writes boxes, flags and the frame's ROI (from the pre-update
//      box, floor/ceil in float32, no clipping), and sets the ready counts
//      back to zero for the next launch.  The pass never waits on the
//      tracker, so every block of it can always be scheduled, and the
//      serial walk runs beside the pass instead of after it.
//   2. vhr_roi_means_u8 (K2, roi_means.cu) on those ROIs, with count set to
//      0 where the ROI is not valid, launched as the host's plan for it
//      says (ops/roi_means_cuda.py::roi_plan).
//
// The chroma test and the group reads are in skin_chunk.cuh, shared with
// K4 (fused_slots.cu).

#include "skin_chunk.cuh"

extern "C" int vhr_roi_means_u8(const uint8_t* frames, const int32_t* rois,
                                const int32_t* roi_ok, int ok_stride,
                                float* means, float* count,
                                int T, int H, int W, int C, int instance,
                                int bands, int threads, int grid,
                                cudaStream_t stream);

namespace {

using vhr::SkinBox;
using vhr::kGroupPixels;
using vhr::kGroupWords;

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
// Rows of a work item loaded before any is summed.
constexpr int kDepth = 4;
// The tracker gives up (and traps, so that the launch fails instead of
// hanging) after waiting this many clock cycles for one batch of frames.
constexpr long long kSpinLimit = 1LL << 34;

// Words of a frame's and of a chunk's summary before the chunk's masks.
constexpr int kHead = 8;

struct Params {
  int t_len, phase0, H, W, rb, n_chunks, detect_every, seq_len;
  int gated, rescan_every, hold;
  float gate_margin, min_area, cheek_h, cheek_top, cheek_bot;
  int words;          // mask words a chunk: ceil(W / 32)
  int stride;         // int32 words of a chunk's summary: kHead + 2 * words
  int frame_stride;   // of a frame's: kHead + n_chunks * stride
};

__device__ __forceinline__ bool detects(int phase, const Params& p) {
  return phase % p.detect_every == 0 ||
         (p.seq_len > 0 && phase % p.seq_len == 0);
}

__device__ __forceinline__ int ld_acquire(const int32_t* ptr) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(ptr) : "memory");
  return v;
}

template <int POOL>
constexpr int kRowsInFlight = POOL < kDepth ? POOL : kDepth;

// N rows of a 16-pixel group, row_bytes apart, from a 16-byte aligned
// address.
template <int N>
__device__ __forceinline__ void load_rows(const uint8_t* src,
                                          long long row_bytes,
                                          uint4 (&v)[N][3]) {
#pragma unroll
  for (int r = 0; r < N; ++r) vhr::load_row(src + r * row_bytes, v[r]);
}

// Rows v of a group added into its exact sums, as 16-bit lanes: e holds
// bytes 0 and 2 of each word, o bytes 1 and 3.  Without pooling the row is
// only unpacked into w.
template <int POOL, int N>
__device__ __forceinline__ void add_rows(const uint4 (&v)[N][3],
                                         uint32_t (&e)[kGroupWords],
                                         uint32_t (&o)[kGroupWords],
                                         uint32_t (&w)[kGroupWords]) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      w[4 * i] = v[r][i].x; w[4 * i + 1] = v[r][i].y;
      w[4 * i + 2] = v[r][i].z; w[4 * i + 3] = v[r][i].w;
    }
    if constexpr (POOL > 1) {
#pragma unroll
      for (int i = 0; i < kGroupWords; ++i) {
        e[i] += w[i] & 0x00ff00ffu;
        o[i] += (w[i] >> 8) & 0x00ff00ffu;
      }
    }
  }
}

// The skin cells of a group from its sums (w: its one row when POOL == 1):
// bit j is pixel j's test on the pooled mean.
template <int POOL>
__device__ __forceinline__ unsigned test_group(
    const uint32_t (&e)[kGroupWords], const uint32_t (&o)[kGroupWords],
    const uint32_t (&w)[kGroupWords], const SkinBox& skin) {
  constexpr float inv = 1.0f / (float)POOL;   // exact: a power of two
  unsigned mask = 0;
#pragma unroll
  for (int j = 0; j < kGroupPixels; ++j) {
    float cb, cg, cr;
    if constexpr (POOL == 1) {
      cb = vhr::byte_f32(w, 3 * j);
      cg = vhr::byte_f32(w, 3 * j + 1);
      cr = vhr::byte_f32(w, 3 * j + 2);
    } else {
      cb = __fmul_rn(vhr::lane_f32(e, o, 3 * j), inv);
      cg = __fmul_rn(vhr::lane_f32(e, o, 3 * j + 1), inv);
      cr = __fmul_rn(vhr::lane_f32(e, o, 3 * j + 2), inv);
    }
    if (vhr::is_skin(cb, cg, cr, skin)) mask |= 1u << j;
  }
  return mask;
}

// The same from any address, a byte a load, for the group's first n_px
// pixels (the last group of a row whose width is not a multiple of 16).
template <int POOL>
__device__ __forceinline__ unsigned group_mask_scalar(
    const uint8_t* src, long long row_bytes, int n_px, const SkinBox& skin) {
  constexpr float inv = 1.0f / (float)POOL;
  unsigned mask = 0;
  for (int j = 0; j < n_px; ++j) {
    const uint8_t* px = src + 3 * j;
    int sb = 0, sg = 0, sr = 0;
#pragma unroll
    for (int r = 0; r < POOL; ++r, px += row_bytes) {
      sb += __ldg(px); sg += __ldg(px + 1); sr += __ldg(px + 2);
    }
    if (vhr::is_skin(__fmul_rn((float)sb, inv), __fmul_rn((float)sg, inv),
                     __fmul_rn((float)sr, inv), skin))
      mask |= 1u << j;
  }
  return mask;
}

// Warp reductions of a detection's [xmin, xmax, cells, rmin, rmax].
__device__ __forceinline__ void reduce_extent(int (&f)[5]) {
  f[0] = __reduce_min_sync(kFull, f[0]);
  f[1] = __reduce_max_sync(kFull, f[1]);
  f[2] = __reduce_add_sync(kFull, f[2]);
  f[3] = __reduce_min_sync(kFull, f[3]);
  f[4] = __reduce_max_sync(kFull, f[4]);
}

// The x extent of the occupied columns over the chunks c of frame summary
// fs with sel(c), for pool 1 (two cells a column): a lane a mask word.
template <typename Sel>
__device__ __forceinline__ void twice_extent(const int32_t* __restrict__ fs,
                                             const Params& p, int first,
                                             int step, Sel sel, int (&f)[5]) {
  for (int i = first; i < p.words; i += step) {
    unsigned once = 0, twice = 0;
#pragma unroll 4
    for (int c = 0; c < p.n_chunks; ++c) {
      if (sel(c)) {
        // The frame's head, chunk c's head, then its mask words.
        const int32_t* s = fs + kHead + (long long)c * p.stride + kHead + i;
        const unsigned m1 = (unsigned)__ldcg(s);
        twice |= (unsigned)__ldcg(s + p.words) | (once & m1);
        once |= m1;
      }
    }
    if (twice) {
      f[0] = min(f[0], 32 * i + __ffs(twice) - 1);
      f[1] = max(f[1], 32 * i + 31 - __clz(twice));
    }
  }
}

// One block's skin pass over chunk `cell % n_chunks` of frame
// `cell / n_chunks`.  The frame's summary at summary + t * frame_stride:
// [xmin, xmax, cells, rmin, rmax, 0, 0, 0] over the whole frame, then a
// chunk's [cells, rmin, rmax, xmin, xmax, 0, 0, 0, once[words],
// twice[words]] each (rmin = H, rmax = -1 when no pooled row holds >= 2
// skin cells; xmin, xmax the extent of `once`; twice written only when
// POOL == 1).  The chunk's block counts itself on ready[t]; the last of the
// frame to count adds the frame's chunks up and counts once more.
template <int POOL, bool VEC>
__device__ __forceinline__ void chunk_pass(
    const uint8_t* __restrict__ frames, const Params& p, const SkinBox& skin,
    int32_t* __restrict__ summary, int32_t* __restrict__ ready, int cell) {
  const int t = cell / p.n_chunks, chunk = cell - t * p.n_chunks;
  if (!detects(p.phase0 + t, p)) return;
  extern __shared__ int smem[];
  const int rbp = p.rb / POOL;
  int* s_row = smem;   // skin cells a pooled row
  unsigned* s_once = reinterpret_cast<unsigned*>(smem + rbp);
  unsigned* s_twice = s_once + p.words;
  __shared__ int s_ext[5];   // the chunk's [xmin, xmax, cells, rmin, rmax]
  __shared__ bool s_last;
  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < rbp + 2 * p.words; i += kThreads) smem[i] = 0;
  if (tid == 0) {
    s_ext[0] = p.W; s_ext[1] = -1; s_ext[2] = 0; s_ext[3] = p.H;
    s_ext[4] = -1;
  }
  __syncthreads();

  const int row0 = chunk * p.rb;            // unclamped origin
  const int start = min(row0, p.H - p.rb);  // clamped origin
  const int q0 = (row0 - start) / POOL;     // pooled rows above q0 were done
  const int groups = (p.W + kGroupPixels - 1) / kGroupPixels;
  const long long row_bytes = 3LL * p.W;
  const uint8_t* base = frames + ((long long)t * p.H + start) * row_bytes;
  const int n_items = (rbp - q0) * groups;
  // An item is one group of one pooled row; neighbouring threads take
  // neighbouring groups.  mark() adds an item's skin cells to the chunk's
  // row counts and column masks.
  auto mark = [&](unsigned mask, int q, int g) {
    if (mask) {
      atomicAdd(&s_row[q], __popc(mask));
      // Word g / 2 holds columns 32 * (g / 2) ...: this group's half.
      const unsigned m = mask << (16 * (g & 1));
      const unsigned old = atomicOr(&s_once[g >> 1], m);
      // A column another item of the chunk marked already holds two cells.
      if (POOL == 1 && (old & m)) atomicOr(&s_twice[g >> 1], old & m);
    }
  };
  auto src_of = [&](int it) {
    return base + (long long)(q0 + it / groups) * POOL * row_bytes +
           3LL * kGroupPixels * (it % groups);
  };
  if constexpr (VEC) {
    // The next item's first rows load while this item's pixels are tested.
    constexpr int kRows = kRowsInFlight<POOL>;
    uint4 buf[kRows][3];
    if (tid < n_items) load_rows(src_of(tid), row_bytes, buf);
    for (int it = tid; it < n_items; it += kThreads) {
      uint32_t e[kGroupWords] = {}, o[kGroupWords] = {}, w[kGroupWords];
      add_rows<POOL>(buf, e, o, w);
#pragma unroll
      for (int r0 = kRows; r0 < POOL; r0 += kRows) {
        load_rows(src_of(it) + r0 * row_bytes, row_bytes, buf);
        add_rows<POOL>(buf, e, o, w);
      }
      if (it + kThreads < n_items)
        load_rows(src_of(it + kThreads), row_bytes, buf);
      mark(test_group<POOL>(e, o, w, skin), q0 + it / groups, it % groups);
    }
  } else {
    for (int it = tid; it < n_items; it += kThreads) {
      const int g = it % groups;
      mark(group_mask_scalar<POOL>(src_of(it), row_bytes,
                                   min(kGroupPixels, p.W - kGroupPixels * g),
                                   skin),
           q0 + it / groups, g);
    }
  }
  __syncthreads();

  int32_t* fs = summary + (long long)t * p.frame_stride;
  int32_t* out = fs + kHead + (long long)chunk * p.stride;
  int f[5] = {p.W, -1, 0, p.H, -1};
  for (int q = q0 + tid; q < rbp; q += kThreads) {
    const int v = s_row[q];
    f[2] += v;
    if (v >= 2) {
      f[3] = min(f[3], start + q * POOL);
      f[4] = max(f[4], start + q * POOL + POOL - 1);
    }
  }
  for (int i = tid; i < p.words; i += kThreads) {
    const unsigned m = s_once[i];
    out[kHead + i] = (int)m;
    if (POOL == 1) out[kHead + p.words + i] = (int)s_twice[i];
    if (m) {
      f[0] = min(f[0], 32 * i + __ffs(m) - 1);
      f[1] = max(f[1], 32 * i + 31 - __clz(m));
    }
  }
  reduce_extent(f);
  if (lane == 0) {
    atomicMin(&s_ext[0], f[0]);
    atomicMax(&s_ext[1], f[1]);
    atomicAdd(&s_ext[2], f[2]);
    atomicMin(&s_ext[3], f[3]);
    atomicMax(&s_ext[4], f[4]);
  }
  // The barrier orders the block's stores before thread 0's fence, the
  // fence before the count that publishes them.
  __syncthreads();
  if (tid == 0) {
    out[0] = s_ext[2]; out[1] = s_ext[3]; out[2] = s_ext[4];
    out[3] = s_ext[0]; out[4] = s_ext[1];
    __threadfence();
    s_last = atomicAdd(ready + t, 1) == p.n_chunks - 1;
    // Ready for the frame's sum, if this block is the frame's last.
    s_ext[0] = p.W; s_ext[1] = -1; s_ext[2] = 0; s_ext[3] = p.H;
    s_ext[4] = -1;
  }
  __syncthreads();
  if (!s_last) return;

  // The frame's last chunk: the whole frame's detection, from its chunks.
  __threadfence();
  int g[5] = {p.W, -1, 0, p.H, -1};
  for (int c = tid; c < p.n_chunks; c += kThreads) {
    const int32_t* s = fs + kHead + (long long)c * p.stride;
    g[2] += __ldcg(s);
    g[3] = min(g[3], __ldcg(s + 1));
    g[4] = max(g[4], __ldcg(s + 2));
    if (POOL > 1) {   // occupied: a cell in the column
      g[0] = min(g[0], __ldcg(s + 3));
      g[1] = max(g[1], __ldcg(s + 4));
    }
  }
  if (POOL == 1)   // occupied: two cells in the column
    twice_extent(fs, p, tid, kThreads, [](int) { return true; }, g);
  reduce_extent(g);
  if (lane == 0) {
    atomicMin(&s_ext[0], g[0]);
    atomicMax(&s_ext[1], g[1]);
    atomicAdd(&s_ext[2], g[2]);
    atomicMin(&s_ext[3], g[3]);
    atomicMax(&s_ext[4], g[4]);
  }
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < 5; ++k) fs[k] = s_ext[k];
    __threadfence();
    atomicAdd(ready + t, 1);
  }
}

// Frame t's detection over the chunks that meet the band [gy1, gy2), by one
// warp: x extent of the occupied columns, cell count and row extent.
template <int POOL>
__device__ __forceinline__ void band_extent(const int32_t* __restrict__ fs,
                                            const Params& p, int gy1, int gy2,
                                            int (&f)[5]) {
  const int lane = threadIdx.x & 31;
  auto sel = [&](int c) {
    const int start = min(c * p.rb, p.H - p.rb);
    return start < gy2 && start + p.rb > gy1;
  };
  for (int c = lane; c < p.n_chunks; c += 32) {
    if (sel(c)) {
      const int32_t* s = fs + kHead + (long long)c * p.stride;
      f[2] += __ldcg(s);
      f[3] = min(f[3], __ldcg(s + 1));
      f[4] = max(f[4], __ldcg(s + 2));
      if (POOL > 1) {
        f[0] = min(f[0], __ldcg(s + 3));
        f[1] = max(f[1], __ldcg(s + 4));
      }
    }
  }
  if (POOL == 1) twice_extent(fs, p, lane, 32, sel, f);
  reduce_extent(f);
}

// The tracker: warp 0 of block 0 walks the launch's frames in order.  A
// detection whose band holds every chunk takes the frame's own summary.
template <int POOL>
__device__ __forceinline__ void track(const int32_t* __restrict__ summary,
                                      int32_t* __restrict__ ready,
                                      const Params& p,
                                      const int32_t* __restrict__ carry_in,
                                      int32_t* __restrict__ carry_out,
                                      int32_t* __restrict__ rois,
                                      int32_t* __restrict__ boxes,
                                      int32_t* __restrict__ flags) {
  const int lane = threadIdx.x;
  int st[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) st[j] = carry_in[j];
  for (int t0 = 0; t0 < p.t_len; t0 += 32) {
    // Lane j waits for frame t0 + j's summary, clears its count and loads
    // the whole frame's detection.
    const int mine = t0 + lane;
    int whole[5] = {p.W, -1, 0, p.H, -1};
    if (mine < p.t_len && detects(p.phase0 + mine, p)) {
      const long long begin = clock64();
      while (ld_acquire(ready + mine) <= p.n_chunks) {
        __nanosleep(256);
        if (clock64() - begin > kSpinLimit) __trap();
      }
      ready[mine] = 0;
#pragma unroll
      for (int k = 0; k < 5; ++k)
        whole[k] = __ldcg(summary + (long long)mine * p.frame_stride + k);
    }
    __syncwarp();
    int out[10];   // lane j's frame: box, ROI, flags
    const int n = min(32, p.t_len - t0);
    for (int j = 0; j < n; ++j) {
      const int t = t0 + j, phase = p.phase0 + t;
      const int bx1 = st[0], by1 = st[1], bx2 = st[2], by2 = st[3];
      bool has_prev = st[5] > 0;
      bool do_detect = phase % p.detect_every == 0;
      if (p.seq_len > 0) {
        const bool fresh = phase % p.seq_len == 0;
        has_prev = has_prev && !fresh;
        do_detect = do_detect || fresh;
      }
      const float bw = (float)(bx2 - bx1), bh = (float)(by2 - by1);
      const int rx1 = bx1 + (int)floorf(__fmul_rn(p.cheek_h, bw));
      const int rx2 = bx2 - (int)ceilf(__fmul_rn(p.cheek_h, bw));
      const int ry1 = by1 + (int)floorf(__fmul_rn(p.cheek_top, bh));
      const int ry2 = by1 + (int)floorf(__fmul_rn(p.cheek_bot, bh));

      int gy1 = 0, gy2 = p.H;
      if (p.gated) {
        const bool periodic = phase % (p.detect_every * p.rescan_every) == 0;
        const bool full = periodic || !has_prev || st[4] <= 0;
        const int marg = (int)ceilf(__fmul_rn(p.gate_margin, bh));
        if (!full) {
          gy1 = max(by1 - marg, 0);
          gy2 = min(by2 + 1 + marg, p.H);
        }
      }
      int f[5];   // xmin, xmax, cells, rmin, rmax
#pragma unroll
      for (int k = 0; k < 5; ++k) f[k] = __shfl_sync(kFull, whole[k], j);
      // Chunk starts run from 0 to H - rb: a band that meets both ends
      // holds every chunk.  Otherwise (uniform across the warp) the band's
      // chunks are added up here.
      if (do_detect && !(gy1 < p.rb && gy2 > p.H - p.rb)) {
        f[0] = p.W; f[1] = -1; f[2] = 0; f[3] = p.H; f[4] = -1;
        band_extent<POOL>(summary + (long long)t * p.frame_stride, p, gy1,
                          gy2, f);
      }

      const bool det_ok = do_detect && (float)(f[2] * POOL) >= p.min_area;
      const bool tracked = !do_detect && has_prev;
      const bool reuse_ok = do_detect && !det_ok && has_prev && st[4] > 0;
      const int nx1 = det_ok ? f[0] : bx1, ny1 = det_ok ? f[3] : by1;
      const int nx2 = det_ok ? f[1] : bx2, ny2 = det_ok ? f[4] : by2;
      const long long area = (long long)max(ry2 - ry1, 0) * max(rx2 - rx1, 0);
      const bool roi_ok = has_prev && area > 0;
      if (lane == j) {
        out[0] = nx1; out[1] = ny1; out[2] = nx2; out[3] = ny2;
        out[4] = rx1; out[5] = ry1; out[6] = rx2; out[7] = ry2;
        out[8] = (det_ok || tracked) ? 1 : 0;
        out[9] = roi_ok ? 1 : 0;
      }
      st[0] = nx1; st[1] = ny1; st[2] = nx2; st[3] = ny2;
      st[4] = det_ok ? p.hold : (reuse_ok ? st[4] - 1 : st[4]);
      st[5] = (det_ok || has_prev) ? 1 : 0;
    }
    if (lane < n) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        boxes[4LL * mine + k] = out[k];
        rois[4LL * mine + k] = out[4 + k];
      }
      flags[2LL * mine] = out[8];
      flags[2LL * mine + 1] = out[9];
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < 6; ++j) carry_out[j] = st[j];
  }
}

template <int POOL, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
pass_kernel(const uint8_t* __restrict__ frames, Params p, SkinBox skin,
            int32_t* __restrict__ summary, int32_t* __restrict__ ready,
            const int32_t* __restrict__ carry_in,
            int32_t* __restrict__ carry_out, int32_t* __restrict__ rois,
            int32_t* __restrict__ boxes, int32_t* __restrict__ flags) {
  if (blockIdx.x == 0) {
    if (threadIdx.x < 32)
      track<POOL>(summary, ready, p, carry_in, carry_out, rois, boxes, flags);
    return;
  }
  chunk_pass<POOL, VEC>(frames, p, skin, summary, ready, blockIdx.x - 1);
}

}  // namespace

// frames: (T, H, W*3) u8, launch covers frames [t_start, t_start + t_len).
// skin_instance: 0 the vector pass (the first frame 16-byte aligned and
// W*3 % 16 == 0), 1 the scalar one.  Scratch: summary (t_len, 8 +
// n_chunks * (8 + 2 * ceil(W/32))) int32; ready (t_len,) int32, zero before
// the launch and left zero by it.  Outputs: rois, boxes (t_len, 4) int32; flags
// (t_len, 2) int32 [det_valid, roi_valid]; means (t_len, 3) f32; count
// (t_len,) f32; carry_out (6,) int32.  roi_instance, roi_bands, roi_threads
// and roi_grid are K2's launch plan for the t_len frames.
extern "C" int vhr_fused_detect_roi(
    const uint8_t* frames, int t_start, int t_len, int phase0, int H, int W,
    int rb, int n_chunks, int pool, int detect_every, int seq_len, int gated,
    float gate_margin, int rescan_every, float min_area, float cb_min,
    float cb_max, float cr_min, float cr_max, float y_min, float cheek_h,
    float cheek_top, float cheek_bot, int hold, int skin_instance,
    int roi_instance, int roi_bands, int roi_threads, int roi_grid,
    const int32_t* carry_in, int32_t* carry_out, int32_t* summary,
    int32_t* ready, int32_t* rois, int32_t* boxes, int32_t* flags,
    float* means, float* count, cudaStream_t stream) {
  const uint8_t* first = frames + (long long)t_start * H * W * 3;
  const bool vec = skin_instance == 0;
  const int words = (W + 31) / 32;
  const size_t smem =
      sizeof(int) * (size_t)(rb / (pool > 0 ? pool : 1) + 2 * words);
  if (pool < 1 || rb % pool != 0 || rb > H || t_len < 0 || n_chunks < 1 ||
      detect_every < 1 || rescan_every < 1 || skin_instance < 0 ||
      skin_instance > 1 || smem > 48 * 1024 ||
      (long long)t_len * n_chunks >= (1LL << 31) - 1 ||
      (vec && ((reinterpret_cast<uintptr_t>(first) & 15u) != 0 ||
               (3 * W) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  const Params p{t_len, phase0, H, W, rb, n_chunks, detect_every, seq_len,
                 gated, rescan_every, hold, gate_margin, min_area, cheek_h,
                 cheek_top, cheek_bot, words, kHead + 2 * words,
                 kHead + n_chunks * (kHead + 2 * words)};
  const SkinBox skin{cb_min, cb_max, cr_min, cr_max, y_min};
  const unsigned grid = 1u + (unsigned)(t_len * n_chunks);
  switch (pool * 2 + (vec ? 1 : 0)) {
#define VHR_K1_LAUNCH(P, V)                                                 \
  case P * 2 + (V ? 1 : 0):                                                 \
    pass_kernel<P, V><<<grid, kThreads, smem, stream>>>(                    \
        first, p, skin, summary, ready, carry_in, carry_out, rois, boxes,   \
        flags);                                                             \
    break;
    VHR_K1_LAUNCH(1, true)
    VHR_K1_LAUNCH(1, false)
    VHR_K1_LAUNCH(2, true)
    VHR_K1_LAUNCH(2, false)
    VHR_K1_LAUNCH(4, true)
    VHR_K1_LAUNCH(4, false)
    VHR_K1_LAUNCH(8, true)
    VHR_K1_LAUNCH(8, false)
#undef VHR_K1_LAUNCH
    default:
      return (int)cudaErrorInvalidValue;
  }
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return vhr_roi_means_u8(first, rois, flags + 1, 2, means, count, t_len, H,
                          W, 3, roi_instance, roi_bands, roi_threads,
                          roi_grid, stream);
}
