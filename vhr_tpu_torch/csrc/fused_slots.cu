// K4: skin-chroma face detection + holdover tracking + cheek-ROI means for
// S independent serving slots, one frame each, for Hopper (sm_90a).
//
// Replaces vhr_tpu/ops/pallas_fused.py:420 fused_detect_roi_slots (the
// pallas_call at :479, body _kernel with per_slot=True).  Plain version:
// ops/fused_cuda.py::fused_detect_roi_slots_plain.  Per slot the outputs
// equal K1's at t_len=1 with phase = phase[s]: boxes, flags, carry and ROI
// counts exactly, means as exact integer sums divided in float32.
//
// Bound: device-memory bytes.  A serving tick reads each slot's frame once
// (H x W*3 u8, 2.8 MB at 720p, 176.9 MB for 64 slots).  The chroma test is
// about 22 instructions a pixel without row pooling, so the SMs'
// instruction rate stands close behind the bytes.
//
// Design.  On the TPU the slots run in order on one core, each grid step
// seeding the SMEM tracking state from its own carry row.  Here nothing
// runs in order, and one launch does the whole tick:
//
//   * Tiles.  A frame is cut into tiles of 8 rows x 16 pixels, one thread
//     each, 256 neighbouring tiles a block (7,200 tiles a slot at 720p,
//     1,856 blocks for 64 slots).  rb % 8 == 0 and H % 8 == 0, so a tile
//     never straddles a row chunk or a pooled row: its rows belong to
//     chunk r / rb, and it is scanned when the slot's gate and cadence
//     select that chunk (the selection itself tests the chunk's clamped
//     extent, as K1 does).  A tile that is neither scanned nor touched by
//     the cheek ROI reads nothing.
//   * Loads.  16 pixels are 48 bytes: a thread reads a tile row as three
//     16-byte loads, the next rows' loads in flight while it tests this
//     one.  W*3 % 128 == 0 keeps every row 16-byte aligned.
//   * Skin test.  Bytes become floats through a byte permute into the
//     mantissa of 2^23 and one subtraction (exact, no int-to-float
//     conversion); pooled rows are summed as packed 16-bit lanes.  The test
//     itself is vhr::is_skin on (sum * 1/pool), as in skin_chunk.cuh.
//   * Counts.  The box needs, per column, only whether it holds one skin
//     cell (two without pooling): a thread keeps those as two 16-bit masks
//     and ORs them into the slot's word for its strip, one atomic a tile.
//     Pooled rows' counts meet in shared memory and go to the slot's
//     rowsum[H]; their total is the cell count.  All integer atomics, so
//     their order cannot change a bit.
//   * ROI sums in the same pass.  The cheek ROI is that of the pre-update
//     box, so every thread knows it from the carry row.  A tile that the
//     ROI touches adds its bytes inside the ROI, clipped to the frame, from
//     the registers it holds, whether or not its chunk is scanned.
//   * Finish.  Each block draws a ticket from the slot's counter after a
//     __threadfence(); the block that draws the last one reads the masks
//     and rowsum back (x extent, cell count, row extent), applies the
//     holdover update, divides the sums and writes the slot's outputs.  It
//     leaves the slot's accumulators and ticket at zero, so the next tick
//     needs no memset.
//
// The scratch (layout below) must be zero before the first launch and must
// not be shared by launches on different streams; the wrapper keeps one
// per device and stream.

#include "skin_chunk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 8;
constexpr int kTileCols = 16;
// Tile rows in flight a thread, and blocks an SM must hold: without
// pooling the pixel tests need the registers and the warps, with it the
// loads do.
__host__ __device__ constexpr int depth_of(int pool) {
  return pool == 1 ? 1 : 2;
}
__host__ __device__ constexpr int min_blocks_of(int pool) {
  return pool == 1 ? 4 : 3;
}
constexpr int kRowWords = 3 * kTileCols / 4;   // 12 words a tile row
// A block's tiles span at most kThreads / 8 + 2 row groups (W >= 128 gives
// 8 tiles a row group at least), each of at most 8 pooled rows.
constexpr int kBlockRows = kThreads + 2 * kTileRows;
constexpr float kTwo23 = 8388608.0f;

struct SlotParams {
  int H, W, rb, detect_every, gated, rescan_every, hold;
  float gate_margin, min_area, cheek_h, cheek_top, cheek_bot;
};

// Zero-initialised accumulators, for S slots: sums (S, 3) u64 BGR sums
// over the ROI; done (S,) tickets; colmask (S, W / 16), a word per strip of
// 16 columns: bit j says column j holds a skin cell, bit 16 + j that it
// holds two or more; rowsum (S, H) skin cells per pooled row (H / pool
// entries used).  S * (7 + W / 16 + H) int32 in all, in this order.
struct Scratch {
  unsigned long long* sums;
  int32_t* done;
  unsigned int* colmask;
  int32_t* rowsum;
};

// A slot's detection decision for this tick and its gate band [gy1, gy2).
struct Gate {
  bool do_detect;
  int gy1, gy2;
};

// st: the slot's carry row [x1, y1, x2, y2, budget, has_last].
__device__ __forceinline__ Gate slot_gate(const int32_t* st, int phase,
                                          const SlotParams& p) {
  Gate g{phase % p.detect_every == 0, 0, p.H};
  if (p.gated) {
    const bool has_prev = st[5] > 0;
    const bool periodic = phase % (p.detect_every * p.rescan_every) == 0;
    if (!(periodic || !has_prev || st[4] <= 0)) {
      const float bh = (float)(st[3] - st[1]);
      const int marg = (int)ceilf(__fmul_rn(p.gate_margin, bh));
      g.gy1 = max(st[1] - marg, 0);
      g.gy2 = min(st[3] + 1 + marg, p.H);
    }
  }
  return g;
}

__device__ __forceinline__ bool chunk_selected(const Gate& g, int chunk,
                                               const SlotParams& p) {
  const int start = min(chunk * p.rb, p.H - p.rb);
  return g.do_detect && start < g.gy2 && start + p.rb > g.gy1;
}

// Byte k (0..47) of a tile row as a float: the byte goes into the mantissa
// of 2^23, which is then taken off.
__device__ __forceinline__ float byte_f32(const uint32_t (&w)[kRowWords],
                                          int k) {
  return __uint_as_float(__byte_perm(w[k >> 2], 0x4B000000u,
                                     0x7440u | (k & 3))) - kTwo23;
}

// The same for byte k of rows summed as 16-bit lanes: e holds bytes 0 and
// 2 of each word, o bytes 1 and 3 (sums of 8 rows stay below 2^16).
__device__ __forceinline__ float lane_f32(const uint32_t (&e)[kRowWords],
                                          const uint32_t (&o)[kRowWords],
                                          int k) {
  const uint32_t src = (k & 1) ? o[k >> 2] : e[k >> 2];
  return __uint_as_float(__byte_perm(src, 0x4B000000u,
                                     (k & 2) ? 0x7432u : 0x7410u)) - kTwo23;
}

__device__ __forceinline__ void load_row(const uint8_t* row, uint4 (&v)[3]) {
  const uint4* q = reinterpret_cast<const uint4*>(row);
#pragma unroll
  for (int i = 0; i < 3; ++i) v[i] = __ldg(q + i);
}

// grid (blocks per slot, S); POOL rows are mean-pooled before the test.
template <int POOL>
__global__ void __launch_bounds__(kThreads, min_blocks_of(POOL))
slot_tick_kernel(const uint8_t* __restrict__ frames,
                 const int32_t* __restrict__ carry,
                 const int32_t* __restrict__ phase, SlotParams p,
                 vhr::SkinBox skin, Scratch sc,
                 int32_t* __restrict__ carry_out, int32_t* __restrict__ boxes,
                 uint8_t* __restrict__ valid, float* __restrict__ means,
                 float* __restrict__ count) {
  constexpr int kUnits = kTileRows / POOL;   // pooled rows a tile
  constexpr int kDepth = depth_of(POOL);
  __shared__ int s_row[kBlockRows];
  __shared__ int s_fin[5];                   // xmin, xmax, cells, rmin, rmax
  __shared__ bool s_last;
  const int s = blockIdx.y, tid = threadIdx.x, lane = tid & 31;

  int st[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) st[j] = carry[6LL * s + j];
  const Gate g = slot_gate(st, phase[s], p);
  // The cheek ROI of the pre-update box (no clipping), and its part inside
  // the frame.
  const int bx1 = st[0], by1 = st[1], bx2 = st[2], by2 = st[3];
  const float bw = (float)(bx2 - bx1), bh = (float)(by2 - by1);
  const int rx1 = bx1 + (int)floorf(__fmul_rn(p.cheek_h, bw));
  const int rx2 = bx2 - (int)ceilf(__fmul_rn(p.cheek_h, bw));
  const int ry1 = by1 + (int)floorf(__fmul_rn(p.cheek_top, bh));
  const int ry2 = by1 + (int)floorf(__fmul_rn(p.cheek_bot, bh));
  const int cx1 = max(rx1, 0), cx2 = min(rx2, p.W);
  const int cy1 = max(ry1, 0), cy2 = min(ry2, p.H);

  const int strips = p.W / kTileCols;
  const int n_tiles = (p.H / kTileRows) * strips;
  const int first = blockIdx.x * kThreads;
  const int grp0 = first / strips;           // the block's first row group
  for (int i = tid; i < kBlockRows; i += kThreads) s_row[i] = 0;
  if (tid == 0) {
    s_fin[0] = p.W; s_fin[1] = -1; s_fin[2] = 0; s_fin[3] = p.H;
    s_fin[4] = -1;
  }
  __syncthreads();

  unsigned int roi_b = 0, roi_g = 0, roi_r = 0;
  const int tile = first + tid;
  if (tile < n_tiles) {
    const int grp = tile / strips, strip = tile - grp * strips;
    const int r0 = grp * kTileRows, x0 = strip * kTileCols;
    const bool scan = chunk_selected(g, r0 / p.rb, p);
    const bool in_roi = r0 < cy2 && r0 + kTileRows > cy1 && x0 < cx2 &&
                        x0 + kTileCols > cx1;
    if (scan || in_roi) {
      const long long row_bytes = 3LL * p.W;
      const uint8_t* src = frames + ((long long)s * p.H + r0) * row_bytes +
                           3LL * x0;
      constexpr float inv = 1.0f / (float)POOL;   // exact: a power of two
      // Rows are taken kStep at a time by a loop that stays rolled (the
      // pixel tests of one step fit the instruction cache); inside a step
      // every index is a constant.
      constexpr int kStep = POOL > kDepth ? POOL : kDepth;
      unsigned int once = 0, twice = 0;   // columns with >= 1, >= 2 cells
      uint32_t e[kRowWords], o[kRowWords];
      uint4 buf[kDepth][3];
#pragma unroll
      for (int d = 0; d < kDepth; ++d) load_row(src + d * row_bytes, buf[d]);
#pragma unroll 1
      for (int rs = 0; rs < kTileRows; rs += kStep) {
#pragma unroll
        for (int d = 0; d < kStep; ++d) {
          const int r = rs + d;
          const uint4(&v)[3] = buf[d % kDepth];
          const uint32_t w[kRowWords] = {v[0].x, v[0].y, v[0].z, v[0].w,
                                         v[1].x, v[1].y, v[1].z, v[1].w,
                                         v[2].x, v[2].y, v[2].z, v[2].w};
          if (r + kDepth < kTileRows)
            load_row(src + (r + kDepth) * row_bytes, buf[d % kDepth]);
          if (in_roi && r0 + r >= cy1 && r0 + r < cy2) {
#pragma unroll
            for (int j = 0; j < kTileCols; ++j) {
              if (x0 + j >= cx1 && x0 + j < cx2) {
                roi_b += (w[(3 * j) >> 2] >> (((3 * j) & 3) * 8)) & 0xffu;
                roi_g += (w[(3 * j + 1) >> 2] >> (((3 * j + 1) & 3) * 8)) &
                         0xffu;
                roi_r += (w[(3 * j + 2) >> 2] >> (((3 * j + 2) & 3) * 8)) &
                         0xffu;
              }
            }
          }
          if (scan) {
            if constexpr (POOL > 1) {
#pragma unroll
              for (int i = 0; i < kRowWords; ++i) {
                const uint32_t we = w[i] & 0x00ff00ffu;
                const uint32_t wo = (w[i] >> 8) & 0x00ff00ffu;
                e[i] = (d % POOL == 0) ? we : e[i] + we;
                o[i] = (d % POOL == 0) ? wo : o[i] + wo;
              }
            }
            if (d % POOL == POOL - 1) {
              unsigned int mask = 0;
#pragma unroll
              for (int j = 0; j < kTileCols; ++j) {
                float cb, cg, cr;
                if constexpr (POOL == 1) {
                  cb = byte_f32(w, 3 * j);
                  cg = byte_f32(w, 3 * j + 1);
                  cr = byte_f32(w, 3 * j + 2);
                } else {
                  cb = __fmul_rn(lane_f32(e, o, 3 * j), inv);
                  cg = __fmul_rn(lane_f32(e, o, 3 * j + 1), inv);
                  cr = __fmul_rn(lane_f32(e, o, 3 * j + 2), inv);
                }
                if (vhr::is_skin(cb, cg, cr, skin)) mask |= 1u << j;
              }
              if (mask) {
                atomicAdd(&s_row[(grp - grp0) * kUnits + r / POOL],
                          __popc(mask));
                twice |= once & mask;
                once |= mask;
              }
            }
          }
        }
      }
      // The tile's columns go to the slot's word for this strip: the low
      // half says which columns hold a cell, the high half which hold two.
      // A column that two tiles mark once is marked twice by the later one.
      if (once) {
        unsigned int* word = sc.colmask + (long long)s * strips + strip;
        if constexpr (POOL == 1) {
          const unsigned int old = atomicOr(word, once | (twice << 16));
          const unsigned int again = old & once & ~((old >> 16) | twice);
          if (again) atomicOr(word, again << 16);
        } else {
          atomicOr(word, once);
        }
      }
    }
  }

  // The block's ROI sums and pooled-row counts go to the slot's
  // accumulators.
  if (__any_sync(0xffffffffu, (roi_b | roi_g | roi_r) != 0u)) {
    roi_b = __reduce_add_sync(0xffffffffu, roi_b);
    roi_g = __reduce_add_sync(0xffffffffu, roi_g);
    roi_r = __reduce_add_sync(0xffffffffu, roi_r);
    if (lane == 0) {
      atomicAdd(sc.sums + 3LL * s, (unsigned long long)roi_b);
      atomicAdd(sc.sums + 3LL * s + 1, (unsigned long long)roi_g);
      atomicAdd(sc.sums + 3LL * s + 2, (unsigned long long)roi_r);
    }
  }
  __syncthreads();
  int32_t* rowsum = sc.rowsum + (long long)s * p.H;
  for (int i = tid; i < kBlockRows; i += kThreads) {
    const int v = s_row[i];
    if (v) atomicAdd(rowsum + grp0 * kUnits + i, v);
  }

  // The slot's last block to get here finishes the slot.  The barrier
  // orders the block's atomics before thread 0's fence, the fence before
  // its ticket.
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    s_last = atomicAdd(sc.done + s, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  if (g.do_detect) {  // uniform across the block
    unsigned int* colmask = sc.colmask + (long long)s * strips;
    int lmin = p.W, lmax = -1, cells = 0, rmin = p.H, rmax = -1;
    for (int i = tid; i < strips; i += kThreads) {
      const unsigned int v = __ldcg(colmask + i);
      if (v) {
        colmask[i] = 0u;
        // A column is occupied when its cells * POOL >= 2.
        const unsigned int occ = POOL == 1 ? v >> 16 : v & 0xffffu;
        if (occ) {
          lmin = min(lmin, i * kTileCols + __ffs(occ) - 1);
          lmax = max(lmax, i * kTileCols + 31 - __clz(occ));
        }
      }
    }
    for (int q = tid; q < p.H / POOL; q += kThreads) {
      const int v = __ldcg(rowsum + q);
      if (v) {
        rowsum[q] = 0;
        cells += v;
        if (v >= 2) {
          rmin = min(rmin, q * POOL);
          rmax = max(rmax, q * POOL + POOL - 1);
        }
      }
    }
    lmin = __reduce_min_sync(0xffffffffu, lmin);
    lmax = __reduce_max_sync(0xffffffffu, lmax);
    cells = __reduce_add_sync(0xffffffffu, cells);
    rmin = __reduce_min_sync(0xffffffffu, rmin);
    rmax = __reduce_max_sync(0xffffffffu, rmax);
    if (lane == 0) {
      atomicMin(&s_fin[0], lmin);
      atomicMax(&s_fin[1], lmax);
      atomicAdd(&s_fin[2], cells);
      atomicMin(&s_fin[3], rmin);
      atomicMax(&s_fin[4], rmax);
    }
  }
  __syncthreads();
  if (tid != 0) return;

  const bool has_prev = st[5] > 0;
  const bool det_ok = g.do_detect && (float)(s_fin[2] * POOL) >= p.min_area;
  const bool tracked = !g.do_detect && has_prev;
  const bool reuse_ok = g.do_detect && !det_ok && has_prev && st[4] > 0;
  const int nx1 = det_ok ? s_fin[0] : bx1, ny1 = det_ok ? s_fin[3] : by1;
  const int nx2 = det_ok ? s_fin[1] : bx2, ny2 = det_ok ? s_fin[4] : by2;
  const long long area = (long long)max(ry2 - ry1, 0) * max(rx2 - rx1, 0);
  const bool roi_ok = has_prev && area > 0;

  int32_t* b = boxes + 4LL * s;
  b[0] = nx1; b[1] = ny1; b[2] = nx2; b[3] = ny2;
  valid[s] = (det_ok || tracked) ? 1 : 0;
  valid[gridDim.y + s] = roi_ok ? 1 : 0;
  int32_t* co = carry_out + 6LL * s;
  co[0] = nx1; co[1] = ny1; co[2] = nx2; co[3] = ny2;
  co[4] = det_ok ? p.hold : (reuse_ok ? st[4] - 1 : st[4]);
  co[5] = (det_ok || has_prev) ? 1 : 0;
  const float n = (float)area;
  const float denom = fmaxf(n, 1.0f);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    unsigned long long* acc = sc.sums + 3LL * s + k;
    means[3LL * s + k] = (float)__ldcg(acc) / denom;
    *acc = 0ull;
  }
  count[s] = roi_ok ? n : 0.0f;
  sc.done[s] = 0;
}

}  // namespace

// frames: (S, H, W*3) u8, one frame per slot, 16-byte aligned; carry_in
// (S, 6) and phase (S,) int32.  scratch: S * (7 + W / 16 + H) int32, zero
// before the first launch and left zero by every launch.  Outputs: boxes
// (S, 4) int32; valid (2, S) u8 [det_valid, roi_valid], 0 or 1; means
// (S, 3) f32; count (S,) f32; carry_out (S, 6) int32.
extern "C" int vhr_fused_detect_roi_slots(
    const uint8_t* frames, int S, int H, int W, int rb, int pool,
    int detect_every, int gated, float gate_margin, int rescan_every,
    float min_area, float cb_min, float cb_max, float cr_min, float cr_max,
    float y_min, float cheek_h, float cheek_top, float cheek_bot, int hold,
    const int32_t* carry_in, const int32_t* phase, int32_t* carry_out,
    int32_t* scratch, int32_t* boxes, uint8_t* valid, float* means,
    float* count, cudaStream_t stream) {
  if (S < 1 || S > 65535 || H < kTileRows || H % kTileRows != 0 ||
      W < 128 || W % 128 != 0 || rb < kTileRows || rb % kTileRows != 0 ||
      rb > H || detect_every < 1 || rescan_every < 1 ||
      (reinterpret_cast<uintptr_t>(frames) & 15u) != 0 ||
      (reinterpret_cast<uintptr_t>(scratch) & 7u) != 0)
    return (int)cudaErrorInvalidValue;
  const SlotParams p{H, W, rb, detect_every, gated, rescan_every, hold,
                     gate_margin, min_area, cheek_h, cheek_top, cheek_bot};
  const vhr::SkinBox skin{cb_min, cb_max, cr_min, cr_max, y_min};
  Scratch sc;
  sc.sums = reinterpret_cast<unsigned long long*>(scratch);
  sc.done = scratch + 6LL * S;
  sc.colmask = reinterpret_cast<unsigned int*>(sc.done + S);
  sc.rowsum = sc.done + S + (long long)S * (W / kTileCols);
  const int n_tiles = (H / kTileRows) * (W / kTileCols);
  const dim3 grid((unsigned)((n_tiles + kThreads - 1) / kThreads),
                  (unsigned)S);
  switch (pool) {
#define VHR_K4_LAUNCH(P)                                                    \
  case P:                                                                   \
    slot_tick_kernel<P><<<grid, kThreads, 0, stream>>>(                     \
        frames, carry_in, phase, p, skin, sc, carry_out, boxes, valid,      \
        means, count);                                                      \
    break;
    VHR_K4_LAUNCH(1)
    VHR_K4_LAUNCH(2)
    VHR_K4_LAUNCH(4)
    VHR_K4_LAUNCH(8)
#undef VHR_K4_LAUNCH
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
