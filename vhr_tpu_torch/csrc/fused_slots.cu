// K4: skin-chroma face detection + holdover tracking + cheek-ROI means for
// S independent serving slots, one frame each, for Hopper (sm_90a).
//
// Replaces vhr_tpu/ops/pallas_fused.py::fused_detect_roi_slots (body
// _kernel with per_slot=True).  Plain version:
// ops/fused_cuda.py::fused_detect_roi_slots_plain.  Per slot the outputs
// equal K1's at t_len=1 with phase = phase[s]: boxes, flags, carry and ROI
// counts exactly, means as exact integer sums divided in float32.
//
// Bound: device-memory bytes.  A serving tick reads each slot's frame once
// in full for the skin test (H x W*3 u8, 2.8 MB at 720p, 177 MB for 64
// slots) plus the cheek-ROI rows once more for the channel sums.
//
// Design.  On the TPU the slots run in order on one core, each grid step
// seeding the SMEM tracking state from its own carry row.  Here the slots
// are independent, and everything a slot's skin pass needs (its cadence
// phase and its gate band) is known from its carry row before the launch.
// So nothing runs in order:
//
//   1. slot_skin_kernel, one block per (slot, row chunk), with K1's chunk
//      pass (skin_chunk.cuh).  A block reads phase[s] and carry[s] from
//      device memory and returns at once when the slot is off its detection
//      cadence or the chunk is outside the slot's gate band.
//   2. slot_finish_kernel, one block per slot: sums the column counts of
//      the selected chunks into the occupied x extent, and their cell
//      counts and row extents; applies the holdover update; writes boxes,
//      flags, the carry row and the ROI of the pre-update box (floor/ceil in
//      float32, no clipping).
//   3. vhr_roi_means_u8 (K2, roi_means.cu) on those ROIs, with count set to
//      0 where the ROI is not valid.
//
// All three launch on the caller's stream; the host waits for nothing.

#include "skin_chunk.cuh"

extern "C" int vhr_roi_means_u8(const uint8_t* frames, const int32_t* rois,
                                const int32_t* roi_ok, int ok_stride,
                                float* means, float* count,
                                int T, int H, int W, int C,
                                cudaStream_t stream);

namespace {

constexpr int kSkinThreads = 256;
constexpr int kFinishThreads = 256;

struct SlotParams {
  int H, W, rb, n_chunks, pool, detect_every, gated, rescan_every, hold;
  float gate_margin, min_area, cheek_h, cheek_top, cheek_bot;
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

// Pass 1: blockIdx.x = s * n_chunks + chunk.
// colcnt: (S, n_chunks, W) skin cells per column; stats: (S, n_chunks, 3)
// [cells, rmin, rmax].  Entries of unselected chunks are left unwritten.
__global__ void __launch_bounds__(kSkinThreads)
slot_skin_kernel(const uint8_t* __restrict__ frames,
                 const int32_t* __restrict__ carry,
                 const int32_t* __restrict__ phase, SlotParams p,
                 vhr::SkinBox skin, int32_t* __restrict__ colcnt,
                 int32_t* __restrict__ stats) {
  const int s = blockIdx.x / p.n_chunks;
  const int chunk = blockIdx.x - s * p.n_chunks;
  if (!chunk_selected(slot_gate(carry + 6LL * s, phase[s], p), chunk, p))
    return;
  const long long cell = (long long)s * p.n_chunks + chunk;
  vhr::skin_chunk(frames + (long long)s * p.H * 3LL * p.W, chunk, p.H, p.W,
                  p.rb, p.pool, skin, colcnt + cell * p.W, stats + cell * 3);
}

// Pass 2: one block per slot.
__global__ void __launch_bounds__(kFinishThreads)
slot_finish_kernel(const int32_t* __restrict__ colcnt,
                   const int32_t* __restrict__ stats,
                   const int32_t* __restrict__ carry,
                   const int32_t* __restrict__ phase, SlotParams p,
                   int32_t* __restrict__ carry_out,
                   int32_t* __restrict__ rois, int32_t* __restrict__ boxes,
                   int32_t* __restrict__ flags) {
  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  int st[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) st[j] = carry[6LL * s + j];
  const Gate g = slot_gate(st, phase[s], p);
  const long long base = (long long)s * p.n_chunks;

  __shared__ int s_min, s_max;
  if (tid == 0) { s_min = p.W; s_max = -1; }
  __syncthreads();
  if (g.do_detect) {  // uniform across the block
    int lmin = p.W, lmax = -1;
    for (int w = tid; w < p.W; w += blockDim.x) {
      int sum = 0;
      for (int c = 0; c < p.n_chunks; ++c)
        if (chunk_selected(g, c, p)) sum += colcnt[(base + c) * p.W + w];
      if (sum * p.pool >= 2) { lmin = min(lmin, w); lmax = max(lmax, w); }
    }
    lmin = __reduce_min_sync(0xffffffffu, lmin);
    lmax = __reduce_max_sync(0xffffffffu, lmax);
    if ((tid & 31) == 0) {
      atomicMin(&s_min, lmin);
      atomicMax(&s_max, lmax);
    }
  }
  __syncthreads();
  if (tid != 0) return;

  int cells = 0, rmin = p.H, rmax = -1;
  for (int c = 0; c < p.n_chunks; ++c) {
    if (chunk_selected(g, c, p)) {
      const int32_t* cs = stats + (base + c) * 3;
      cells += cs[0];
      rmin = min(rmin, cs[1]);
      rmax = max(rmax, cs[2]);
    }
  }
  const int bx1 = st[0], by1 = st[1], bx2 = st[2], by2 = st[3];
  const bool has_prev = st[5] > 0;
  const float bw = (float)(bx2 - bx1), bh = (float)(by2 - by1);
  const int rx1 = bx1 + (int)floorf(__fmul_rn(p.cheek_h, bw));
  const int rx2 = bx2 - (int)ceilf(__fmul_rn(p.cheek_h, bw));
  const int ry1 = by1 + (int)floorf(__fmul_rn(p.cheek_top, bh));
  const int ry2 = by1 + (int)floorf(__fmul_rn(p.cheek_bot, bh));

  const bool det_ok = g.do_detect && (float)(cells * p.pool) >= p.min_area;
  const bool tracked = !g.do_detect && has_prev;
  const bool reuse_ok = g.do_detect && !det_ok && has_prev && st[4] > 0;
  const int nx1 = det_ok ? s_min : bx1, ny1 = det_ok ? rmin : by1;
  const int nx2 = det_ok ? s_max : bx2, ny2 = det_ok ? rmax : by2;
  const long long area = (long long)max(ry2 - ry1, 0) * max(rx2 - rx1, 0);

  int32_t* b = boxes + 4LL * s;
  b[0] = nx1; b[1] = ny1; b[2] = nx2; b[3] = ny2;
  int32_t* r = rois + 4LL * s;
  r[0] = rx1; r[1] = ry1; r[2] = rx2; r[3] = ry2;
  flags[2LL * s] = (det_ok || tracked) ? 1 : 0;
  flags[2LL * s + 1] = (has_prev && area > 0) ? 1 : 0;
  int32_t* co = carry_out + 6LL * s;
  co[0] = nx1; co[1] = ny1; co[2] = nx2; co[3] = ny2;
  co[4] = det_ok ? p.hold : (reuse_ok ? st[4] - 1 : st[4]);
  co[5] = (det_ok || has_prev) ? 1 : 0;
}

}  // namespace

// frames: (S, H, W*3) u8, one frame per slot; carry_in (S, 6) and phase
// (S,) int32.  Scratch colcnt (S, n_chunks, W) and stats (S, n_chunks, 3)
// int32.  Outputs: rois, boxes (S, 4) int32; flags (S, 2) int32
// [det_valid, roi_valid]; means (S, 3) f32; count (S,) f32; carry_out
// (S, 6) int32.
extern "C" int vhr_fused_detect_roi_slots(
    const uint8_t* frames, int S, int H, int W, int rb, int n_chunks,
    int pool, int detect_every, int gated, float gate_margin,
    int rescan_every, float min_area, float cb_min, float cb_max,
    float cr_min, float cr_max, float y_min, float cheek_h, float cheek_top,
    float cheek_bot, int hold, const int32_t* carry_in, const int32_t* phase,
    int32_t* carry_out, int32_t* colcnt, int32_t* stats, int32_t* rois,
    int32_t* boxes, int32_t* flags, float* means, float* count,
    cudaStream_t stream) {
  if (pool < 1 || rb % pool != 0 || detect_every < 1 || rescan_every < 1 ||
      rb > H)
    return (int)cudaErrorInvalidValue;
  if (S < 1) return (int)cudaErrorInvalidValue;
  const SlotParams p{H, W, rb, n_chunks, pool, detect_every, gated,
                     rescan_every, hold, gate_margin, min_area, cheek_h,
                     cheek_top, cheek_bot};
  const vhr::SkinBox skin{cb_min, cb_max, cr_min, cr_max, y_min};
  const size_t smem = sizeof(int) * (size_t)(rb / pool);
  slot_skin_kernel<<<(unsigned)(S * n_chunks), kSkinThreads, smem, stream>>>(
      frames, carry_in, phase, p, skin, colcnt, stats);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  slot_finish_kernel<<<S, kFinishThreads, 0, stream>>>(
      colcnt, stats, carry_in, phase, p, carry_out, rois, boxes, flags);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  return vhr_roi_means_u8(frames, rois, flags + 1, 2, means, count, S, H, W,
                          3, stream);
}
