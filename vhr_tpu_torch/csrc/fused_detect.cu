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
// (pooled) pixel.
//
// Design.  On the TPU the frames run in order on one core and the tracking
// state rides in SMEM from one grid step to the next.  On Hopper the frames
// need not run in order: the state serialises only the ROI box, the gate
// band and the holdover budget, while the skin test of a row chunk depends
// on its pixels alone.  So the work is split in three launches:
//
//   1. skin_chunks_kernel, one block per (frame, row chunk), parallel over
//      the whole clip.  Chunks use K1's geometry (rb rows, the last chunk's
//      start clamped to H - rb, rows below the unclamped origin skipped).
//      For each chunk it writes the per-column count of skin cells and the
//      chunk's cell count and first/last row holding >= 2 skin cells.
//      Frames that do not detect (cadence) are skipped.
//   1b. frame_extent_kernel, one block per frame: the same summed over all
//      chunks (occupied x extent, cell count, row extent), which is the
//      answer whenever the whole frame is scanned.
//   2. track_kernel, ONE block walking the frames in order.  Each thread
//      holds the same copy of the 6-int state in registers.  A detection
//      frame whose gate band covers every chunk takes its pass-1b result
//      (five loads, fetched one frame ahead).  Otherwise the block sums the
//      column counts of the chunks inside the band and reduces the occupied
//      x extent (one __syncthreads, with a double-buffered reduction
//      array).  Then it applies K1's state update.  It
//      writes boxes, flags and the frame's ROI (from the pre-update box,
//      floor/ceil in float32, no clipping).
//   3. vhr_roi_means_u8 (K2, roi_means.cu) on those ROIs, with count set to
//      0 where the ROI is not valid, launched as the host's plan for it
//      says (ops/roi_means_cuda.py::roi_plan).
//
// The chroma test and the chunk pass are in skin_chunk.cuh, shared with K4
// (fused_slots.cu).

#include "skin_chunk.cuh"

extern "C" int vhr_roi_means_u8(const uint8_t* frames, const int32_t* rois,
                                const int32_t* roi_ok, int ok_stride,
                                float* means, float* count,
                                int T, int H, int W, int C, int instance,
                                int bands, int threads, int grid,
                                cudaStream_t stream);

namespace {

using vhr::SkinBox;

constexpr int kSkinThreads = 256;
constexpr int kTrackThreads = 512;

__device__ __forceinline__ bool detects(int phase, int detect_every,
                                        int seq_len) {
  return phase % detect_every == 0 || (seq_len > 0 && phase % seq_len == 0);
}

// Pass 1: one block per (frame, chunk); blockIdx.x = t * n_chunks + chunk.
// colcnt: (t_len, n_chunks, W) skin cells per column.
// stats:  (t_len, n_chunks, 3) [cells, rmin, rmax] (rmin = H, rmax = -1
//         when no pooled row holds >= 2 skin cells).
__global__ void __launch_bounds__(kSkinThreads)
skin_chunks_kernel(const uint8_t* __restrict__ frames, int phase0, int H,
                   int W, int rb, int n_chunks, int pool, int detect_every,
                   int seq_len, SkinBox skin,
                   int32_t* __restrict__ colcnt, int32_t* __restrict__ stats) {
  const long long t = blockIdx.x / n_chunks;
  const int chunk = blockIdx.x - (int)t * n_chunks;
  if (!detects(phase0 + (int)t, detect_every, seq_len)) return;
  const long long cell = t * n_chunks + chunk;
  vhr::skin_chunk(frames + t * H * 3LL * W, chunk, H, W, rb, pool, skin,
                  colcnt + cell * W, stats + cell * 3);
}

// Pass 1b: one block per detection frame sums pass 1 over ALL chunks, the
// chunk selection of every ungated detection and of every full rescan.
// full: (t_len, 5) [xmin, xmax, cells, rmin, rmax].
__global__ void __launch_bounds__(kSkinThreads)
frame_extent_kernel(const int32_t* __restrict__ colcnt,
                    const int32_t* __restrict__ stats, int phase0, int H,
                    int W, int n_chunks, int pool, int detect_every,
                    int seq_len, int32_t* __restrict__ full) {
  const long long t = blockIdx.x;
  if (!detects(phase0 + (int)t, detect_every, seq_len)) return;
  __shared__ int s_min, s_max;
  if (threadIdx.x == 0) { s_min = W; s_max = -1; }
  __syncthreads();
  const int32_t* cc = colcnt + t * n_chunks * W;
  int lmin = W, lmax = -1;
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    int s = 0;
    for (int c = 0; c < n_chunks; ++c) s += cc[(long long)c * W + w];
    if (s * pool >= 2) { lmin = min(lmin, w); lmax = max(lmax, w); }
  }
  lmin = __reduce_min_sync(0xffffffffu, lmin);
  lmax = __reduce_max_sync(0xffffffffu, lmax);
  if ((threadIdx.x & 31) == 0) {
    atomicMin(&s_min, lmin);
    atomicMax(&s_max, lmax);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int cells = 0, rmin = H, rmax = -1;
    for (int c = 0; c < n_chunks; ++c) {
      const int32_t* cs = stats + (t * n_chunks + c) * 3;
      cells += cs[0];
      rmin = min(rmin, cs[1]);
      rmax = max(rmax, cs[2]);
    }
    int32_t* f = full + 5 * t;
    f[0] = s_min; f[1] = s_max; f[2] = cells; f[3] = rmin; f[4] = rmax;
  }
}

struct TrackParams {
  int t_len, phase0, H, W, rb, n_chunks, pool, detect_every, seq_len;
  int gated, rescan_every, hold;
  float gate_margin, min_area, cheek_h, cheek_top, cheek_bot;
};

// Pass 2: one block walks the launch's frames in order.
__global__ void __launch_bounds__(kTrackThreads)
track_kernel(const int32_t* __restrict__ colcnt,
             const int32_t* __restrict__ stats,
             const int32_t* __restrict__ full,
             const int32_t* __restrict__ carry_in,
             int32_t* __restrict__ carry_out, int32_t* __restrict__ rois,
             int32_t* __restrict__ boxes, int32_t* __restrict__ flags,
             TrackParams p) {
  __shared__ int red_min[2][kTrackThreads / 32];
  __shared__ int red_max[2][kTrackThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  int st[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) st[j] = carry_in[j];
  int n_detect = 0;
  // Pass-1b results of frame t, loaded one frame ahead: they do not depend
  // on the state, so their latency hides behind the previous frame.
  int nf[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) nf[j] = p.t_len > 0 ? full[j] : 0;

  for (int t = 0; t < p.t_len; ++t) {
    int f[5];
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      f[j] = nf[j];
      nf[j] = t + 1 < p.t_len ? full[5LL * (t + 1) + j] : 0;
    }
    const int phase = p.phase0 + t;
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

    int xmin = p.W, xmax = -1, cells = 0, rmin = p.H, rmax = -1;
    if (do_detect && gy1 < p.rb && gy2 > p.H - p.rb) {
      // Every chunk is in the band (chunk starts run from 0 to H - rb).
      xmin = f[0]; xmax = f[1]; cells = f[2]; rmin = f[3]; rmax = f[4];
    } else if (do_detect) {  // uniform across the block
      const long long base = (long long)t * p.n_chunks;
      int lmin = p.W, lmax = -1;
      for (int w = tid; w < p.W; w += blockDim.x) {
        int s = 0;
        for (int c = 0; c < p.n_chunks; ++c) {
          const int start = min(c * p.rb, p.H - p.rb);
          if (start < gy2 && start + p.rb > gy1)
            s += colcnt[(base + c) * p.W + w];
        }
        if (s * p.pool >= 2) { lmin = min(lmin, w); lmax = max(lmax, w); }
      }
      lmin = __reduce_min_sync(0xffffffffu, lmin);
      lmax = __reduce_max_sync(0xffffffffu, lmax);
      // Alternate buffers between successive detection frames: a thread
      // can only rewrite a buffer after the next __syncthreads, which every
      // thread reaches after reading it.
      const int buf = n_detect++ & 1;
      if (lane == 0) { red_min[buf][warp] = lmin; red_max[buf][warp] = lmax; }
      __syncthreads();
      for (int i = 0; i < n_warps; ++i) {
        xmin = min(xmin, red_min[buf][i]);
        xmax = max(xmax, red_max[buf][i]);
      }
      for (int c = 0; c < p.n_chunks; ++c) {
        const int start = min(c * p.rb, p.H - p.rb);
        if (start < gy2 && start + p.rb > gy1) {
          const int32_t* cs = stats + (base + c) * 3;
          cells += cs[0];
          rmin = min(rmin, cs[1]);
          rmax = max(rmax, cs[2]);
        }
      }
    }

    const bool det_ok = do_detect && (float)(cells * p.pool) >= p.min_area;
    const bool tracked = !do_detect && has_prev;
    const bool reuse_ok = do_detect && !det_ok && has_prev && st[4] > 0;
    const int nx1 = det_ok ? xmin : bx1, ny1 = det_ok ? rmin : by1;
    const int nx2 = det_ok ? xmax : bx2, ny2 = det_ok ? rmax : by2;
    const long long area = (long long)max(ry2 - ry1, 0) * max(rx2 - rx1, 0);
    const bool roi_ok = has_prev && area > 0;
    if (tid == 0) {
      int32_t* b = boxes + 4LL * t;
      b[0] = nx1; b[1] = ny1; b[2] = nx2; b[3] = ny2;
      int32_t* r = rois + 4LL * t;
      r[0] = rx1; r[1] = ry1; r[2] = rx2; r[3] = ry2;
      flags[2LL * t] = (det_ok || tracked) ? 1 : 0;
      flags[2LL * t + 1] = roi_ok ? 1 : 0;
    }
    st[0] = nx1; st[1] = ny1; st[2] = nx2; st[3] = ny2;
    st[4] = det_ok ? p.hold : (reuse_ok ? st[4] - 1 : st[4]);
    st[5] = (det_ok || has_prev) ? 1 : 0;
  }
  if (tid == 0) {
#pragma unroll
    for (int j = 0; j < 6; ++j) carry_out[j] = st[j];
  }
}

}  // namespace

// frames: (T, H, W*3) u8, launch covers frames [t_start, t_start + t_len).
// Scratch colcnt (t_len, n_chunks, W), stats (t_len, n_chunks, 3) and full
// (t_len, 5) int32.
// Outputs: rois, boxes (t_len, 4) int32; flags (t_len, 2) int32
// [det_valid, roi_valid]; means (t_len, 3) f32; count (t_len,) f32;
// carry_out (6,) int32.  roi_instance, roi_bands, roi_threads and roi_grid
// are K2's launch plan for the t_len frames.
extern "C" int vhr_fused_detect_roi(
    const uint8_t* frames, int t_start, int t_len, int phase0, int H, int W,
    int rb, int n_chunks, int pool, int detect_every, int seq_len, int gated,
    float gate_margin, int rescan_every, float min_area, float cb_min,
    float cb_max, float cr_min, float cr_max, float y_min, float cheek_h,
    float cheek_top, float cheek_bot, int hold, int roi_instance,
    int roi_bands, int roi_threads, int roi_grid, const int32_t* carry_in,
    int32_t* carry_out, int32_t* colcnt, int32_t* stats, int32_t* full,
    int32_t* rois,
    int32_t* boxes, int32_t* flags, float* means, float* count,
    cudaStream_t stream) {
  if (pool < 1 || rb % pool != 0 || detect_every < 1 || rescan_every < 1)
    return (int)cudaErrorInvalidValue;
  const uint8_t* first = frames + (long long)t_start * H * W * 3;
  if (t_len > 0) {
    const SkinBox skin{cb_min, cb_max, cr_min, cr_max, y_min};
    const size_t smem = sizeof(int) * (size_t)(rb / pool);
    skin_chunks_kernel<<<(unsigned)(t_len * n_chunks), kSkinThreads, smem,
                         stream>>>(first, phase0, H, W, rb, n_chunks, pool,
                                   detect_every, seq_len, skin, colcnt, stats);
    int err = (int)cudaGetLastError();
    if (err != 0) return err;
    frame_extent_kernel<<<t_len, kSkinThreads, 0, stream>>>(
        colcnt, stats, phase0, H, W, n_chunks, pool, detect_every, seq_len,
        full);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const TrackParams tp{t_len, phase0, H, W, rb, n_chunks, pool, detect_every,
                       seq_len, gated, rescan_every, hold, gate_margin,
                       min_area, cheek_h, cheek_top, cheek_bot};
  track_kernel<<<1, kTrackThreads, 0, stream>>>(colcnt, stats, full, carry_in,
                                                carry_out, rois, boxes, flags,
                                                tp);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return vhr_roi_means_u8(first, rois, flags + 1, 2, means, count, t_len, H,
                          W, 3, roi_instance, roi_bands, roi_threads,
                          roi_grid, stream);
}
