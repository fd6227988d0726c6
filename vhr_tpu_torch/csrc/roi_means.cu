// K2 and K3: per-frame ROI channel means of u8 frames, for Hopper (sm_90a).
//
// Replaces vhr_tpu/ops/pallas_roi.py::roi_channel_means_pallas (K2, body
// _roi_mean_kernel, pallas_call at :167) and
// roi_channel_means_pallas_batched (K3, body _roi_mean_batched_kernel,
// :324), which compute the same function.  Plain version:
// ops/reduce.py::roi_channel_means.
//
// Bound: device-memory bytes.  A frame is (H, W*C) u8 rows; the cheek ROI
// is a small rectangle of it (about 0.18 MB of a 6.2 MB frame at 1080p), so
// the least traffic is the ROI's own bytes, a few integer operations each.
// What holds such a kernel back is latency: at 3.35 TB/s and ~1 us a round
// trip the card needs some 3.3 MB of loads in flight, ~25 KB on each of
// the 132 SMs, at every frame count the paths launch (64 slots, a
// stream's 256-frame chunk, a 960-frame clip).
//
// Two instances, chosen on the host (ops/roi_means_cuda.py::roi_plan):
//
// Vectorised (frames, rows and base 16-byte aligned: every call of the
// paths).
// - A block is one (frame, band) pair.  A frame's clamped ROI rows are cut
//   into `bands` contiguous bands (at most 8), one block each.  The host
//   picks `bands` from T and the SM count alone
//   (ops/roi_means_cuda.py::plan_bands: every SM given a block, the
//   busiest SM's share of the frames least, with as few bands as that
//   allows: 4 at the pool's 64 slots, 1 at 256 and 960 frames); the rows
//   of a band follow from the ROI here, so the host never reads the ROIs.
//   The bands of a frame form a thread-block cluster: each block reduces
//   its sums in shared memory and stores them into rank 0's through
//   distributed shared memory; after a cluster barrier rank 0 adds them
//   and writes the means and the count.  No workspace, no second launch;
//   the sums are integers, so the order cannot change a bit.
// - A work item is a group of lcm(16, C) bytes aligned to the row's start:
//   48 bytes (16 pixels) for C = 3, 16 bytes for C = 1, 2 and 4.  So the
//   channel of every byte of a group is fixed at compile time, and channel
//   c's sum of a word is one __dp4a against a constant with 1 in c's bytes.
//   Only a row's first and last group are masked, by byte compares against
//   the ROI span; vectors wholly outside the span are not loaded.
// - The block's threads walk the band's (row, group) items in order,
//   neighbouring threads on neighbouring groups.  Each pass a thread issues
//   six independent 16-byte ld.global.nc loads (two groups of 48 bytes, or
//   six of 16) before it sums any of them: with 256 threads a block and
//   four blocks an SM that is ~96 KB in flight an SM.
//
// Generic (any other layout: a row pitch, frame stride or base that is not
// 16-byte aligned): the kernel K3 had before, unchanged but for roi_ok.
// One block takes 8 frames, 128 threads each, which walk the (row, 16-byte
// vector) pairs of the frame's ROI with loads aligned down to 16 bytes,
// each word masked per byte by the span and by the channel of its phase.
//
// Both: reads are clamped to the frame; `count` is the unclipped area; the
// mean is the float32 division (float)sum / max(count, 1), as in
// reduce.roi_channel_means (which reads no row twice, where the Pallas
// kernels count some rows twice for y1 < 0).  `roi_ok`, when not null,
// zeroes `count` where roi_ok[t * ok_stride] == 0 (K1 reuses this entry so
// for its ROI sums).  Rows are addressed through a row pitch and a frame
// stride, so padded rows need no copy.
//
// Probe builds (for timing what the cluster costs):
// -DROI_PROBE_NO_CLUSTER launches the vectorised instance without clusters
// and lets band 0 write its own partial sums only (not right);
// -DROI_PROBE_ATOMICS combines the bands without clusters, by 64-bit
// atomics into a zeroed global array of 4096 frames that the last band to
// finish reads and zeroes again (right for T <= 4096 on one stream);
// -DROI_PROBE_L2_256B asks each load to prefetch 256 bytes into L2 (right).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxC = 4;
constexpr int kMaxBands = 8;             // a portable cluster
constexpr int kThreads = 256;            // vectorised: threads a block
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 6;                // 16-byte loads a thread a pass
constexpr int kGenFrames = 8;            // generic: frames a block
constexpr int kGenThreads = 4 * 32;      // generic: threads a frame

// A work item of the vectorised instance: lcm(16, C) bytes.
template <int C>
struct Group {
  static constexpr int kBytes = C == 3 ? 48 : 16;
  static constexpr int kVecs = kBytes / 16;
  static constexpr int kWords = kBytes / 4;
  static constexpr int kUnroll = kLoads / kVecs;     // groups a pass
};

// 1 in the bytes of word j of a group (byte offsets 4j .. 4j+3 from a
// multiple of C) that hold channel c, else 0: __dp4a's second operand.
template <int C>
__host__ __device__ constexpr uint32_t chan_sel(int j, int c) {
  uint32_t m = 0u;
  for (int b = 0; b < 4; ++b)
    if ((4 * j + b) % C == c) m |= 1u << (8 * b);
  return m;
}

// A 16-byte load through the read-only path.
__device__ __forceinline__ uint4 load16(const uint4* p) {
#ifdef ROI_PROBE_L2_256B
  uint4 v;
  asm("ld.global.nc.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
#else
  return __ldg(p);
#endif
}

// Sums of the warp's threads, then of the block's warps, in 64 bits:
// valid in thread c < C.
template <int C, int Warps>
__device__ __forceinline__ unsigned long long block_sum(
    const unsigned int (&acc)[C], unsigned long long (*part)[C], int c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    unsigned long long v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) part[warp][k] = v;
  }
  __syncthreads();
  unsigned long long s = 0ull;
  if (c < C) {
#pragma unroll
    for (int w = 0; w < Warps; ++w) s += part[w][c];
  }
  return s;
}

__device__ __forceinline__ void write_result(
    unsigned long long s, int c, int C, long long t, int x1, int y1, int x2,
    int y2, const int32_t* __restrict__ roi_ok, int ok_stride,
    float* __restrict__ means, float* __restrict__ count) {
  const long long area = max((long long)y2 - y1, 0ll)
                         * max((long long)x2 - x1, 0ll);
  const float n = (float)area;
  means[t * C + c] = (float)s / fmaxf(n, 1.0f);
  if (c == 0)
    count[t] = (roi_ok == nullptr || roi_ok[t * ok_stride] != 0) ? n : 0.0f;
}

#ifdef ROI_PROBE_ATOMICS
__device__ unsigned long long g_probe_sums[4096][kMaxC];
__device__ unsigned int g_probe_done[4096];
#endif

template <int C>
__global__ void __launch_bounds__(kThreads, 4)
roi_means_vec_kernel(const uint8_t* __restrict__ frames,
                     long long frame_stride, long long row_pitch,
                     const int32_t* __restrict__ rois,
                     const int32_t* __restrict__ roi_ok, int ok_stride,
                     float* __restrict__ means, float* __restrict__ count,
                     int H, int W, int bands) {
  using G = Group<C>;
  __shared__ unsigned long long part[kWarps][C];
  __shared__ unsigned long long bsum[kMaxBands][C];   // rank 0's
  const int tid = threadIdx.x;
  const long long t = blockIdx.x / bands;
  const int band = (int)(blockIdx.x - t * bands);    // the cluster rank
  const int x1 = rois[4 * t], y1 = rois[4 * t + 1];
  const int x2 = rois[4 * t + 2], y2 = rois[4 * t + 3];
  const int cx1 = max(x1, 0), cx2 = min(x2, W);
  const int cy1 = max(y1, 0), cy2 = min(y2, H);

#if !defined(ROI_PROBE_NO_CLUSTER) && !defined(ROI_PROBE_ATOMICS)
  // Half a cluster barrier now, the other half before the first store
  // into rank 0's shared memory: every block of the cluster has started.
  if (bands > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n");
#endif

  unsigned int acc[C];
#pragma unroll
  for (int k = 0; k < C; ++k) acc[k] = 0u;
  if (cx2 > cx1 && cy2 > cy1) {
    const int n = cy2 - cy1;
    const int r0 = cy1 + (int)((long long)n * band / bands);
    const int r1 = cy1 + (int)((long long)n * (band + 1) / bands);
    // The span's bytes [b0, b1) of a row, its groups [g0, g0 + ng); lo and
    // hi are b0 and b1 from the start of group g0.
    const int b0 = cx1 * C, b1 = cx2 * C;
    const int g0 = b0 / G::kBytes;
    const int ng = (b1 + G::kBytes - 1) / G::kBytes - g0;
    const int lo = b0 - g0 * G::kBytes, hi = b1 - g0 * G::kBytes;
    const int items = (r1 - r0) * ng;
    // Item i is (row r0 + i / ng, group g0 + i % ng); a thread's next item
    // is kThreads further, dr rows and dg groups on.
    const int dr = kThreads / ng, dg = kThreads - dr * ng;
    int r = tid / ng, g = tid - r * ng;
    const uint8_t* base = frames + t * frame_stride + (long long)r0 * row_pitch
                          + (long long)g0 * G::kBytes;
    for (int it = tid; it < items; it += G::kUnroll * kThreads) {
      uint4 v[G::kUnroll][G::kVecs];
      int off[G::kUnroll];
      // All loads of the pass first ...
#pragma unroll
      for (int u = 0; u < G::kUnroll; ++u) {
        const bool in = it + u * kThreads < items;
        off[u] = g * G::kBytes;
        const uint4* p = reinterpret_cast<const uint4*>(
            base + (long long)r * row_pitch + off[u]);
#pragma unroll
        for (int k = 0; k < G::kVecs; ++k) {
          const int o = off[u] + 16 * k;
          v[u][k] = (in && o < hi && o + 16 > lo) ? load16(p + k)
                                                  : make_uint4(0, 0, 0, 0);
        }
        r += dr;
        g += dg;
        if (g >= ng) {
          g -= ng;
          ++r;
        }
      }
      // ... then the sums.
#pragma unroll
      for (int u = 0; u < G::kUnroll; ++u) {
        uint32_t w[G::kWords];
#pragma unroll
        for (int k = 0; k < G::kVecs; ++k) {
          w[4 * k] = v[u][k].x;
          w[4 * k + 1] = v[u][k].y;
          w[4 * k + 2] = v[u][k].z;
          w[4 * k + 3] = v[u][k].w;
        }
        const int a = lo - off[u], e = hi - off[u];
        if (a > 0 || e < G::kBytes) {          // a row's first or last group
          const uint32_t a4 = (uint32_t)max(a, 0) * 0x01010101u;
          const uint32_t e4 = (uint32_t)min(max(e, 0), G::kBytes)
                              * 0x01010101u;
#pragma unroll
          for (int j = 0; j < G::kWords; ++j) {
            const uint32_t idx = 0x03020100u + (uint32_t)j * 0x04040404u;
            w[j] &= __vcmpgeu4(idx, a4) & __vcmpltu4(idx, e4);
          }
        }
#pragma unroll
        for (int j = 0; j < G::kWords; ++j) {
#pragma unroll
          for (int c = 0; c < C; ++c)
            acc[c] = __dp4a(w[j], chan_sel<C>(j, c), acc[c]);
        }
      }
    }
  }

  unsigned long long s = block_sum<C, kWarps>(acc, part, tid);
  bool writes = band == 0;
#if defined(ROI_PROBE_ATOMICS)
  if (bands > 1) {
    // The alternative combine: 64-bit atomics into a zeroed global array,
    // and the band that finishes last writes the result and zeroes it.
    __shared__ bool last;
    if (tid < C) atomicAdd(&g_probe_sums[t][tid], s);
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(&g_probe_done[t], 1u) == bands - 1;
    __syncthreads();
    writes = last;
    if (last && tid < C) s = atomicExch(&g_probe_sums[t][tid], 0ull);
    if (last && tid == 0) g_probe_done[t] = 0u;
  }
#elif !defined(ROI_PROBE_NO_CLUSTER)
  if (bands > 1) {
    // Each band stores its sums into rank 0's shared memory; after one
    // cluster barrier (release, acquire) rank 0 adds them, and no block
    // reads another's shared memory, so the others may exit.
    cg::cluster_group cluster = cg::this_cluster();
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    if (tid < C) *cluster.map_shared_rank(&bsum[band][tid], 0) = s;
    cluster.sync();
    if (band == 0 && tid < C) {
      for (int b = 1; b < bands; ++b) s += bsum[b][tid];
    }
  }
#endif
  if (writes && tid < C)
    write_result(s, tid, C, t, x1, y1, x2, y2, roi_ok, ok_stride, means,
                 count);
}

// Word j of a 16-byte vector with 0xFF in the bytes k = 4j+b whose
// k % C == q, else 0.
template <int C>
__device__ __forceinline__ uint32_t phase_word(int q, int j) {
  uint32_t m = 0u;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if ((4 * j + b) % C == q) m |= 0xFFu << (8 * b);
  return m;
}

template <int C>
__global__ void __launch_bounds__(kGenFrames * kGenThreads)
roi_means_generic_kernel(const uint8_t* __restrict__ frames,
                         long long frame_stride, long long row_pitch,
                         const int32_t* __restrict__ rois,
                         const int32_t* __restrict__ roi_ok, int ok_stride,
                         float* __restrict__ means, float* __restrict__ count,
                         int T, int H, int W) {
  __shared__ unsigned long long sums[kGenFrames][C];
  const int f = threadIdx.y;
  const int tid = threadIdx.x;
  const long long t = (long long)blockIdx.x * kGenFrames + f;
  if (tid < C) sums[f][tid] = 0ull;
  __syncthreads();

  unsigned int acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0u;
  int x1 = 0, y1 = 0, x2 = 0, y2 = 0;
  if (t < T) {                              // the ragged batch's tail idles
    x1 = rois[4 * t];
    y1 = rois[4 * t + 1];
    x2 = rois[4 * t + 2];
    y2 = rois[4 * t + 3];
  }
  const int cx1 = max(x1, 0), cx2 = min(x2, W);
  const int cy1 = max(y1, 0), cy2 = min(y2, H);
  if (t < T && cx2 > cx1 && cy2 > cy1) {
    const uint8_t* base = frames + t * frame_stride;
    const long long b0 = (long long)cx1 * C, b1 = (long long)cx2 * C;
    // 16-byte vectors per row: the most a span of b1-b0 bytes can touch at
    // any alignment; the one past a row's end is skipped.
    const int nv = (int)((b1 - b0 + 15) / 16) + 1;
    const int items = (cy2 - cy1) * nv;
    const int dr = kGenThreads / nv, dv = kGenThreads % nv;
    int r = tid / nv, v = tid % nv;
    for (int it = tid; it < items; it += kGenThreads) {
      const uint8_t* row = base + (long long)(cy1 + r) * row_pitch;
      const uintptr_t lo_addr = reinterpret_cast<uintptr_t>(row + b0);
      const uintptr_t hi_addr = reinterpret_cast<uintptr_t>(row + b1);
      const uintptr_t a = (lo_addr & ~(uintptr_t)15) + 16u * (uintptr_t)v;
      if (a < hi_addr) {
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(a));
        const long long rel = (long long)a - (long long)lo_addr;
        const uint32_t lo4 = (uint32_t)(rel < 0 ? -rel : 0) * 0x01010101u;
        const long long left = (long long)hi_addr - (long long)a;
        const uint32_t hi4 = (uint32_t)(left < 16 ? left : 16) * 0x01010101u;
        // Channel of the vector's first byte: its offset in the row mod C.
        int ph = (int)((rel + b0) % C);
        if (ph < 0) ph += C;
        const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t idx = 0x03020100u + (uint32_t)j * 0x04040404u;
          const uint32_t x = words[j] & __vcmpgeu4(idx, lo4)
                             & __vcmpltu4(idx, hi4);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            // Byte k holds channel (ph + k) % C: channel c's bytes are
            // those with k % C == (c - ph) mod C.
            const int q = (c - ph + C) % C;
            uint32_t m = phase_word<C>(0, j);
#pragma unroll
            for (int p = 1; p < C; ++p)
              m = q == p ? phase_word<C>(p, j) : m;
            acc[c] = __dp4a(x & m, 0x01010101u, acc[c]);
          }
        }
      }
      r += dr;
      v += dv;
      if (v >= nv) {
        v -= nv;
        ++r;
      }
    }
  }

#pragma unroll
  for (int c = 0; c < C; ++c) {
    unsigned long long s = acc[c];
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if ((tid & 31) == 0 && s != 0ull) atomicAdd(&sums[f][c], s);
  }
  __syncthreads();
  if (t < T && tid < C)
    write_result(sums[f][tid], tid, C, t, x1, y1, x2, y2, roi_ok, ok_stride,
                 means, count);
}

// The instances, as ops/roi_means_cuda.py::roi_plan numbers them.
enum Instance { kVector = 0, kGeneric = 1 };

struct Args {
  const uint8_t* frames;
  long long frame_stride, row_pitch;
  const int32_t* rois;
  const int32_t* roi_ok;
  int ok_stride;
  float* means;
  float* count;
  int T, H, W;
};

template <int C>
cudaError_t launch(const Args& a, int instance, int bands, int grid,
                   cudaStream_t stream) {
  if (instance == kGeneric) {
    roi_means_generic_kernel<C><<<grid, dim3(kGenThreads, kGenFrames), 0,
                                  stream>>>(
        a.frames, a.frame_stride, a.row_pitch, a.rois, a.roi_ok, a.ok_stride,
        a.means, a.count, a.T, a.H, a.W);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = bands;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
#if defined(ROI_PROBE_NO_CLUSTER) || defined(ROI_PROBE_ATOMICS)
  cfg.numAttrs = 0;
#else
  cfg.numAttrs = bands > 1 ? 1 : 0;
#endif
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, roi_means_vec_kernel<C>, a.frames, a.frame_stride, a.row_pitch,
      a.rois, a.roi_ok, a.ok_stride, a.means, a.count, a.H, a.W, bands);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Refuses a plan the kernels were not built for (roi_plan gives the same).
int roi_means(const Args& a, int C, int instance, int bands, int threads,
              int grid, cudaStream_t stream) {
  if (C < 1 || C > kMaxC || a.T < 0) return (int)cudaErrorInvalidValue;
  if (instance == kVector) {
    const bool aligned = reinterpret_cast<uintptr_t>(a.frames) % 16 == 0
                         && a.frame_stride % 16 == 0 && a.row_pitch % 16 == 0;
    if (!aligned || bands < 1 || bands > kMaxBands || threads != kThreads
        || (long long)grid != (long long)a.T * bands)
      return (int)cudaErrorInvalidValue;
  } else if (instance == kGeneric) {
    if (bands != 1 || threads != kGenThreads * kGenFrames
        || grid != (a.T + kGenFrames - 1) / kGenFrames)
      return (int)cudaErrorInvalidValue;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (a.T == 0) return (int)cudaGetLastError();
  switch (C) {
    case 1: return (int)launch<1>(a, instance, bands, grid, stream);
    case 2: return (int)launch<2>(a, instance, bands, grid, stream);
    case 3: return (int)launch<3>(a, instance, bands, grid, stream);
    default: return (int)launch<4>(a, instance, bands, grid, stream);
  }
}

}  // namespace

// K2: contiguous (T, H, W*C) frames; K1's third launch too.
extern "C" int vhr_roi_means_u8(const uint8_t* frames, const int32_t* rois,
                                const int32_t* roi_ok, int ok_stride,
                                float* means, float* count,
                                int T, int H, int W, int C, int instance,
                                int bands, int threads, int grid,
                                cudaStream_t stream) {
  const long long pitch = (long long)W * C;
  const Args a{frames, pitch * H, pitch, rois, roi_ok, ok_stride, means,
               count, T, H, W};
  return roi_means(a, C, instance, bands, threads, grid, stream);
}

// K3: rows through a row pitch and frames through a frame stride, in bytes.
extern "C" int vhr_roi_means_batched_u8(const uint8_t* frames,
                                        long long frame_stride,
                                        long long row_pitch,
                                        const int32_t* rois, float* means,
                                        float* count, int T, int H, int W,
                                        int C, int instance, int bands,
                                        int threads, int grid,
                                        cudaStream_t stream) {
  const Args a{frames, frame_stride, row_pitch, rois, nullptr, 0, means,
               count, T, H, W};
  return roi_means(a, C, instance, bands, threads, grid, stream);
}
