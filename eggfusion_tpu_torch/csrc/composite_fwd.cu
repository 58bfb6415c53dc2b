// Forward surfel compositor for Hopper (sm_90a): full and geometry-only.
//
// Replaces the TPU kernels of eggfusion_tpu/ops/raster_pallas.py:
//   _make_fwd_kernel(geom=False), run by _make_composite (the fwd pallas_call)
//   _make_fwd_kernel(geom=True),  run by _make_geom_composite
// and computes what they compute: per pixel, a front-to-back sweep of its
// 32-px sub-column's depth-sorted entry list,
//   alpha = min(0.99, op * exp(-(a dx^2 + c dy^2)/2 - b dx dy)), 0 below 1/255,
//   w = T * alpha;  accumulate w * (rgb, normal, z_px) and w;  T *= 1 - alpha,
// with z_px the pixel ray's intersection with the surfel plane (p_z when the
// plane is unusable), exactly as _group_zpx.
//
// Layout: entries (n_tiles, cap, 16) f32, row = slot * 4 + sub-column; counts
// (n_tiles, 4) i32; intr (4,) f32 on the device; outputs are the padded
// (hp, wp) images, rgb / nrm channel-first (3, hp, wp).
//
// Design: one block per (tile, sub-column) sweeps only its own slots
// s < min(count, cap / 4) — the TPU sweeps to the tile's deepest count but
// masks the extra slots to alpha 0, so the result is the same. 512 threads,
// each owning two vertically adjacent pixels, so that two blocks fit on an
// SM and each staged entry is read once for two pixels. Entries are staged
// asynchronously (composite_common.cuh): up to 512 slots at once, 32-slot
// chunks each behind its own mbarrier, with the per-entry constants (p.n,
// the cull interval) computed once per entry. Each warp (two pixel rows)
// takes the chunk's cull intervals in one ballot and visits only the entries
// that can touch its rows; a skipped pair has alpha 0, so the sums and T are
// what the full sweep gives. Within a visited entry, a warp whose 64 pixels
// all have alpha 0 skips the depth and accumulation. There is no
// transmittance early exit: the sweep runs to the count, as the TPU's
// EXIT_MODE "count".
//
// Bound on this card: operations. Each visited (pixel, entry) pair costs its
// alpha (one exp), a live pair ~25 more float operations; the entry bytes are
// read once per block. The cull removes most visited pairs that are dead.
#include "composite_common.cuh"

namespace {

using namespace egg;

constexpr int ROWS = 2;                     // pixel rows per thread
constexpr int THREADS = TILE_H * SUB_W / ROWS;
constexpr int N_WARPS = THREADS / 32;
static_assert(N_WARPS >= MAX_CH, "one staging warp per chunk of a window");

template <bool GEOM>
__global__ void __launch_bounds__(THREADS, 2) composite_fwd_kernel(
    const int* __restrict__ counts, const float* __restrict__ intr,
    const float* __restrict__ entries, float* __restrict__ rgb, float* __restrict__ nrm,
    float* __restrict__ dep, float* __restrict__ opa, float* __restrict__ tfin,
    int tx_tiles, int cap, int hp, int wp, int aligned) {
  extern __shared__ float4 smem_f4[];
  Prep* st = reinterpret_cast<Prep*>(smem_f4);
  __shared__ uint64_t bar[MAX_CH];
  const int t = blockIdx.x / N_SUB;
  const int c = blockIdx.x % N_SUB;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int x0 = (t % tx_tiles) * TILE_W + c * SUB_W;
  const int x = x0 + tid % SUB_W;
  const int y = (t / tx_tiles) * TILE_H + warp * ROWS;
  const float xs = (float)x;
  const float rx = (xs - intr[2]) / intr[0];
  float ys[ROWS], ry[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    ys[i] = (float)(y + i);
    ry[i] = (ys[i] - intr[3]) / intr[1];
  }
  const int n = min(counts[t * N_SUB + c], cap / N_SUB);
  const float* tile = entries + (size_t)t * cap * N_ATTR;

  float T[ROWS], d[ROWS], o[ROWS], r[ROWS], g[ROWS], b[ROWS], nx[ROWS], ny[ROWS], nz[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    T[i] = 1.f;
    d[i] = o[i] = r[i] = g[i] = b[i] = nx[i] = ny[i] = nz[i] = 0.f;
  }
  if (n > 0) {  // uniform over the block
    if (tid < MAX_CH) mbar_init(&bar[tid], 32);
    __syncthreads();
    for (int w0 = 0, win = 0; w0 < n; w0 += MAX_STAGE, ++win) {
      const int nw = min(MAX_STAGE, n - w0);
      const int n_ch = (nw + CH - 1) / CH;
      if (win > 0) __syncthreads();  // the previous window is consumed
      if (warp < n_ch)
        stage_chunk(st + warp * CH, nullptr, tile, w0 + warp * CH, n, c, (float)x0, aligned, &bar[warp]);
      for (int ci = 0; ci < n_ch; ++ci) {
        mbar_wait(&bar[ci], win & 1);
        unsigned mask = keep_mask(st, ci * CH, ys[0], ys[ROWS - 1]);
        while (mask) {
          const int k = __ffs(mask) - 1;
          mask &= mask - 1;
          const Prep& e = st[ci * CH + k];
          const float4 q0 = e.q0, q1 = e.q1;
          const float dx = xs - q0.x;
          float alpha[ROWS];
          bool any = false;
#pragma unroll
          for (int i = 0; i < ROWS; ++i) {
            float raw;
            alpha[i] = pixel_alpha(q1, dx, ys[i] - q0.y, &raw);
            any |= alpha[i] > 0.f;
          }
          if (!__any_sync(FULL, any)) continue;  // alpha 0 on all 64 pixels: nothing changes
          const float4 q2 = e.q2, q3 = e.q3;
#pragma unroll
          for (int i = 0; i < ROWS; ++i) {
            float den;
            bool use_plane;
            const float z_px = plane_depth(q2, q3, rx, ry[i], &den, &use_plane);
            const float w = T[i] * alpha[i];
            if (!GEOM) {
              r[i] += w * q2.x;
              g[i] += w * q2.y;
              b[i] += w * q2.z;
              nx[i] += w * q3.x;
              ny[i] += w * q3.y;
              nz[i] += w * q3.z;
            }
            d[i] += w * z_px;
            o[i] += w;
            T[i] *= 1.f - alpha[i];
          }
        }
      }
    }
  }
  const size_t plane = (size_t)hp * wp;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const size_t px = (size_t)(y + i) * wp + x;
    if (!GEOM) {
      rgb[px] = r[i];
      rgb[plane + px] = g[i];
      rgb[2 * plane + px] = b[i];
      nrm[px] = nx[i];
      nrm[plane + px] = ny[i];
      nrm[2 * plane + px] = nz[i];
    }
    dep[px] = d[i];
    opa[px] = o[i];
    tfin[px] = T[i];
  }
}

// whole chunks: the staging warp writes all 32 slots of its chunk
size_t smem_bytes(int cap) {
  const int slots = (cap / N_SUB + CH - 1) / CH * CH;
  return (size_t)(slots < MAX_STAGE ? slots : MAX_STAGE) * sizeof(Prep);
}

}  // namespace

extern "C" int egg_composite_fwd(const void* counts, const void* intr, const void* entries,
                                 void* rgb, void* nrm, void* dep, void* opa, void* tfin,
                                 int n_tiles, int tx_tiles, int cap, int geom, void* stream) {
  const int hp = (n_tiles / tx_tiles) * TILE_H;
  const int wp = tx_tiles * TILE_W;
  const dim3 grid(n_tiles * N_SUB), block(THREADS);
  const size_t smem = smem_bytes(cap);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto cnt = static_cast<const int*>(counts);
  auto in = static_cast<const float*>(intr);
  auto ent = static_cast<const float*>(entries);
  const int aligned = (reinterpret_cast<uintptr_t>(entries) % 16) == 0;
  if (geom) {
    composite_fwd_kernel<true><<<grid, block, smem, st>>>(
        cnt, in, ent, nullptr, nullptr, static_cast<float*>(dep), static_cast<float*>(opa),
        static_cast<float*>(tfin), tx_tiles, cap, hp, wp, aligned);
  } else {
    composite_fwd_kernel<false><<<grid, block, smem, st>>>(
        cnt, in, ent, static_cast<float*>(rgb), static_cast<float*>(nrm),
        static_cast<float*>(dep), static_cast<float*>(opa), static_cast<float*>(tfin),
        tx_tiles, cap, hp, wp, aligned);
  }
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of the kernel at `cap` (0 when the query fails).
extern "C" int egg_composite_fwd_blocks_per_sm(int cap, int geom) {
  int blocks = 0;
  const cudaError_t err =
      geom ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, composite_fwd_kernel<true>,
                                                           THREADS, smem_bytes(cap))
           : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, composite_fwd_kernel<false>,
                                                           THREADS, smem_bytes(cap));
  return err == cudaSuccess ? blocks : 0;
}

extern "C" const char* egg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
