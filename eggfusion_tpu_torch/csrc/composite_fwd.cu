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
// Design: one block per (tile, sub-column), 32 x 32 = 1024 threads, one
// thread per pixel. A block sweeps only its own sub-column's slots
// s < min(count, cap / 4) — the TPU sweeps to the tile's deepest count but
// masks the extra slots to alpha 0, so the result is the same. Tiles dropped
// by tile_keep have count 0 and their blocks exit after writing the empty
// pixel (T = 1). Entries are staged through shared memory 16 slots at a time
// (one 64-byte row per slot, read once by the block, broadcast to all its
// threads).
//
// Bound on this card: operations. Each (pixel, entry) pair costs ~45 float
// operations (one exp, one division) against 64 bytes per entry shared by
// 1024 pixels, so the kernel sits far right of the memory roofline; the
// shared-memory broadcast keeps device memory traffic at one read per entry.
#include <cuda_runtime.h>

namespace {

constexpr int TILE_H = 32;
constexpr int TILE_W = 128;
constexpr int SUB_W = 32;
constexpr int N_SUB = 4;
constexpr int N_ATTR = 16;
constexpr int CHUNK = 16;
constexpr float MAX_ALPHA = 0.99f;
constexpr float ALPHA_EPS = 1.0f / 255.0f;
constexpr float NEAR_Z = 0.05f;

enum { A_U, A_V, A_CA, A_CB, A_CC, A_OP, A_R, A_G, A_B, A_NX, A_NY, A_NZ, A_PX, A_PY, A_PZ };

template <bool GEOM>
__global__ void __launch_bounds__(1024) composite_fwd_kernel(
    const int* __restrict__ counts, const float* __restrict__ intr,
    const float* __restrict__ entries, float* __restrict__ rgb, float* __restrict__ nrm,
    float* __restrict__ dep, float* __restrict__ opa, float* __restrict__ tfin,
    int tx_tiles, int cap, int hp, int wp) {
  __shared__ float ent[CHUNK][N_ATTR];
  const int t = blockIdx.x / N_SUB;
  const int c = blockIdx.x % N_SUB;
  const int tid = threadIdx.x;
  const int x = (t % tx_tiles) * TILE_W + c * SUB_W + tid % SUB_W;
  const int y = (t / tx_tiles) * TILE_H + tid / SUB_W;
  const float xs = (float)x, ys = (float)y;
  const float rx = (xs - intr[2]) / intr[0];
  const float ry = (ys - intr[3]) / intr[1];
  const int n = min(counts[t * N_SUB + c], cap / N_SUB);
  const float* tile = entries + (size_t)t * cap * N_ATTR;

  float T = 1.f, d = 0.f, o = 0.f;
  float r = 0.f, g = 0.f, b = 0.f, nx = 0.f, ny = 0.f, nz = 0.f;
  for (int s0 = 0; s0 < n; s0 += CHUNK) {
    const int m = min(CHUNK, n - s0);
    __syncthreads();  // the previous chunk is consumed
    if (tid < m * N_ATTR) {
      const int k = tid / N_ATTR, a = tid % N_ATTR;
      ent[k][a] = tile[((size_t)(s0 + k) * N_SUB + c) * N_ATTR + a];
    }
    __syncthreads();
    for (int k = 0; k < m; ++k) {
      const float* e = ent[k];
      const float dx = xs - e[A_U];
      const float dy = ys - e[A_V];
      const float power = -0.5f * (e[A_CA] * dx * dx + e[A_CC] * dy * dy) - e[A_CB] * dx * dy;
      const float raw = e[A_OP] * expf(power);
      float alpha = fminf(MAX_ALPHA, raw);
      alpha = alpha >= ALPHA_EPS ? alpha : 0.f;
      const float denom = rx * e[A_NX] + ry * e[A_NY] + e[A_NZ];
      const float pn = e[A_PX] * e[A_NX] + e[A_PY] * e[A_NY] + e[A_PZ] * e[A_NZ];
      const bool denom_ok = fabsf(denom) >= 1e-6f;
      const float z_plane = pn / (denom_ok ? denom : 1e-6f);
      const float z_px = (z_plane > NEAR_Z && denom_ok) ? z_plane : e[A_PZ];
      const float w = T * alpha;
      if (!GEOM) {
        r += w * e[A_R];
        g += w * e[A_G];
        b += w * e[A_B];
        nx += w * e[A_NX];
        ny += w * e[A_NY];
        nz += w * e[A_NZ];
      }
      d += w * z_px;
      o += w;
      T *= 1.f - alpha;
    }
  }
  const size_t px = (size_t)y * wp + x;
  const size_t plane = (size_t)hp * wp;
  if (!GEOM) {
    rgb[px] = r;
    rgb[plane + px] = g;
    rgb[2 * plane + px] = b;
    nrm[px] = nx;
    nrm[plane + px] = ny;
    nrm[2 * plane + px] = nz;
  }
  dep[px] = d;
  opa[px] = o;
  tfin[px] = T;
}

}  // namespace

extern "C" int egg_composite_fwd(const void* counts, const void* intr, const void* entries,
                                 void* rgb, void* nrm, void* dep, void* opa, void* tfin,
                                 int n_tiles, int tx_tiles, int cap, int geom, void* stream) {
  const int hp = (n_tiles / tx_tiles) * TILE_H;
  const int wp = tx_tiles * TILE_W;
  const dim3 grid(n_tiles * N_SUB), block(TILE_H * SUB_W);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto cnt = static_cast<const int*>(counts);
  auto in = static_cast<const float*>(intr);
  auto ent = static_cast<const float*>(entries);
  if (geom) {
    composite_fwd_kernel<true><<<grid, block, 0, st>>>(
        cnt, in, ent, nullptr, nullptr, static_cast<float*>(dep), static_cast<float*>(opa),
        static_cast<float*>(tfin), tx_tiles, cap, hp, wp);
  } else {
    composite_fwd_kernel<false><<<grid, block, 0, st>>>(
        cnt, in, ent, static_cast<float*>(rgb), static_cast<float*>(nrm),
        static_cast<float*>(dep), static_cast<float*>(opa), static_cast<float*>(tfin),
        tx_tiles, cap, hp, wp);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* egg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
