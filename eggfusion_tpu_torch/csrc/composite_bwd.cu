// Backward surfel compositor for Hopper (sm_90a).
//
// Replaces the TPU kernel of eggfusion_tpu/ops/raster_pallas.py:
//   _make_bwd_kernel, run by _make_composite (the bwd pallas_call), the
//   custom VJP of the forward compositor (composite_fwd.cu).
// It computes the same VJP: given the cotangents of rgb, normal, depth,
// opacity and final transmittance, the 15 per-entry gradients (u, v, conic
// a/b/c, opacity, rgb, normal incl. the depth-plane terms, p_cam xyz) summed
// over the pixels of the entry's sub-column, written to d_entries
// (n_tiles, cap, 16). Rows no sub-column reaches stay zero, as does column
// 15 (the caller allocates d_entries zeroed).
//
// Algorithm, per pixel, as the TPU kernel's:
//   phase 1 re-sweeps the alphas and keeps T at the start of every 16-slot
//           chunk (at most cap/4/16 = 32 floats per thread at cap 2048);
//   phase 2 walks the chunks in reverse with ONE suffix image B seeded with
//           g_T * T_fin: per entry, galpha = T_k A_k - B / (1 - a_k), then
//           B += w_k A_k, with A_k = sum_c g_c c_k. T_k inside a chunk is
//           recomputed forward from the chunk checkpoint, so there is no
//           division-by-(1 - alpha) rollback. galpha is 0 where alpha is 0 or
//           the raw alpha is >= 0.99.
//
// Design: the forward's grid, one block per (tile, sub-column), 1024 threads,
// one per pixel. Each entry's 15 gradients are summed over the block's 1024
// pixels without atomics, in a fixed order — a warp shuffle tree, then the 32
// warp partials summed in warp order from shared memory — so the kernel is
// deterministic. Partials of a whole chunk are kept ([32 warps][16][15] in
// shared memory) so a chunk costs two block barriers, not two per entry.
//
// Bound on this card: operations — ~120 float operations per (pixel, entry)
// pair plus the 15-value reductions, against one 64-byte entry read per
// block pass. The kernel re-reads each entry twice (phase 1 and phase 2)
// instead of storing per-entry state, trading a second cheap sweep for no
// device-memory scratch.
#include <cuda_runtime.h>

namespace {

constexpr int TILE_H = 32;
constexpr int TILE_W = 128;
constexpr int SUB_W = 32;
constexpr int N_SUB = 4;
constexpr int N_ATTR = 16;
constexpr int N_GRAD = 15;
constexpr int CHUNK = 16;
constexpr int MAX_CHUNKS = 32;  // cap <= 2048
constexpr int N_WARPS = 32;
constexpr float MAX_ALPHA = 0.99f;
constexpr float ALPHA_EPS = 1.0f / 255.0f;
constexpr float NEAR_Z = 0.05f;

enum { A_U, A_V, A_CA, A_CB, A_CC, A_OP, A_R, A_G, A_B, A_NX, A_NY, A_NZ, A_PX, A_PY, A_PZ };

__device__ __forceinline__ float entry_alpha(const float* e, float xs, float ys, float* raw_out,
                                             float* dx_out, float* dy_out) {
  const float dx = xs - e[A_U];
  const float dy = ys - e[A_V];
  const float power = -0.5f * (e[A_CA] * dx * dx + e[A_CC] * dy * dy) - e[A_CB] * dx * dy;
  const float raw = e[A_OP] * expf(power);
  const float alpha = fminf(MAX_ALPHA, raw);
  *raw_out = raw;
  *dx_out = dx;
  *dy_out = dy;
  return alpha >= ALPHA_EPS ? alpha : 0.f;
}

__device__ __forceinline__ void load_chunk(float (*ent)[N_ATTR], const float* tile, int s0, int m,
                                           int c, int tid) {
  if (tid < m * N_ATTR) {
    const int k = tid / N_ATTR, a = tid % N_ATTR;
    ent[k][a] = tile[((size_t)(s0 + k) * N_SUB + c) * N_ATTR + a];
  }
}

__global__ void __launch_bounds__(1024) composite_bwd_kernel(
    const int* __restrict__ counts, const float* __restrict__ intr,
    const float* __restrict__ entries, const float* __restrict__ g_rgb,
    const float* __restrict__ g_nrm, const float* __restrict__ g_dep,
    const float* __restrict__ g_opa, const float* __restrict__ g_T,
    const float* __restrict__ T_fin, float* __restrict__ d_entries, int tx_tiles, int cap,
    int hp, int wp) {
  __shared__ float ent[CHUNK][N_ATTR];
  __shared__ float part[N_WARPS][CHUNK][N_GRAD];
  const int t = blockIdx.x / N_SUB;
  const int c = blockIdx.x % N_SUB;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int x = (t % tx_tiles) * TILE_W + c * SUB_W + tid % SUB_W;
  const int y = (t / tx_tiles) * TILE_H + tid / SUB_W;
  const float xs = (float)x, ys = (float)y;
  const float rx = (xs - intr[2]) / intr[0];
  const float ry = (ys - intr[3]) / intr[1];
  const int n = min(counts[t * N_SUB + c], cap / N_SUB);
  if (n == 0) return;  // uniform over the block
  const float* tile = entries + (size_t)t * cap * N_ATTR;
  float* dtile = d_entries + (size_t)t * cap * N_ATTR;
  const int n_chunks = (n + CHUNK - 1) / CHUNK;

  // ---- phase 1: alpha-only re-sweep, T at every chunk start ----
  float ckpt[MAX_CHUNKS];
  float T = 1.f;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int s0 = ci * CHUNK, m = min(CHUNK, n - s0);
    ckpt[ci] = T;
    __syncthreads();
    load_chunk(ent, tile, s0, m, c, tid);
    __syncthreads();
    for (int k = 0; k < m; ++k) {
      float raw, dx, dy;
      T *= 1.f - entry_alpha(ent[k], xs, ys, &raw, &dx, &dy);
    }
  }

  const size_t px = (size_t)y * wp + x;
  const size_t plane = (size_t)hp * wp;
  const float gr = g_rgb[px], gg = g_rgb[plane + px], gb = g_rgb[2 * plane + px];
  const float gnx = g_nrm[px], gny = g_nrm[plane + px], gnz = g_nrm[2 * plane + px];
  const float gd = g_dep[px], go = g_opa[px];
  // suffix init: the g_T cotangent enters every galpha as -g_T T_fin / (1 - a)
  float B = g_T[px] * T_fin[px];

  // ---- phase 2: reverse chunk walk ----
  for (int ci = n_chunks - 1; ci >= 0; --ci) {
    const int s0 = ci * CHUNK, m = min(CHUNK, n - s0);
    __syncthreads();  // previous chunk's partials are reduced
    load_chunk(ent, tile, s0, m, c, tid);
    __syncthreads();
    float Tk[CHUNK];
    float Tc = ckpt[ci];
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      Tk[k] = Tc;
      if (k < m) {
        float raw, dx, dy;
        Tc *= 1.f - entry_alpha(ent[k], xs, ys, &raw, &dx, &dy);
      }
    }
#pragma unroll
    for (int k = CHUNK - 1; k >= 0; --k) {
      if (k >= m) continue;
      const float* e = ent[k];
      float raw, dx, dy;
      const float alpha = entry_alpha(e, xs, ys, &raw, &dx, &dy);
      const float w = Tk[k] * alpha;
      const float denom = rx * e[A_NX] + ry * e[A_NY] + e[A_NZ];
      const float pn = e[A_PX] * e[A_NX] + e[A_PY] * e[A_NY] + e[A_PZ] * e[A_NZ];
      const bool denom_ok = fabsf(denom) >= 1e-6f;
      const float denom_safe = denom_ok ? denom : 1e-6f;
      const float z_plane = pn / denom_safe;
      const bool use_plane = z_plane > NEAR_Z && denom_ok;
      const float z_px = use_plane ? z_plane : e[A_PZ];

      const float A = gr * e[A_R] + gg * e[A_G] + gb * e[A_B] + gnx * e[A_NX] + gny * e[A_NY] +
                      gnz * e[A_NZ] + go + gd * z_px;
      const bool live = alpha > 0.f && raw < MAX_ALPHA;
      const float galpha = live ? Tk[k] * A - B * (1.f / (1.f - alpha)) : 0.f;
      const float expp = live ? raw / fmaxf(e[A_OP], 1e-12f) : 0.f;
      const float gP = galpha * alpha;
      const float gz = gd * w;
      const float rden = use_plane ? 1.f / denom_safe : 0.f;
      const float g_pn = gz * rden;
      const float g_den = -g_pn * pn * rden;
      const float gz_fb = use_plane ? 0.f : gz;

      float v[N_GRAD] = {
          gP * (e[A_CA] * dx + e[A_CB] * dy),            // u
          gP * (e[A_CB] * dx + e[A_CC] * dy),            // v
          gP * (-0.5f * dx * dx),                        // conic a
          gP * (-dx * dy),                               // conic b
          gP * (-0.5f * dy * dy),                        // conic c
          galpha * expp,                                 // opacity
          gr * w,                                        // r
          gg * w,                                        // g
          gb * w,                                        // b
          gnx * w + g_pn * e[A_PX] + g_den * rx,         // nx
          gny * w + g_pn * e[A_PY] + g_den * ry,         // ny
          gnz * w + g_pn * e[A_PZ] + g_den,              // nz
          g_pn * e[A_NX],                                // px
          g_pn * e[A_NY],                                // py
          g_pn * e[A_NZ] + gz_fb,                        // pz
      };
#pragma unroll
      for (int j = 0; j < N_GRAD; ++j) {
        float s = v[j];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
        if (lane == 0) part[warp][k][j] = s;
      }
      B += w * A;
    }
    __syncthreads();
    if (tid < m * N_GRAD) {
      const int k = tid / N_GRAD, j = tid % N_GRAD;
      float s = 0.f;
      for (int w = 0; w < N_WARPS; ++w) s += part[w][k][j];
      dtile[((size_t)(s0 + k) * N_SUB + c) * N_ATTR + j] = s;
    }
  }
}

}  // namespace

extern "C" int egg_composite_bwd(const void* counts, const void* intr, const void* entries,
                                 const void* g_rgb, const void* g_nrm, const void* g_dep,
                                 const void* g_opa, const void* g_T, const void* T_fin,
                                 void* d_entries, int n_tiles, int tx_tiles, int cap,
                                 void* stream) {
  if (cap / N_SUB > MAX_CHUNKS * CHUNK) return static_cast<int>(cudaErrorInvalidValue);
  const int hp = (n_tiles / tx_tiles) * TILE_H;
  const int wp = tx_tiles * TILE_W;
  composite_bwd_kernel<<<dim3(n_tiles * N_SUB), dim3(TILE_H * SUB_W), 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(counts), static_cast<const float*>(intr),
      static_cast<const float*>(entries), static_cast<const float*>(g_rgb),
      static_cast<const float*>(g_nrm), static_cast<const float*>(g_dep),
      static_cast<const float*>(g_opa), static_cast<const float*>(g_T),
      static_cast<const float*>(T_fin), static_cast<float*>(d_entries), tx_tiles, cap, hp, wp);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* egg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
