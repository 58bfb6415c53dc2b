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
//   phase 1 re-sweeps the alphas and keeps T at the start of every 32-slot
//           chunk;
//   phase 2 walks the chunks in reverse with ONE suffix image B seeded with
//           g_T * T_fin: per entry, galpha = T_k A_k - B / (1 - a_k), then
//           B += w_k A_k, with A_k = sum_c g_c c_k. galpha is 0 where alpha
//           is 0 or the raw alpha is >= 0.99. Inside a chunk T_k is rolled
//           back from the exact checkpoint that ends the chunk,
//           T_k = T_{k+1} / (1 - a_k), with 1 - a_k >= 0.01: at most 32
//           steps of relative rounding, as the forward recompute it
//           replaces, and one alpha evaluation per phase.
//
// Design: one block per (tile, sub-column), 1024 threads, one per pixel (a
// warp is a pixel row). The whole sub-column (<= 512 slots at cap 2048, 36
// KB) is staged once, asynchronously, with the per-entry constants and cull
// intervals (composite_common.cuh); both phases read it from shared memory.
// The transmittance checkpoints live in shared memory ([chunk][pixel]).
// In phase 1 a warp visits only the entries whose cull interval covers its
// row (skipped pairs have alpha 0, so T is unchanged) and records, per chunk,
// the entries with a nonzero alpha on its row; phase 2 visits only those
// (on the others every gradient term is 0, T_k = T_{k+1} and B is
// unchanged). A live warp-entry sums its 15 gradients (padded to 16)
// over the warp with one recursive-halving transpose reduction: 8 + 4 + 2 +
// 1 + 1 = 16 shuffles, after which lanes 2j and 2j+1 hold the warp's sum of
// gradient j. Each warp writes its partials of a chunk and a bit per live
// entry; after one block barrier the chunk's per-entry sums add the live
// warps' partials in warp order. Partials are double-buffered, so phase 2
// costs one block barrier per chunk. No atomics: two launches give the same
// bits.
//
// Bound on this card: operations — one alpha per kept pair (two where its
// warp-entry is live), ~76 more float operations per live pair, against one
// 64-byte entry read per block.
#include "composite_common.cuh"

namespace {

using namespace egg;

constexpr int N_GRAD = 15;
constexpr int PIXELS = TILE_H * SUB_W;
constexpr int THREADS = PIXELS;  // one pixel per thread
constexpr int N_WARPS = THREADS / 32;
constexpr int MAX_BWD_SLOTS = MAX_STAGE;  // cap <= 2048
static_assert(N_WARPS >= MAX_CH, "one staging warp per chunk");

// shared memory, for n_ch chunks: staged entries [slot], their (p_x, p_y)
// [slot], checkpoints [chunk][pixel], partials [buffer][warp][slot][15],
// the live bits of the partials [buffer][warp], and phase 1's live
// warp-entries [chunk][warp]: 227584 bytes at cap 2048.
struct Smem {
  __host__ __device__ static size_t pxy_off(int n_ch) { return (size_t)n_ch * CH * sizeof(Prep); }
  __host__ __device__ static size_t ckpt_off(int n_ch) {
    return pxy_off(n_ch) + (size_t)n_ch * CH * sizeof(float2);
  }
  __host__ __device__ static size_t part_off(int n_ch) {
    return ckpt_off(n_ch) + (size_t)n_ch * PIXELS * sizeof(float);
  }
  __host__ __device__ static size_t live_off(int n_ch) {
    return part_off(n_ch) + (size_t)2 * N_WARPS * CH * N_GRAD * sizeof(float);
  }
  __host__ __device__ static size_t wlive_off(int n_ch) {
    return live_off(n_ch) + 2 * N_WARPS * sizeof(unsigned);
  }
  __host__ __device__ static size_t bytes(int n_ch) {
    return wlive_off(n_ch) + (size_t)n_ch * N_WARPS * sizeof(unsigned);
  }
};

// One level of the transpose reduction: lanes with bit 2*HALF set keep the
// upper HALF values and send the lower ones, the others the reverse; the
// kept value gains its partner lane's copy. A template, so that every index
// of `v` is a constant and `v` stays in registers.
template <int HALF>
__device__ __forceinline__ void halve(float (&v)[16], int lane) {
  const bool upper = lane & (2 * HALF);
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = upper ? v[i] : v[i + HALF];
    const float keep = upper ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, 2 * HALF);
  }
}

// Sum v[0..15] over the warp: afterwards lanes 2j and 2j+1 both hold the sum
// of v[j] (recursive halving, 8 + 4 + 2 + 1 + 1 = 16 shuffles, a fixed order).
__device__ __forceinline__ float warp_transpose_sum(float (&v)[16], int lane) {
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
  return v[0] + __shfl_xor_sync(FULL, v[0], 1);
}

__global__ void __launch_bounds__(THREADS, 1) composite_bwd_kernel(
    const int* __restrict__ counts, const float* __restrict__ intr,
    const float* __restrict__ entries, const float* __restrict__ g_rgb,
    const float* __restrict__ g_nrm, const float* __restrict__ g_dep,
    const float* __restrict__ g_opa, const float* __restrict__ g_T,
    const float* __restrict__ T_fin, float* __restrict__ d_entries, int tx_tiles, int cap,
    int hp, int wp, int aligned) {
  extern __shared__ float4 smem_f4[];
  __shared__ uint64_t bar[MAX_CH];
  const int t = blockIdx.x / N_SUB;
  const int c = blockIdx.x % N_SUB;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int x0 = (t % tx_tiles) * TILE_W + c * SUB_W;
  const int x = x0 + lane;
  const int y = (t / tx_tiles) * TILE_H + warp;
  const float xs = (float)x, ys = (float)y;
  const float rx = (xs - intr[2]) / intr[0];
  const float ry = (ys - intr[3]) / intr[1];
  const int n = min(counts[t * N_SUB + c], cap / N_SUB);
  if (n == 0) return;  // uniform over the block
  const int n_ch = (n + CH - 1) / CH;
  char* base = reinterpret_cast<char*>(smem_f4);
  const Prep* st = reinterpret_cast<const Prep*>(base);
  float2* pxy = reinterpret_cast<float2*>(base + Smem::pxy_off(n_ch));
  float* ckpt = reinterpret_cast<float*>(base + Smem::ckpt_off(n_ch));
  float* part = reinterpret_cast<float*>(base + Smem::part_off(n_ch));
  unsigned* live_bits = reinterpret_cast<unsigned*>(base + Smem::live_off(n_ch));
  unsigned* warp_live = reinterpret_cast<unsigned*>(base + Smem::wlive_off(n_ch));
  const float* tile = entries + (size_t)t * cap * N_ATTR;
  float* dtile = d_entries + (size_t)t * cap * N_ATTR;

  if (tid < MAX_CH) mbar_init(&bar[tid], 32);
  __syncthreads();
  if (warp < n_ch)
    stage_chunk(reinterpret_cast<Prep*>(base) + warp * CH, pxy + warp * CH, tile, warp * CH, n, c,
                (float)x0, aligned, &bar[warp]);

  // ---- phase 1: alpha-only re-sweep, T at every chunk start ----
  float T = 1.f;
  for (int ci = 0; ci < n_ch; ++ci) {
    ckpt[ci * PIXELS + tid] = T;
    mbar_wait(&bar[ci], 0);
    unsigned mask = keep_mask(st, ci * CH, ys, ys);
    unsigned live = 0;
    while (mask) {
      const int k = __ffs(mask) - 1;
      mask &= mask - 1;
      const Prep& e = st[ci * CH + k];
      float raw;
      const float alpha = pixel_alpha(e.q1, xs - e.q0.x, ys - e.q0.y, &raw);
      T *= 1.f - alpha;
      if (__any_sync(FULL, alpha > 0.f)) live |= 1u << k;
    }
    if (lane == 0) warp_live[ci * N_WARPS + warp] = live;
  }

  const size_t plane = (size_t)hp * wp;
  const size_t px = (size_t)y * wp + x;
  const float gr = g_rgb[px], gg = g_rgb[plane + px], gb = g_rgb[2 * plane + px];
  const float gnx = g_nrm[px], gny = g_nrm[plane + px], gnz = g_nrm[2 * plane + px];
  const float gd = g_dep[px], go = g_opa[px];
  // suffix init: the g_T cotangent enters every galpha as -g_T T_fin / (1 - a)
  float B = g_T[px] * T_fin[px];

  // ---- phase 2: reverse chunk walk ----
  for (int ci = n_ch - 1; ci >= 0; --ci) {
    const int buf = ci & 1;
    float* wpart = part + ((size_t)(buf * N_WARPS + warp) * CH) * N_GRAD;
    float Tc = ci + 1 < n_ch ? ckpt[(ci + 1) * PIXELS + tid] : T;  // T after the chunk
    // only the warp-entries with a nonzero alpha on this row: on the others
    // every gradient term is 0 and T_k = T_{k+1}
    unsigned mask = warp_live[ci * N_WARPS + warp];
    const unsigned live = mask;
    while (mask) {
      const int k = 31 - __clz(mask);
      mask ^= 1u << k;
      const Prep& e = st[ci * CH + k];
      const float4 q0 = e.q0, q1 = e.q1, q2 = e.q2, q3 = e.q3;
      const float2 pp = pxy[ci * CH + k];
      const float dx = xs - q0.x, dy = ys - q0.y;
      float raw;
      const float alpha = pixel_alpha(q1, dx, dy, &raw);
      const float inv = 1.f / (1.f - alpha);
      const float Tk = Tc * inv;
      Tc = Tk;
      float den;
      bool use_plane;
      const float z_px = plane_depth(q2, q3, rx, ry, &den, &use_plane);
      const float w = Tk * alpha;
      const float A = gr * q2.x + gg * q2.y + gb * q2.z + gnx * q3.x + gny * q3.y + gnz * q3.z + go +
                      gd * z_px;
      const bool is_live = alpha > 0.f && raw < MAX_ALPHA;
      const float galpha = is_live ? Tk * A - B * inv : 0.f;
      const float expp = is_live ? raw / fmaxf(q1.w, 1e-12f) : 0.f;
      const float gP = galpha * alpha;
      const float gz = gd * w;
      const float rden = use_plane ? 1.f / den : 0.f;
      const float g_pn = gz * rden;
      const float g_den = -g_pn * q3.w * rden;
      const float gz_fb = use_plane ? 0.f : gz;
      float v[16] = {
          gP * (q1.x * dx + q1.y * dy),                 // u
          gP * (q1.y * dx + q1.z * dy),                 // v
          gP * (-0.5f * dx * dx),                       // conic a
          gP * (-dx * dy),                              // conic b
          gP * (-0.5f * dy * dy),                       // conic c
          galpha * expp,                                // opacity
          gr * w,                                       // r
          gg * w,                                       // g
          gb * w,                                       // b
          gnx * w + g_pn * pp.x + g_den * rx,           // nx
          gny * w + g_pn * pp.y + g_den * ry,           // ny
          gnz * w + g_pn * q2.w + g_den,                // nz
          g_pn * q3.x,                                  // px
          g_pn * q3.y,                                  // py
          g_pn * q3.z + gz_fb,                          // pz
          0.f,
      };
      B += w * A;
      const float s = warp_transpose_sum(v, lane);
      if (!(lane & 1) && lane < 2 * N_GRAD) wpart[k * N_GRAD + (lane >> 1)] = s;
    }
    if (lane == 0) live_bits[buf * N_WARPS + warp] = live;
    __syncthreads();  // the chunk's partials are written; the other buffer is free
    const int s0 = ci * CH, m = min(CH, n - s0);
    if (tid < m * N_GRAD) {
      const int k = tid / N_GRAD, j = tid % N_GRAD;
      const float* p = part + (size_t)buf * N_WARPS * CH * N_GRAD + k * N_GRAD + j;
      float s = 0.f;
      for (int w = 0; w < N_WARPS; ++w)
        if (live_bits[buf * N_WARPS + w] >> k & 1u) s += p[(size_t)w * CH * N_GRAD];
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
  if (cap / N_SUB > MAX_BWD_SLOTS) return static_cast<int>(cudaErrorInvalidValue);
  const int hp = (n_tiles / tx_tiles) * TILE_H;
  const int wp = tx_tiles * TILE_W;
  const int n_ch = (cap / N_SUB + CH - 1) / CH;
  const size_t smem = Smem::bytes(n_ch);
  cudaError_t err = cudaFuncSetAttribute(composite_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int aligned = (reinterpret_cast<uintptr_t>(entries) % 16) == 0;
  composite_bwd_kernel<<<dim3(n_tiles * N_SUB), dim3(THREADS), smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(counts), static_cast<const float*>(intr),
      static_cast<const float*>(entries), static_cast<const float*>(g_rgb),
      static_cast<const float*>(g_nrm), static_cast<const float*>(g_dep),
      static_cast<const float*>(g_opa), static_cast<const float*>(g_T),
      static_cast<const float*>(T_fin), static_cast<float*>(d_entries), tx_tiles, cap, hp, wp,
      aligned);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of the kernel at `cap` (0 when the query fails).
extern "C" int egg_composite_bwd_blocks_per_sm(int cap) {
  const int n_ch = (cap / N_SUB + CH - 1) / CH;
  const size_t smem = Smem::bytes(n_ch);
  int blocks = 0;
  if (cudaFuncSetAttribute(composite_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, composite_bwd_kernel, THREADS, smem);
  return err == cudaSuccess ? blocks : 0;
}

extern "C" const char* egg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
