// Shared device code of the surfel compositors (composite_fwd.cu,
// composite_bwd.cu): the entry layout, the asynchronous staging of a
// sub-column's entries into shared memory, and the exact row cull.
//
// Staging. A sub-column's entries are strided in the slab (row = slot * 4 +
// sub-column), each one 64 contiguous bytes. They are staged in chunks of 32
// slots: lane k of one warp copies slot k of its chunk with four 16-byte
// `cp.async` copies, waits for its own copies, turns the raw entry into a
// prepared one in place (per-entry constants and the cull interval), and
// arrives on the chunk's `mbarrier`. Every warp that composites the chunk
// waits on that barrier first, so a chunk is consumed as soon as it is ready
// while later chunks are still in flight, and no block barrier is needed
// between staging and use.
//
// Row cull. The raw alpha op * exp(-Q/2), Q = a dx^2 + 2 b dx dy + c dy^2,
// reaches ALPHA_EPS = 1/255 only where Q <= tau = 2 ln(255 op). Inside that
// ellipse |dy| <= sqrt(tau a / det) and |dx| <= sqrt(tau c / det), det =
// a c - b^2. The prepared entry carries the interval of pixel rows [ylo, yhi]
// it can touch, emptied when its column range misses the block's 32 columns
// or when op is too small for any pixel; a warp skips every entry whose
// interval misses its rows. The bound is padded (tau by 2e-3 relative plus
// 1e-3, each extent by 1 px) so float rounding never drops a live pair, and
// an entry whose conic is not safely positive definite (det <= 4e-3 a c,
// a or c <= 0) or has a non-finite value is never culled. With det > 4e-3 a c
// the rounding error of the kernel's Q is below 1e-3 of Q, which the padding
// covers. The plain PyTorch twin is `raster_tile.cull_extent`.
//
// Built with -DEGG_NO_CULL, every entry gets the whole column: the checks
// compare that build bit for bit with this one, since a culled pair adds
// exactly nothing.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace egg {

constexpr int TILE_H = 32;
constexpr int TILE_W = 128;
constexpr int SUB_W = 32;
constexpr int N_SUB = 4;
constexpr int N_ATTR = 16;
constexpr int CH = 32;           // slots per staged chunk: one per lane of the staging warp
constexpr int MAX_STAGE = 512;   // slots staged at once (cap 2048 / 4): 32 KB of shared memory
constexpr int MAX_CH = MAX_STAGE / CH;
constexpr float MAX_ALPHA = 0.99f;
constexpr float ALPHA_EPS = 1.0f / 255.0f;
constexpr float NEAR_Z = 0.05f;
constexpr unsigned FULL = 0xffffffffu;

enum { A_U, A_V, A_CA, A_CB, A_CC, A_OP, A_R, A_G, A_B, A_NX, A_NY, A_NZ, A_PX, A_PY, A_PZ };

// A prepared entry (64 bytes, four float4):
//   q0 = (u, v, ylo, yhi)   centre and the cull's row interval
//   q1 = (a, b, c, op)      conic and opacity
//   q2 = (r, g, b, p_z)     colour and the plane-depth fallback
//   q3 = (n_x, n_y, n_z, p.n)
struct Prep {
  float4 q0, q1, q2, q3;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// The row interval [ylo, yhi] of pixels the entry can touch in the block
// whose columns are [x0, x0 + SUB_W); empty (ylo > yhi) when none.
__device__ __forceinline__ void cull_rows(float u, float v, float a, float b, float c, float op,
                                          float x0, float* ylo, float* yhi) {
#ifdef EGG_NO_CULL
  *ylo = -INFINITY;
  *yhi = INFINITY;
#else
  const float det = a * c - b * b;
  const bool finite = isfinite(u) && isfinite(v) && isfinite(a) && isfinite(b) && isfinite(c) &&
                      isfinite(op) && isfinite(det);
  if (!(finite && a > 0.f && c > 0.f && det > 4e-3f * a * c)) {
    *ylo = -INFINITY;
    *yhi = INFINITY;
    return;
  }
  const float tau = 2.f * logf(255.f * op);
  const float taup = tau + 2e-3f * fabsf(tau) + 1e-3f;
  *ylo = INFINITY;
  *yhi = -INFINITY;
  if (!(taup >= 0.f)) return;  // op < 1/255 (or <= 0): dead on every pixel
  const float hw = sqrtf(taup * c / det) + 1.f;
  const float hh = sqrtf(taup * a / det) + 1.f;
  if (u + hw < x0 || u - hw > x0 + (SUB_W - 1)) return;
  *ylo = v - hh;
  *yhi = v + hh;
#endif
}

// Stage and prepare slots [s0, s0 + CH) of sub-column `c` (those >= `n` get
// an empty interval) into `dst`, and their (p_x, p_y) into `pxy` where given;
// called by one whole warp, which then arrives on `bar` (initialised with a
// count of 32).
__device__ __forceinline__ void stage_chunk(Prep* dst, float2* pxy, const float* __restrict__ tile,
                                            int s0, int n, int c, float x0, bool aligned,
                                            uint64_t* bar) {
  const int lane = threadIdx.x % 32;
  const int s = s0 + lane;
  Prep* p = dst + lane;
  if (s < n) {
    const float* src = tile + ((size_t)s * N_SUB + c) * N_ATTR;
    const uint32_t d = smem_addr(p);
    if (aligned) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d + 16 * i), "l"(src + 4 * i)
                     : "memory");
    } else {
#pragma unroll
      for (int i = 0; i < N_ATTR; ++i)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d + 4 * i), "l"(src + i)
                     : "memory");
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    const float4 r0 = p->q0, r1 = p->q1, r2 = p->q2, r3 = p->q3;
    // raw: r0 = (u, v, a, b), r1 = (c, op, r, g), r2 = (b, nx, ny, nz), r3 = (px, py, pz, 1)
    float ylo, yhi;
    cull_rows(r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, x0, &ylo, &yhi);
    const float pn = r3.x * r2.y + r3.y * r2.z + r3.z * r2.w;
    p->q0 = make_float4(r0.x, r0.y, ylo, yhi);
    p->q1 = make_float4(r0.z, r0.w, r1.x, r1.y);
    p->q2 = make_float4(r1.z, r1.w, r2.x, r3.z);
    p->q3 = make_float4(r2.y, r2.z, r2.w, pn);
    if (pxy) pxy[lane] = make_float2(r3.x, r3.y);
  } else {
    p->q0 = make_float4(0.f, 0.f, INFINITY, -INFINITY);
  }
  __syncwarp();
  mbar_arrive(bar);
}

// Bit k set when slot `base + k` of `st` can touch a row in [y_lo, y_hi].
__device__ __forceinline__ unsigned keep_mask(const Prep* st, int base, float y_lo, float y_hi) {
  const float2 iv = *reinterpret_cast<const float2*>(&st[base + threadIdx.x % 32].q0.z);
  return __ballot_sync(FULL, iv.x <= y_hi && iv.y >= y_lo);
}

// alpha of one pixel, as the TPU kernel's `_group_alpha`: zero below
// ALPHA_EPS, and zero where the raw value is not a number.
__device__ __forceinline__ float pixel_alpha(const float4& q1, float dx, float dy, float* raw_out) {
  const float power = -0.5f * (q1.x * dx * dx + q1.z * dy * dy) - q1.y * dx * dy;
  const float raw = q1.w * expf(power);
  *raw_out = raw;
  return raw >= ALPHA_EPS ? fminf(MAX_ALPHA, raw) : 0.f;
}

// the pixel ray's depth on the surfel plane, p_z where the plane is unusable
__device__ __forceinline__ float plane_depth(const float4& q2, const float4& q3, float rx, float ry,
                                             float* denom_safe, bool* use_plane) {
  const float denom = rx * q3.x + ry * q3.y + q3.z;
  const bool ok = fabsf(denom) >= 1e-6f;
  *denom_safe = ok ? denom : 1e-6f;
  const float z_plane = q3.w / *denom_safe;
  *use_plane = z_plane > NEAR_Z && ok;
  return *use_plane ? z_plane : q2.w;
}

}  // namespace egg
