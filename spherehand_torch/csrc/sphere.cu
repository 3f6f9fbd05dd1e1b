// Sphere-field kernels of the mutual-projection loss, for Hopper (sm_90a),
// bound with ctypes.
//
// They replace the TPU Pallas kernels of spherehand_tpu/render/sphere_pallas.py.
// One forward template computes the depth field, the distance field or both
// (kFields), with or without the residual planes a backward needs; one
// backward template turns those planes into the (N, J, 3) centre gradient:
//
//   sphere_fields<kBoth, false>  <- _fused_primal_kernel    (sphere_pallas.py:227)
//   sphere_fields<kBoth, true>   <- _fused_fwd_kernel       (:253)
//   sphere_fields_bwd<kBoth>     <- _fused_bwd_kernel       (:308)
//   sphere_fields<kDepth, false> <- _min_depth_primal_kernel (:99)
//   sphere_fields<kDepth, true>  <- _min_depth_fwd_kernel   (:70)
//   sphere_fields_bwd<kDepth>    <- _min_depth_bwd_kernel   (:118)
//   sphere_fields<kDist, false>  <- _d2m_primal_kernel      (:179)
//   sphere_fields<kDist, true>   <- _d2m_fwd_kernel         (:143)
//   sphere_fields_bwd<kDist>     <- _d2m_bwd_kernel         (:200)
//
// Forward: per image n and pixel p, the first minimum over the J spheres of
//   - the orthographic sphere depth cz - sqrt(max(sq, 1e-2)) with
//     sq = r^2 - dx^2 - dy^2 (background 100 where sq <= 1e-2), and/or
//   - the nearest-surface distance |sqrt(max(raw, 1e-6)) - r| of the
//     observed point (x, y, z), raw = |p|^2 - 2 p.c + |c|^2, 0 where the
//     observed z > 99;
// with residuals it also writes, for each field, the argmin plane (lowest j
// on a tie) and the gradient-weight plane of the winning sphere:
// 1/sqrt(max(sq, 1e-2)) inside the silhouette (else 0), and
// sign(root - r)/root (0 on background and where raw < 1e-6). The distance
// weight is zeroed on background in the forward, so the backward needs no
// mask (the TPU's standalone distance kernel zeroes the cotangent there
// instead; both give the same gradient). NaN follows torch.min / argmin, as
// the plain versions do: a NaN candidate beats any number, the first NaN
// wins, and max(x, lo) keeps a NaN x.
//
// Backward: with A_d = g_d w_d and A_m = g_m w_m, each S a masked sum over
// the pixels whose argmin is j,
//   depth:    g_x = c_x S A_d - S A_d x,  g_y alike,  g_z = S [w_d > 0] g_d;
//   distance: g_x = c_x S A_m - S A_m x,  g_y alike,  g_z = c_z S A_m - S A_m z;
//   both:     g_x = c_x (S A_d + S A_m) - S A_d x - S A_m x   (y alike),
//             g_z = S [w_d > 0] g_d + c_z S A_m - S A_m z.
//
// The observed depth of image n = (b, i, j) of a (B, V, V) pair grid is the
// target plane b * V + j: the kernels read it in place and never build the
// (B, V, V, S, S) broadcast. views = 1 reads plane n.
//
// What bounds them on this card, and the design (chip_smoke.py counts the
// bounds from these inputs). At the combined step's N = 225, J = 41, S = 64
// a forward that runs every sphere at every pixel makes 37.8 M updates of
// about 50 instructions, near the card's issue rate. Most are not needed:
// 86 % of the observed pixels of a pseudo-real batch are background, where
// the distance result is fixed (0, argmin 0, weight 0), and only 1 % of the
// (pixel, sphere) pairs lie inside a sphere's disc. So the forward does
// only the work the inputs need, and its results stay exact:
//   - Depth. A block owns a band of kTile rows of one image; a warp takes
//     a kTile x kTile tile of it, two pixels a lane. One sphere a lane,
//     the warp tests every disc against the tile's pixel-centre box with a
//     margin of a pixel (kCullMarginMm) and gathers the result in a 64-bit
//     ballot. A sphere whose disc misses the tile gives exactly the
//     candidate (100, j) at each of its pixels, so only the lowest culled
//     sphere can win among them: it seeds the minimum, and the loop runs
//     over the list of covered spheres in ascending j, where a candidate
//     of equal depth beats the seed only with a lower j. That keeps the
//     lowest-j rule among 100s and against a covered sphere whose depth is
//     >= 100, and the loop carries no dependence from one sphere to the
//     next but the running minimum. The winner's sq only feeds the weight,
//     which is 0 for a culled winner. The margin is far above the rounding
//     of the test: dx, dx^2 and the sums are monotone in float, so a disc
//     that misses by a pixel cannot reach 1e-2 in sq
//     (render/sphere_cuda.tile_covered is the plain mirror, tested on hands
//     and adversarial sets).
//   - Distance. A background pixel (z > 99; a NaN is not) skips the J loop
//     and writes 0, 0, 0. The distance field has blocks of its own, each a
//     band of kDistRows rows, beside the depth blocks of the same launch,
//     so the two fields of the fused kernel run side by side. A block
//     compacts its band's foreground pixels with ballots and a fixed prefix
//     over (pixel group, warp) into shared memory, and its threads take them
//     one each: a pseudo-real hand's foreground is a few thin silhouettes,
//     so warps over pixel tiles would run all 41 spheres for a few live
//     lanes.
//   - Block shape. 128 threads; at N = 225, 1,800 depth blocks and 3,600
//     distance blocks, twelve resident a SM at 31-43 registers; the spheres
//     sit in shared memory.
// Measured on an H100 (PERF.md, sphere_ab.py), neither field is bound by its
// bytes (six planes of 3.7 MB) but by the latency of its blocks: the depth
// blocks that hold the hand's densest tiles (dozens of covered spheres an
// 8 x 8 tile), and each distance block's chain of loads, barriers and its
// foreground's 41 spheres. Spreading each disc's pixels over the whole block
// instead (a shared-memory atomicMin of 64-bit (depth, j) keys, one sphere
// after another), eight warps a band, tiles of 4 rows, per-image distance
// blocks, several lanes to a foreground pixel and a 16-block register bound
// all measured no faster.
// The backward reads three to seven planes and does little arithmetic: it
// is bound by bytes. One block of 512 threads owns one image (two blocks a
// SM, so N = 225 is one wave); a warp owns 256 consecutive pixels and holds
// four of them a lane at a time. A pixel whose terms are all +-0 takes part
// in no sum (exact: a sum that starts at +0 keeps its bits when +-0 is
// added; NaN is not 0, so a NaN cotangent still reaches its sphere). Each
// warp ORs the keys its lanes hold into a 64-bit set, and for each sphere in
// the set reduces its sums with a fixed butterfly of shuffles into the
// warp's slot in shared memory (added to the slot's earlier rounds in
// order). The 16 warp slots of each (sphere, sum) are then added in warp
// order by one thread each, 328 at J = 41. No atomics: two runs give the
// same bits. Its time is set by the warps whose rows hold the most spheres
// (one butterfly each); spreading a warp's pixels over the image instead
// gave every warp more spheres and measured slower.
//
// Numerics. Built with -fmad=false and without fast math, so every product
// and sum rounds on its own and sqrt and division are IEEE. The expression
// order is that of the TPU kernels and of the plain PyTorch versions
// (render/sphere_cuda.py): the grid is ((u - S/2) * 300) / S as two
// operations, sq = (r*r - dx*dx) - dy*dy, raw = (p_sq - 2 p.c) + c_sq, and
// a strict < keeps the lowest j on a tie, so forward fields and argmins are
// bit-identical to the plain versions, and a one-field kernel's field to
// the same field of the two-field kernel. The depth weight is
// 1.0f / sqrtf(x) (the TPU kernel's rsqrt would differ from the plain
// version in the last bit).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kDepth = 1;  // field masks, as render/sphere_cuda.py passes them
constexpr int kDist = 2;
constexpr int kBoth = kDepth | kDist;

constexpr int kTile = 8;                    // depth tiles and bands: kTile x kTile pixels
constexpr int kFwdWarps = 4;                // a forward block: one band, depth or distance
constexpr int kFwdThreads = 32 * kFwdWarps;
constexpr int kMaxSize = 64;                // S <= 64 (S * S <= 4096)
constexpr int kDistRows = 4;                // a distance block's band of rows
constexpr int kBandSlots = kDistRows * kMaxSize / kFwdThreads;  // its pixels a thread loads
constexpr int kBwdThreads = 512;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kPixelsPerThread = 8;         // S * S <= 4096
constexpr int kRound = 4;                   // pixels a lane holds at once
constexpr int kMaxJ = 64;
constexpr float kBackground = 100.0f;
constexpr float kCubeMm = 300.0f;
// A disc is culled from a tile only when it misses the tile's pixel centres
// by more than this (one pixel at S = 64).
constexpr float kCullMarginMm = kCubeMm / 64.0f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float grid_mm(int i, int size) {
  // ((i - size / 2) * 300) / size, two rounded operations like _mm_grid.
  const float half = (float)size * 0.5f;
  return (((float)i - half) * kCubeMm) / (float)size;
}

__device__ __forceinline__ int target_plane(int n, int views) {
  return (n / (views * views)) * views + n % views;
}

// torch.clamp(x, min=lo): a NaN x stays NaN (fmaxf would return lo).
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

// Whether candidate a replaces the best b in a loop over ascending j: the
// order of torch.argmin, in which a NaN beats every number and the first
// NaN wins.
__device__ __forceinline__ bool takes(float a, float b) { return a < b || (a != a && b == b); }

// Whether sphere s's disc may reach a pixel centre of the box [x_lo, x_hi]
// x [y_lo, y_hi]. False only when the centre lies more than r plus the
// margin from the box, so every culled sphere has sq <= 1e-2, depth 100,
// at every pixel of the box. A NaN centre coordinate gives sq NaN (depth
// 100) everywhere, so culling it or not is the same; a NaN radius keeps
// the sphere.
__device__ __forceinline__ bool disc_meets_box(float4 s, float x_lo, float x_hi, float y_lo,
                                               float y_hi) {
  const float ex = fmaxf(fmaxf(x_lo - s.x, s.x - x_hi), 0.0f);
  const float ey = fmaxf(fmaxf(y_lo - s.y, s.y - y_hi), 0.0f);
  const float lim = s.w + kCullMarginMm;
  return !(ex > lim || ey > lim || ex * ex + ey * ey > lim * lim);
}

struct DepthBest {
  float d = INFINITY, sq = 0.0f;
  int j = 0;
};

struct DistBest {
  float m = INFINITY, raw = 0.0f, r = 0.0f;
  int j = 0;
};

template <int kFields, bool kResiduals>
__global__ void __launch_bounds__(kFwdThreads)
sphere_fields(const float* __restrict__ centers,  // (N, J, 3)
              const float* __restrict__ radii,    // (J,)
              const float* __restrict__ target,   // (N / V, S, S); distance only
              int num_j, int size, int views,
              float* __restrict__ depth, float* __restrict__ dist,
              int* __restrict__ amind, float* __restrict__ wd,
              int* __restrict__ aminm, float* __restrict__ wm) {
  constexpr bool kD = (kFields & kDepth) != 0;
  constexpr bool kM = (kFields & kDist) != 0;
  __shared__ float4 sphere[kMaxJ];  // cx, cy, cz, r
  __shared__ float r_sq[kMaxJ];
  __shared__ float c_sq[kMaxJ];
  __shared__ short fg_pixel[kDistRows * kMaxSize];  // the band's foreground, compacted
  __shared__ float fg_z[kDistRows * kMaxSize];
  __shared__ int fg_count[kBandSlots][kFwdWarps];
  __shared__ float grid[kMaxSize];  // grid_mm of each column and row
  __shared__ unsigned char covered_list[kFwdWarps][kMaxJ];  // depth: a tile's spheres
  const int pixels = size * size;
  // Blocks run image by image in gridDim.x (up to 2^31 - 1 blocks, where
  // gridDim.y would stop at 65,535 images): the depth blocks of an image
  // come first, then its distance blocks.
  const int depth_bands = kD ? (size + kTile - 1) / kTile : 0;
  const int bands = depth_bands + (kM ? (size + kDistRows - 1) / kDistRows : 0);
  const int n = (int)(blockIdx.x / bands);
  const int band = (int)(blockIdx.x % bands);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = threadIdx.x; j < num_j; j += blockDim.x) {
    const float* c = centers + ((size_t)n * num_j + j) * 3;
    const float cx = c[0], cy = c[1], cz = c[2], r = radii[j];
    sphere[j] = make_float4(cx, cy, cz, r);
    if (kD) r_sq[j] = r * r;
    if (kM) c_sq[j] = cx * cx + cy * cy + cz * cz;
  }
  for (int i = threadIdx.x; i < size; i += blockDim.x) grid[i] = grid_mm(i, size);
  __syncthreads();
  const size_t plane0 = (size_t)n * pixels;

  if (kD && band < depth_bands) {
    const int v0 = band * kTile;
    const int rows = min(kTile, size - v0);
    const int tiles_x = (size + kTile - 1) / kTile;
    const float y_lo = grid[v0];
    const float y_hi = grid[v0 + rows - 1];
    for (int t = warp; t < tiles_x; t += kFwdWarps) {
      const int u0 = t * kTile;
      const float x_lo = grid[u0];
      const float x_hi = grid[min(u0 + kTile, size) - 1];
      const bool meets_lo = lane < num_j &&
                            disc_meets_box(sphere[lane], x_lo, x_hi, y_lo, y_hi);
      const bool meets_hi = lane + 32 < num_j &&
                            disc_meets_box(sphere[lane + 32], x_lo, x_hi, y_lo, y_hi);
      const unsigned cov_lo = __ballot_sync(kFull, meets_lo);
      const unsigned cov_hi = __ballot_sync(kFull, meets_hi);
      // The covered spheres in ascending j, listed for the warp.
      const unsigned below = (1u << lane) - 1u;
      unsigned char* list = covered_list[warp];
      if (meets_lo) list[__popc(cov_lo & below)] = (unsigned char)lane;
      if (meets_hi) list[__popc(cov_lo) + __popc(cov_hi & below)] = (unsigned char)(lane + 32);
      __syncwarp();
      const int n_covered = __popc(cov_lo) + __popc(cov_hi);
      // Every culled sphere is (100, j) at each pixel of the tile, so only
      // the lowest can win: it seeds the minimum, and a covered candidate
      // of equal depth beats it only with a lower j.
      const uint64_t valid = num_j == 64 ? ~0ull : (1ull << num_j) - 1ull;
      const uint64_t culled = ~(((uint64_t)cov_hi << 32) | cov_lo) & valid;
      // two pixels a lane: column u0 + lane % 8, rows v0 + lane / 8 and 4 below
      const int u = u0 + (lane & 7);
      const float xg = grid[min(u, size - 1)];
      float yg[2];
      DepthBest best[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        yg[k] = grid[min(v0 + k * 4 + (lane >> 3), size - 1)];
        if (culled) {
          best[k].d = kBackground;
          best[k].j = __ffsll((long long)culled) - 1;
        }
      }
#pragma unroll 2
      for (int i = 0; i < n_covered; ++i) {
        const int j = list[i];
        const float4 s = sphere[j];
        const float rr = r_sq[j];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float dx = xg - s.x;
          const float dy = yg[k] - s.y;
          const float sq = rr - dx * dx - dy * dy;
          const float d = sq > 1e-2f ? s.z - sqrtf(fmaxf(sq, 1e-2f)) : kBackground;
          if (takes(d, best[k].d) || (d == best[k].d && j < best[k].j)) {
            best[k].d = d;
            best[k].j = j;
            best[k].sq = sq;
          }
        }
      }
      __syncwarp();  // the list is written again for the next tile
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int v = v0 + k * 4 + (lane >> 3);
        if (u >= size || v >= v0 + rows) continue;
        const size_t o = plane0 + (size_t)v * size + u;
        depth[o] = best[k].d;
        if (kResiduals) {
          amind[o] = best[k].j;
          wd[o] = best[k].sq > 1e-2f ? 1.0f / sqrtf(fmaxf(best[k].sq, 1e-2f)) : 0.0f;
        }
      }
    }
  } else if constexpr (kM) {
    const int v0 = (band - depth_bands) * kDistRows;
    const int rows = min(kDistRows, size - v0);
    const float* z_plane = target + (size_t)target_plane(n, views) * pixels;
    const int p0 = v0 * size;
    const int count = rows * size;
    float z[kBandSlots];
    unsigned fg_bits[kBandSlots];
#pragma unroll
    for (int k = 0; k < kBandSlots; ++k) {
      const int i = k * kFwdThreads + threadIdx.x;
      z[k] = i < count ? z_plane[p0 + i] : kBackground;
      const bool fg = i < count && !(z[k] > 99.0f);
      if (i < count && !fg) {  // background: the loop's fixed result
        const size_t o = plane0 + p0 + i;
        dist[o] = 0.0f;
        if (kResiduals) {
          aminm[o] = 0;
          wm[o] = 0.0f;
        }
      }
      fg_bits[k] = __ballot_sync(kFull, fg);
      if (lane == 0) fg_count[k][warp] = __popc(fg_bits[k]);
    }
    __syncthreads();
    // The foreground in (slot, warp, lane) order: a fixed prefix over the
    // counts, then each lane's rank among the warp's foreground lanes.
    int total = 0;
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int k = 0; k < kBandSlots; ++k) {
      for (int w = 0; w < kFwdWarps; ++w) {
        if (w == warp && (fg_bits[k] >> lane & 1u)) {
          const int e = total + __popc(fg_bits[k] & below);
          fg_pixel[e] = (short)(k * kFwdThreads + threadIdx.x);
          fg_z[e] = z[k];
        }
        total += fg_count[k][w];
      }
    }
    __syncthreads();

    for (int e = threadIdx.x; e < total; e += kFwdThreads) {
      const int p = p0 + fg_pixel[e];
      const float zp = fg_z[e];
      const float xg = grid[p % size];
      const float yg = grid[p / size];
      const float p_sq = xg * xg + yg * yg + zp * zp;
      DistBest best;
#pragma unroll 4
      for (int j = 0; j < num_j; ++j) {
        const float4 s = sphere[j];
        const float p_dot_c = xg * s.x + yg * s.y + zp * s.z;
        const float raw = p_sq - 2.0f * p_dot_c + c_sq[j];
        const float m = fabsf(sqrtf(clamp_min(raw, 1e-6f)) - s.w);
        if (takes(m, best.m)) {
          best.m = m;
          best.j = j;
          best.raw = raw;
          best.r = s.w;
        }
      }
      const size_t o = plane0 + p;
      dist[o] = best.m;
      if (kResiduals) {
        aminm[o] = best.j;
        const float root = sqrtf(clamp_min(best.raw, 1e-6f));
        const float diff = root - best.r;
        const float sign = (float)((diff > 0.0f) - (diff < 0.0f));
        wm[o] = best.raw < 1e-6f ? 0.0f : sign / root;
      }
    }
  }
}

// Masked sums a field keeps per sphere: depth A_d, A_d x, A_d y,
// [w_d > 0] g_d; distance A_m, A_m x, A_m y, A_m z.
template <int kFields>
__host__ __device__ constexpr int num_sums() {
  return ((kFields & kDepth) ? 4 : 0) + ((kFields & kDist) ? 4 : 0);
}

__device__ __forceinline__ uint64_t key_bit(int key) {
  return key >= 0 ? (uint64_t)1 << key : 0;
}

template <int kFields>
__global__ void __launch_bounds__(kBwdThreads, 2)
sphere_fields_bwd(const float* __restrict__ centers,  // (N, J, 3)
                  const float* __restrict__ target,   // (N / V, S, S); distance only
                  const float* __restrict__ g_depth,  // (N, S, S)
                  const float* __restrict__ g_dist,
                  const int* __restrict__ amind,
                  const float* __restrict__ wd,
                  const int* __restrict__ aminm,
                  const float* __restrict__ wm,
                  int num_j, int size, int views,
                  float* __restrict__ out) {          // (N, J, 3)
  constexpr bool kD = (kFields & kDepth) != 0;
  constexpr bool kM = (kFields & kDist) != 0;
  constexpr int kSums = num_sums<kFields>();
  constexpr int kM0 = kD ? 4 : 0;  // index of the first distance sum
  extern __shared__ float partial[];  // [J][kBwdWarps][kSums], then [J][kSums]
  __shared__ uint64_t owned_by[kBwdWarps];
  __shared__ float grid[kMaxSize];
  const int n = blockIdx.x;
  const int pixels = size * size;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* z_plane = kM ? target + (size_t)target_plane(n, views) * pixels : nullptr;
  uint64_t owned = 0;  // spheres this warp has a slot for, warp-uniform
  for (int i = threadIdx.x; i < size; i += blockDim.x) grid[i] = grid_mm(i, size);
  __syncthreads();

  for (int round = 0; round < kPixelsPerThread / kRound; ++round) {
    // Per pixel: the argmin keys (-1 = none, or all terms +-0) and the terms.
    int key_d[kRound], key_m[kRound];
    float term[kRound][kSums];
    uint64_t keys = 0;
#pragma unroll
    for (int k = 0; k < kRound; ++k) {
      const int p = (warp * kPixelsPerThread + round * kRound + k) * 32 + lane;
      key_d[k] = -1;
      key_m[k] = -1;
#pragma unroll
      for (int s = 0; s < kSums; ++s) term[k][s] = 0.0f;
      if (p >= pixels) continue;
      const size_t o = (size_t)n * pixels + p;
      const float xg = grid[p % size];
      const float yg = grid[p / size];
      if constexpr (kD) {
        const float gd = g_depth[o];
        const float w_d = wd[o];
        const float ad = gd * w_d;
        term[k][0] = ad;
        term[k][1] = ad * xg;
        term[k][2] = ad * yg;
        term[k][3] = w_d > 0.0f ? gd : 0.0f;
        if (term[k][0] != 0.0f || term[k][1] != 0.0f || term[k][2] != 0.0f ||
            term[k][3] != 0.0f) {
          key_d[k] = amind[o];
        }
      }
      if constexpr (kM) {
        const float am = g_dist[o] * wm[o];
        term[k][kM0 + 0] = am;
        term[k][kM0 + 1] = am * xg;
        term[k][kM0 + 2] = am * yg;
        term[k][kM0 + 3] = am * z_plane[p];
        if (term[k][kM0] != 0.0f || term[k][kM0 + 1] != 0.0f || term[k][kM0 + 2] != 0.0f ||
            term[k][kM0 + 3] != 0.0f) {
          key_m[k] = aminm[o];
        }
      }
      keys |= key_bit(key_d[k]) | key_bit(key_m[k]);
    }
    const unsigned lo = __reduce_or_sync(kFull, (unsigned)keys);
    const unsigned hi = __reduce_or_sync(kFull, (unsigned)(keys >> 32));
    uint64_t todo = ((uint64_t)hi << 32) | lo;
    while (todo) {
      const int j = __ffsll((long long)todo) - 1;
      todo &= todo - 1;
      float sum[kSums];
#pragma unroll
      for (int s = 0; s < kSums; ++s) sum[s] = 0.0f;
#pragma unroll
      for (int k = 0; k < kRound; ++k) {
        if constexpr (kD) {
          if (key_d[k] == j) {
#pragma unroll
            for (int s = 0; s < 4; ++s) sum[s] += term[k][s];
          }
        }
        if constexpr (kM) {
          if (key_m[k] == j) {
#pragma unroll
            for (int s = kM0; s < kM0 + 4; ++s) sum[s] += term[k][s];
          }
        }
      }
      // Fixed butterfly: every lane ends with the same bits.
#pragma unroll
      for (int offset = 16; offset > 0; offset >>= 1) {
#pragma unroll
        for (int s = 0; s < kSums; ++s) sum[s] += __shfl_xor_sync(kFull, sum[s], offset);
      }
      if (lane == 0) {
        float* slot = partial + ((size_t)j * kBwdWarps + warp) * kSums;
        const bool again = (owned >> j) & 1u;
#pragma unroll
        for (int s = 0; s < kSums; ++s) slot[s] = again ? slot[s] + sum[s] : sum[s];
      }
      owned |= (uint64_t)1 << j;
    }
  }
  if (lane == 0) owned_by[warp] = owned;
  __syncthreads();

  // Each (sphere, sum): the warps' slots in warp order; a warp without a
  // slot adds nothing, as +0 would.
  float* total = partial + (size_t)num_j * kBwdWarps * kSums;
  for (int i = threadIdx.x; i < num_j * kSums; i += blockDim.x) {
    const int j = i / kSums;
    const int s = i % kSums;
    float t = 0.0f;
    for (int w = 0; w < kBwdWarps; ++w) {
      if ((owned_by[w] >> j) & 1u) t += partial[((size_t)j * kBwdWarps + w) * kSums + s];
    }
    total[i] = t;
  }
  __syncthreads();

  for (int j = threadIdx.x; j < num_j; j += blockDim.x) {
    const float* t = total + (size_t)j * kSums;
    const float* c = centers + ((size_t)n * num_j + j) * 3;
    float* g = out + ((size_t)n * num_j + j) * 3;
    if constexpr (kD && kM) {
      g[0] = c[0] * (t[0] + t[4]) - t[1] - t[5];
      g[1] = c[1] * (t[0] + t[4]) - t[2] - t[6];
      g[2] = t[3] + c[2] * t[4] - t[7];
    } else if constexpr (kD) {
      g[0] = c[0] * t[0] - t[1];
      g[1] = c[1] * t[0] - t[2];
      g[2] = t[3];
    } else {
      g[0] = c[0] * t[0] - t[1];
      g[1] = c[1] * t[0] - t[2];
      g[2] = c[2] * t[0] - t[3];
    }
  }
}

template <int kFields>
cudaError_t launch_fwd(const float* centers, const float* radii, const float* target, int n,
                       int num_j, int size, int views, float* depth, float* dist, int* amind,
                       float* wd, int* aminm, float* wm, int residuals, cudaStream_t s) {
  const int depth_bands = (kFields & kDepth) ? (size + kTile - 1) / kTile : 0;
  const int dist_bands = (kFields & kDist) ? (size + kDistRows - 1) / kDistRows : 0;
  const long long blocks = (long long)(depth_bands + dist_bands) * n;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;  // gridDim.x's limit
  const unsigned grid = (unsigned)blocks;
  if (residuals) {
    sphere_fields<kFields, true><<<grid, kFwdThreads, 0, s>>>(
        centers, radii, target, num_j, size, views, depth, dist, amind, wd, aminm, wm);
  } else {
    sphere_fields<kFields, false><<<grid, kFwdThreads, 0, s>>>(
        centers, radii, target, num_j, size, views, depth, dist, nullptr, nullptr, nullptr,
        nullptr);
  }
  return cudaGetLastError();
}

template <int kFields>
cudaError_t launch_bwd(const float* centers, const float* target, const float* g_depth,
                       const float* g_dist, const int* amind, const float* wd, const int* aminm,
                       const float* wm, int n, int num_j, int size, int views, float* out,
                       cudaStream_t s) {
  const size_t smem = (size_t)num_j * (kBwdWarps + 1) * num_sums<kFields>() * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sphere_fields_bwd<kFields>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  sphere_fields_bwd<kFields><<<n, kBwdThreads, smem, s>>>(
      centers, target, g_depth, g_dist, amind, wd, aminm, wm, num_j, size, views, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Forward of the fields in the mask `fields` (1 depth, 2 distance, 3 both).
// residuals != 0 also writes each computed field's argmin and weight planes
// (amind, wd / aminm, wm). Pointers of a field not computed are ignored, and
// so is `target` without the distance field. Returns cudaGetLastError()
// after the launch.
int shx_sphere_fields(const float* centers, const float* radii, const float* target,
                      int n, int num_j, int size, int views,
                      float* depth, float* dist, int* amind, float* wd, int* aminm,
                      float* wm, int fields, int residuals, void* stream) {
  if (num_j < 1 || num_j > kMaxJ || n < 0 || size < 1 || size > kMaxSize) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (fields) {
    case kBoth:
      return (int)launch_fwd<kBoth>(centers, radii, target, n, num_j, size, views, depth, dist,
                                    amind, wd, aminm, wm, residuals, s);
    case kDepth:
      return (int)launch_fwd<kDepth>(centers, radii, target, n, num_j, size, views, depth,
                                     dist, amind, wd, aminm, wm, residuals, s);
    case kDist:
      return (int)launch_fwd<kDist>(centers, radii, target, n, num_j, size, views, depth, dist,
                                    amind, wd, aminm, wm, residuals, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Centre gradient (N, J, 3) of the fields in the mask `fields` from their
// cotangents and residual planes (summed over both fields for 3). Returns
// cudaGetLastError() after the launch.
int shx_sphere_fields_bwd(const float* centers, const float* target, const float* g_depth,
                          const float* g_dist, const int* amind, const float* wd,
                          const int* aminm, const float* wm, int n, int num_j, int size,
                          int views, int fields, float* out, void* stream) {
  if (num_j < 1 || num_j > kMaxJ || size * size > kPixelsPerThread * kBwdThreads) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (fields) {
    case kBoth:
      return (int)launch_bwd<kBoth>(centers, target, g_depth, g_dist, amind, wd, aminm, wm, n,
                                    num_j, size, views, out, s);
    case kDepth:
      return (int)launch_bwd<kDepth>(centers, target, g_depth, g_dist, amind, wd, aminm, wm, n,
                                     num_j, size, views, out, s);
    case kDist:
      return (int)launch_bwd<kDist>(centers, target, g_depth, g_dist, amind, wd, aminm, wm, n,
                                    num_j, size, views, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* shx_sphere_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
