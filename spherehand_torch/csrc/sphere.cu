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
// Forward: per image n and pixel p, one loop over the J spheres that keeps
//   - the min orthographic sphere depth cz - sqrt(max(sq, 1e-2)) with
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
// instead; both give the same gradient).
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
// What bounds them on this card (counted by chip_smoke.py from this
// source): at N = 225, J = 41, S = 64 the forward makes 37.8 M pixel-sphere
// updates of 15 (depth), 18 (distance) or 33 (both) operations with
// residuals, 13 / 15 / 28 without, microseconds of float32 work against a
// few microseconds to write its planes: it is bound by operations. The
// design keeps the J loop in registers with the image's spheres in shared
// memory (one block of 256 pixels per image row group), so no (N, J, S, S)
// intermediate touches memory. The backward reads three to seven planes and
// does little arithmetic: it is bound by bytes. One block of 1024 threads
// owns one image and keeps its four pixels' weighted terms in registers;
// for each sphere j a warp that owns no pixel of j skips it (a warp-uniform
// vote), the others reduce their sums with a fixed butterfly of shuffles
// into shared memory, and one thread per sphere adds the 32 warp partials
// in warp order. No atomics: two runs give the same bits.
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

constexpr int kFwdThreads = 256;
constexpr int kBwdThreads = 1024;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kPixelsPerThread = 4;  // S * S <= 4096
constexpr int kMaxJ = 64;
constexpr float kBackground = 100.0f;
constexpr float kCubeMm = 300.0f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float grid_mm(int i, int size) {
  // ((i - size / 2) * 300) / size, two rounded operations like _mm_grid.
  const float half = (float)size * 0.5f;
  return (((float)i - half) * kCubeMm) / (float)size;
}

__device__ __forceinline__ int target_plane(int n, int views) {
  return (n / (views * views)) * views + n % views;
}

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
  const int n = blockIdx.y;
  const int pixels = size * size;
  for (int j = threadIdx.x; j < num_j; j += blockDim.x) {
    const float* c = centers + ((size_t)n * num_j + j) * 3;
    const float cx = c[0], cy = c[1], cz = c[2], r = radii[j];
    sphere[j] = make_float4(cx, cy, cz, r);
    if (kD) r_sq[j] = r * r;
    if (kM) c_sq[j] = cx * cx + cy * cy + cz * cz;
  }
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= pixels) return;

  const float xg = grid_mm(p % size, size);
  const float yg = grid_mm(p / size, size);
  float z = 0.0f, p_sq = 0.0f;
  bool background = false;
  if (kM) {
    z = target[(size_t)target_plane(n, views) * pixels + p];
    p_sq = xg * xg + yg * yg + z * z;
    background = z > 99.0f;
  }

  float best_d = INFINITY, best_sq = 0.0f;
  float best_m = INFINITY, best_raw = 0.0f, best_r = 0.0f;
  int best_jd = 0, best_jm = 0;
  for (int j = 0; j < num_j; ++j) {
    const float4 s = sphere[j];
    if (kD) {
      const float dx = xg - s.x;
      const float dy = yg - s.y;
      const float sq = r_sq[j] - dx * dx - dy * dy;
      const float d = sq > 1e-2f ? s.z - sqrtf(fmaxf(sq, 1e-2f)) : kBackground;
      if (d < best_d) {
        best_d = d;
        best_jd = j;
        best_sq = sq;
      }
    }
    if (kM) {
      const float p_dot_c = xg * s.x + yg * s.y + z * s.z;
      const float raw = p_sq - 2.0f * p_dot_c + c_sq[j];
      const float m = background ? 0.0f : fabsf(sqrtf(fmaxf(raw, 1e-6f)) - s.w);
      if (m < best_m) {
        best_m = m;
        best_jm = j;
        best_raw = raw;
        best_r = s.w;
      }
    }
  }
  const size_t o = (size_t)n * pixels + p;
  if (kD) {
    depth[o] = best_d;
    if (kResiduals) {
      amind[o] = best_jd;
      wd[o] = best_sq > 1e-2f ? 1.0f / sqrtf(fmaxf(best_sq, 1e-2f)) : 0.0f;
    }
  }
  if (kM) {
    dist[o] = best_m;
    if (kResiduals) {
      aminm[o] = best_jm;
      const float root = sqrtf(fmaxf(best_raw, 1e-6f));
      const float diff = root - best_r;
      const float sign = (float)((diff > 0.0f) - (diff < 0.0f));
      wm[o] = (background || best_raw < 1e-6f) ? 0.0f : sign / root;
    }
  }
}

// Masked sums a field keeps per sphere: depth A_d, A_d x, A_d y,
// [w_d > 0] g_d; distance A_m, A_m x, A_m y, A_m z.
template <int kFields>
__host__ __device__ constexpr int num_sums() {
  return ((kFields & kDepth) ? 4 : 0) + ((kFields & kDist) ? 4 : 0);
}

template <int kFields>
__global__ void __launch_bounds__(kBwdThreads)
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
  extern __shared__ float partial[];  // [J][kBwdWarps][kSums]
  const int n = blockIdx.x;
  const int pixels = size * size;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* z_plane = kM ? target + (size_t)target_plane(n, views) * pixels : nullptr;

  // Per pixel: the argmin keys (-1 = none) and the weighted terms.
  int key_d[kPixelsPerThread], key_m[kPixelsPerThread];
  float term[kPixelsPerThread][kSums];
#pragma unroll
  for (int k = 0; k < kPixelsPerThread; ++k) {
    const int p = threadIdx.x + k * kBwdThreads;
    key_d[k] = -1;
    key_m[k] = -1;
#pragma unroll
    for (int s = 0; s < kSums; ++s) term[k][s] = 0.0f;
    if (p >= pixels) continue;
    const size_t o = (size_t)n * pixels + p;
    const float xg = grid_mm(p % size, size);
    const float yg = grid_mm(p / size, size);
    if constexpr (kD) {
      const float gd = g_depth[o];
      const float w_d = wd[o];
      const float ad = gd * w_d;
      term[k][0] = ad;
      term[k][1] = ad * xg;
      term[k][2] = ad * yg;
      term[k][3] = w_d > 0.0f ? gd : 0.0f;
      key_d[k] = amind[o];
    }
    if constexpr (kM) {
      const float am = g_dist[o] * wm[o];
      term[k][kM0 + 0] = am;
      term[k][kM0 + 1] = am * xg;
      term[k][kM0 + 2] = am * yg;
      term[k][kM0 + 3] = am * z_plane[p];
      key_m[k] = aminm[o];
    }
  }

  for (int j = 0; j < num_j; ++j) {
    bool mine = false;
#pragma unroll
    for (int k = 0; k < kPixelsPerThread; ++k) mine |= (key_d[k] == j) || (key_m[k] == j);
    float* slot = partial + ((size_t)j * kBwdWarps + warp) * kSums;
    if (!__any_sync(kFull, mine)) {
      if (lane < kSums) slot[lane] = 0.0f;
      continue;
    }
    float sum[kSums];
#pragma unroll
    for (int s = 0; s < kSums; ++s) sum[s] = 0.0f;
#pragma unroll
    for (int k = 0; k < kPixelsPerThread; ++k) {
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
#pragma unroll
      for (int s = 0; s < kSums; ++s) slot[s] = sum[s];
    }
  }
  __syncthreads();

  for (int j = threadIdx.x; j < num_j; j += blockDim.x) {
    float t[kSums];
#pragma unroll
    for (int s = 0; s < kSums; ++s) t[s] = 0.0f;
    for (int w = 0; w < kBwdWarps; ++w) {
      const float* slot = partial + ((size_t)j * kBwdWarps + w) * kSums;
#pragma unroll
      for (int s = 0; s < kSums; ++s) t[s] += slot[s];
    }
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
  const dim3 grid((size * size + kFwdThreads - 1) / kFwdThreads, n);
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
  const size_t smem = (size_t)num_j * kBwdWarps * num_sums<kFields>() * sizeof(float);
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
  if (num_j > kMaxJ || n > 65535) return (int)cudaErrorInvalidValue;
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
  if (size * size > kPixelsPerThread * kBwdThreads) return (int)cudaErrorInvalidValue;
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
