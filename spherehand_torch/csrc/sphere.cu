// Fused sphere-field kernels of the mutual-projection loss, for Hopper
// (sm_90a), bound with ctypes.
//
// They replace the TPU Pallas kernels behind the custom-VJP op
// sphere_min_depth_and_d2m of spherehand_tpu/render/sphere_pallas.py:
//
//   sphere_fused<false>  <- _fused_primal_kernel (sphere_pallas.py:227)
//   sphere_fused<true>   <- _fused_fwd_kernel    (sphere_pallas.py:253)
//       per image n and pixel p, one loop over the J spheres that keeps
//       - the min orthographic sphere depth cz - sqrt(max(sq, 1e-2)) with
//         sq = r^2 - dx^2 - dy^2 (background 100 where sq <= 1e-2), and
//       - the nearest-surface distance |sqrt(max(raw, 1e-6)) - r| of the
//         observed point (x, y, z), raw = |p|^2 - 2 p.c + |c|^2, 0 where the
//         observed z > 99;
//       with residuals it also writes, for each field, the argmin plane
//       (lowest j on a tie) and the gradient-weight plane of the winning
//       sphere: 1/sqrt(max(sq, 1e-2)) inside the silhouette (else 0), and
//       sign(root - r)/root (0 on background and where raw < 1e-6).
//   sphere_fused_bwd     <- _fused_bwd_kernel    (sphere_pallas.py:308)
//       the summed (N, J, 3) centre gradient of both fields from the stored
//       planes: with A_d = g_d w_d and A_m = g_m w_m,
//         g_x = c_x (S A_d + S A_m) - S A_d x - S A_m x   (y alike),
//         g_z = S [w_d > 0] g_d + c_z S A_m - S A_m z,
//       each S a masked sum over the pixels whose argmin is j.
//
// The observed depth of image n = (b, i, j) of a (B, V, V) pair grid is the
// target plane b * V + j: the kernels read it in place and never build the
// (B, V, V, S, S) broadcast.
//
// What bounds them on this card (counted by chip_smoke.py from this
// source): at N = 225, J = 41, S = 64 the forward makes 37.8 M pixel-sphere
// updates of 33 operations (28 without residuals), about 19 us of float32
// work at 67 TFLOP/s, against about 7 us to write its six planes: it is
// bound by operations. The design keeps the J loop in registers with the
// image's spheres in shared memory (one block of 256 pixels per image row
// group), so no (N, J, S, S) intermediate touches memory. The backward
// reads seven planes (about 7 us) and does little arithmetic: it is bound
// by bytes. One block of 1024 threads owns one image and keeps its four
// pixels' weighted terms in registers; for each sphere j a warp that owns
// no pixel of j skips it (a warp-uniform vote), the others reduce their
// eight sums with a fixed butterfly of shuffles into shared memory, and
// one thread per sphere adds the 32 warp partials in warp order. No
// atomics: two runs give the same bits.
//
// Numerics. Built with -fmad=false and without fast math, so every product
// and sum rounds on its own and sqrt and division are IEEE. The expression
// order is that of the TPU kernels and of the plain PyTorch versions
// (render/sphere_cuda.py): the grid is ((u - S/2) * 300) / S as two
// operations, sq = (r*r - dx*dx) - dy*dy, raw = (p_sq - 2 p.c) + c_sq, and
// a strict < keeps the lowest j on a tie, so forward fields and argmins are
// bit-identical to the plain versions. The depth weight is 1.0f / sqrtf(x)
// (the TPU kernel's rsqrt would differ from the plain version in the last
// bit).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kFwdThreads = 256;
constexpr int kBwdThreads = 1024;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kPixelsPerThread = 4;  // S * S <= 4096
constexpr int kSums = 8;
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

template <bool kResiduals>
__global__ void __launch_bounds__(kFwdThreads)
sphere_fused(const float* __restrict__ centers,  // (N, J, 3)
             const float* __restrict__ radii,    // (J,)
             const float* __restrict__ target,   // (N / V, S, S)
             int num_j, int size, int views,
             float* __restrict__ depth, float* __restrict__ dist,
             int* __restrict__ amind, float* __restrict__ wd,
             int* __restrict__ aminm, float* __restrict__ wm) {
  __shared__ float4 sphere[kMaxJ];  // cx, cy, cz, r
  __shared__ float r_sq[kMaxJ];
  __shared__ float c_sq[kMaxJ];
  const int n = blockIdx.y;
  const int pixels = size * size;
  for (int j = threadIdx.x; j < num_j; j += blockDim.x) {
    const float* c = centers + ((size_t)n * num_j + j) * 3;
    const float cx = c[0], cy = c[1], cz = c[2], r = radii[j];
    sphere[j] = make_float4(cx, cy, cz, r);
    r_sq[j] = r * r;
    c_sq[j] = cx * cx + cy * cy + cz * cz;
  }
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= pixels) return;

  const float xg = grid_mm(p % size, size);
  const float yg = grid_mm(p / size, size);
  const float z = target[(size_t)target_plane(n, views) * pixels + p];
  const float p_sq = xg * xg + yg * yg + z * z;
  const bool background = z > 99.0f;

  float best_d = INFINITY, best_sq = 0.0f;
  float best_m = INFINITY, best_raw = 0.0f, best_r = 0.0f;
  int best_jd = 0, best_jm = 0;
  for (int j = 0; j < num_j; ++j) {
    const float4 s = sphere[j];
    const float dx = xg - s.x;
    const float dy = yg - s.y;
    const float sq = r_sq[j] - dx * dx - dy * dy;
    const float d = sq > 1e-2f ? s.z - sqrtf(fmaxf(sq, 1e-2f)) : kBackground;
    if (d < best_d) {
      best_d = d;
      best_jd = j;
      best_sq = sq;
    }
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
  const size_t o = (size_t)n * pixels + p;
  depth[o] = best_d;
  dist[o] = best_m;
  if (kResiduals) {
    amind[o] = best_jd;
    wd[o] = best_sq > 1e-2f ? 1.0f / sqrtf(fmaxf(best_sq, 1e-2f)) : 0.0f;
    aminm[o] = best_jm;
    const float root = sqrtf(fmaxf(best_raw, 1e-6f));
    const float diff = root - best_r;
    const float sign = (float)((diff > 0.0f) - (diff < 0.0f));
    wm[o] = (background || best_raw < 1e-6f) ? 0.0f : sign / root;
  }
}

__global__ void __launch_bounds__(kBwdThreads)
sphere_fused_bwd(const float* __restrict__ centers,  // (N, J, 3)
                 const float* __restrict__ target,   // (N / V, S, S)
                 const float* __restrict__ g_depth,  // (N, S, S)
                 const float* __restrict__ g_dist,
                 const int* __restrict__ amind,
                 const float* __restrict__ wd,
                 const int* __restrict__ aminm,
                 const float* __restrict__ wm,
                 int num_j, int size, int views,
                 float* __restrict__ out) {          // (N, J, 3)
  extern __shared__ float partial[];  // [J][kBwdWarps][kSums]
  const int n = blockIdx.x;
  const int pixels = size * size;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* z_plane = target + (size_t)target_plane(n, views) * pixels;

  // Per pixel: the two argmin keys and the eight weighted terms
  // A_d, A_d x, A_d y, [w_d > 0] g_d, A_m, A_m x, A_m y, A_m z.
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
    const float gd = g_depth[o];
    const float w_d = wd[o];
    const float ad = gd * w_d;
    term[k][0] = ad;
    term[k][1] = ad * xg;
    term[k][2] = ad * yg;
    term[k][3] = w_d > 0.0f ? gd : 0.0f;
    const float am = g_dist[o] * wm[o];
    term[k][4] = am;
    term[k][5] = am * xg;
    term[k][6] = am * yg;
    term[k][7] = am * z_plane[p];
    key_d[k] = amind[o];
    key_m[k] = aminm[o];
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
      if (key_d[k] == j) {
#pragma unroll
        for (int s = 0; s < 4; ++s) sum[s] += term[k][s];
      }
      if (key_m[k] == j) {
#pragma unroll
        for (int s = 4; s < kSums; ++s) sum[s] += term[k][s];
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
    g[0] = c[0] * (t[0] + t[4]) - t[1] - t[5];
    g[1] = c[1] * (t[0] + t[4]) - t[2] - t[6];
    g[2] = t[3] + c[2] * t[4] - t[7];
  }
}

}  // namespace

extern "C" {

// Forward of both fields. residuals != 0 also writes amind, wd, aminm, wm
// (else those pointers are ignored). Returns cudaGetLastError() after the
// launch.
int shx_sphere_fused(const float* centers, const float* radii, const float* target,
                     int n, int num_j, int size, int views,
                     float* depth, float* dist, int* amind, float* wd, int* aminm,
                     float* wm, int residuals, void* stream) {
  if (num_j > kMaxJ || n > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((size * size + kFwdThreads - 1) / kFwdThreads, n);
  cudaStream_t s = (cudaStream_t)stream;
  if (residuals) {
    sphere_fused<true><<<grid, kFwdThreads, 0, s>>>(
        centers, radii, target, num_j, size, views, depth, dist, amind, wd, aminm, wm);
  } else {
    sphere_fused<false><<<grid, kFwdThreads, 0, s>>>(
        centers, radii, target, num_j, size, views, depth, dist, nullptr, nullptr,
        nullptr, nullptr);
  }
  return (int)cudaGetLastError();
}

// Summed centre gradient (N, J, 3) of both fields. Returns
// cudaGetLastError() after the launch.
int shx_sphere_fused_bwd(const float* centers, const float* target, const float* g_depth,
                         const float* g_dist, const int* amind, const float* wd,
                         const int* aminm, const float* wm, int n, int num_j, int size,
                         int views, float* out, void* stream) {
  if (size * size > kPixelsPerThread * kBwdThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)num_j * kBwdWarps * kSums * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sphere_fused_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  sphere_fused_bwd<<<n, kBwdThreads, smem, (cudaStream_t)stream>>>(
      centers, target, g_depth, g_dist, amind, wd, aminm, wm, num_j, size, views, out);
  return (int)cudaGetLastError();
}

const char* shx_sphere_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
