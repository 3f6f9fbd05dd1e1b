// 2x bilinear upsample of the hourglass (half-pixel centres), forward and
// backward, for Hopper (sm_90a), bound with ctypes.
//
// They replace no Pallas kernel. The JAX package upsamples with
// jax.image.resize(..., "bilinear") (spherehand_tpu/models/hourglass.py:86-89),
// which XLA lowers to two small weight contractions. The port had used
// PyTorch's upsample_bilinear2d, whose backward adds with atomics (its result
// changes from run to run, and torch.use_deterministic_algorithms refuses
// it) and which was 70 % of PoseEstimator.predict's device time on the H100
// (PERF.md). These two kernels take its place on the port's path
// (spherehand_torch/ops/upsample.py).
//
//   upsample2x_fwd: (P, H, W) -> (P, 2H, 2W), P = N * C planes;
//   upsample2x_bwd: (P, 2H, 2W) cotangent -> (P, H, W) gradient.
//
// Forward. Output row 2k takes 0.25 of input row k-1 and 0.75 of row k; row
// 2k+1 takes 0.75 of row k and 0.25 of row k+1; columns alike. An index past
// the edge reads the border row or column (so out row 0 is 0.25 x0 + 0.75 x0,
// the border), which is jax.image.resize's rule: it renormalises the weights
// that fall inside the image. One thread an output element: the rows first
// (one value a tap column), then the columns.
//
// Backward. Input row k receives output rows 2k-1, 2k, 2k+1 and 2k+2 with
// weights 0.25, 0.75, 0.75, 0.25; at the first row the weight of row 2k is
// 1.0 (both taps of output row 0 read row 0) and row 2k-1 does not exist, at
// the last row the weight of row 2k+1 is 1.0 and row 2k+2 does not exist;
// columns alike. One thread an input element gathers its 4 x 4 output
// neighbourhood: each output row's four columns first, in column order, then
// the four rows in row order, a missing row or column adding 0.25 * 0. No
// atomics: every element is written by one thread in a fixed order, so two
// launches give the same bits.
//
// Numerics. Built with -fmad=false: every product and sum rounds on its own,
// in float32, in the order written above, which is the order of the plain
// versions (ops/upsample.py upsample2x_plain, upsample2x_bwd_plain), so the
// kernels equal them bit for bit. bf16 planes are read into float32 and
// rounded once on store (round to nearest even, as Tensor.to(bfloat16)).
//
// What bounds them on this card: bytes. At B = 128 the hourglass's two calls
// read 8.4 + 2.1 MB and write 4x that in float32, a few microseconds at
// 3.35 TB/s, and do about 6 operations an output element (forward) or 28 an
// input element (backward). The simple design reads each input element
// through L1 four times (forward) and each cotangent element four times
// (backward); wide vector loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// The two taps of output index i along an axis of n inputs: (a, wa), (b, wb).
__device__ __forceinline__ void taps(int i, int n, int& a, float& wa, int& b, float& wb) {
  const int k = i >> 1;
  if (i & 1) {
    a = k;
    wa = 0.75f;
    b = min(k + 1, n - 1);
    wb = 0.25f;
  } else {
    a = max(k - 1, 0);
    wa = 0.25f;
    b = k;
    wb = 0.75f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
upsample2x_fwd(const T* __restrict__ x, T* __restrict__ y, int64_t total, int h, int w) {
  const int oh = 2 * h, ow = 2 * w;
  for (int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x; idx < total;
       idx += (int64_t)gridDim.x * kThreads) {
    const int j = (int)(idx % ow);
    const int i = (int)((idx / ow) % oh);
    const T* plane = x + (idx / ((int64_t)ow * oh)) * h * w;
    int ra, rb, ca, cb;
    float wa, wb, wca, wcb;
    taps(i, h, ra, wa, rb, wb);
    taps(j, w, ca, wca, cb, wcb);
    const float va = wa * load(plane + ra * w + ca) + wb * load(plane + rb * w + ca);
    const float vb = wa * load(plane + ra * w + cb) + wb * load(plane + rb * w + cb);
    store(y + idx, wca * va + wcb * vb);
  }
}

// The gathered sum of input index k along an axis of n inputs, from the
// four outputs 2k-1 .. 2k+2 (v0 .. v3; a missing one passed as 0):
// ((0.25 v0 + w1 v1) + w2 v2) + 0.25 v3.
__device__ __forceinline__ float gather4(int k, int n, float v0, float v1, float v2, float v3) {
  const float w1 = k == 0 ? 1.0f : 0.75f;
  const float w2 = k == n - 1 ? 1.0f : 0.75f;
  return ((0.25f * v0 + w1 * v1) + w2 * v2) + 0.25f * v3;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
upsample2x_bwd(const T* __restrict__ g, T* __restrict__ gx, int64_t total, int h, int w) {
  const int oh = 2 * h, ow = 2 * w;
  for (int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x; idx < total;
       idx += (int64_t)gridDim.x * kThreads) {
    const int m = (int)(idx % w);
    const int k = (int)((idx / w) % h);
    const T* plane = g + (idx / ((int64_t)w * h)) * oh * ow;
    float rows[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int r = 2 * k - 1 + t;
      if (r < 0 || r >= oh) {
        rows[t] = 0.0f;
        continue;
      }
      const T* row = plane + (int64_t)r * ow;
      const int c0 = 2 * m - 1;
      const float v0 = c0 >= 0 ? load(row + c0) : 0.0f;
      const float v3 = c0 + 3 < ow ? load(row + c0 + 3) : 0.0f;
      rows[t] = gather4(m, w, v0, load(row + c0 + 1), load(row + c0 + 2), v3);
    }
    store(gx + idx, gather4(k, h, rows[0], rows[1], rows[2], rows[3]));
  }
}

int64_t grid_for(int64_t total) {
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  return blocks > 0x7fffffffLL ? -1 : blocks;
}

template <typename T>
cudaError_t launch(bool backward, const void* in, void* out, int64_t planes, int h, int w,
                   cudaStream_t s) {
  const int64_t total = backward ? planes * h * w : planes * 4 * h * w;
  if (total == 0) return cudaSuccess;
  const int64_t blocks = grid_for(total);
  if (blocks < 0) return cudaErrorInvalidValue;
  if (backward) {
    upsample2x_bwd<T><<<(unsigned)blocks, kThreads, 0, s>>>((const T*)in, (T*)out, total, h, w);
  } else {
    upsample2x_fwd<T><<<(unsigned)blocks, kThreads, 0, s>>>((const T*)in, (T*)out, total, h, w);
  }
  return cudaGetLastError();
}

int dispatch(bool backward, const void* in, void* out, int64_t planes, int h, int w, int dtype,
             void* stream) {
  if (planes < 0 || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kFloat32:
      return (int)launch<float>(backward, in, out, planes, h, w, s);
    case kBFloat16:
      return (int)launch<__nv_bfloat16>(backward, in, out, planes, h, w, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x (planes, h, w) -> y (planes, 2h, 2w); dtype 0 float32, 1 bfloat16.
// Returns cudaGetLastError() after the launch.
int shx_upsample2x_fwd(const void* x, void* y, int64_t planes, int h, int w, int dtype,
                       void* stream) {
  return dispatch(false, x, y, planes, h, w, dtype, stream);
}

// g (planes, 2h, 2w) -> gx (planes, h, w); dtype as above.
int shx_upsample2x_bwd(const void* g, void* gx, int64_t planes, int h, int w, int dtype,
                       void* stream) {
  return dispatch(true, g, gx, planes, h, w, dtype, stream);
}

const char* shx_upsample_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
