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
// that fall inside the image. The rows first (one value a tap column), then
// the columns.
//
// Backward. Input row k receives output rows 2k-1, 2k, 2k+1 and 2k+2 with
// weights 0.25, 0.75, 0.75, 0.25; at the first row the weight of row 2k is
// 1.0 (both taps of output row 0 read row 0) and row 2k-1 does not exist, at
// the last row the weight of row 2k+1 is 1.0 and row 2k+2 does not exist;
// columns alike. Each input element gathers its 4 x 4 output neighbourhood:
// each output row's four columns first, in column order, then the four rows
// in row order, a missing row or column adding 0.25 * 0. No atomics: every
// element is written by one thread in a fixed order, so two launches give
// the same bits.
//
// Numerics. Built with -fmad=false: every product and sum rounds on its own,
// in float32, in the order written above, which is the order of the plain
// versions (ops/upsample.py upsample2x_plain, upsample2x_bwd_plain), so the
// kernels equal them bit for bit. bf16 planes are read into float32 and
// rounded once on store (round to nearest even, as Tensor.to(bfloat16)).
//
// What bounds them on this card: bytes. At B = 128 the hourglass's two calls
// read 8.4 + 2.1 MB and write 4x that in float32, 15.6 us at 3.35 TB/s, and
// do about 6 operations an output element (forward) or 28 an input element
// (backward). The planes are tiny (4 x 4 -> 8 x 8 and 8 x 8 -> 16 x 16 at 256
// channels), so a design of one thread an element spends more on its
// indices (64-bit divisions, three an element) and on scalar loads and
// stores than on the bytes. This design:
//
// - A thread owns a work item of one plane: in the forward, output rows
//   2k and 2k+1 at output columns 4q .. 4q+3 (8 outputs, from input rows
//   k-1 .. k+1 and columns 2q-1 .. 2q+2, clamped: 12 loads staged in
//   registers, each used two to four times); in the backward, input row k
//   at columns 4p .. 4p+3 (4 outputs, from output rows 2k-1 .. 2k+2 and
//   columns 8p-1 .. 8p+8: 40 values staged in registers, each row's eight
//   middle ones by two 16-byte loads).
// - Stores are 16 bytes (float32) or 8 bytes (bf16) a row of the item where
//   the width allows (forward: w even; backward: w a multiple of 4, and the
//   cotangent 16-byte aligned), else element by element with the edge cut.
// - A block of 256 threads takes 256 / n whole planes when a plane has n <=
//   256 items (the hourglass's planes: 8 or 32 items forward, 4 or 16
//   backward), else ceil(n / 256) blocks take one plane. Offsets inside a
//   plane are 32-bit; small planes divide only 32-bit thread indices by
//   the item counts, a large plane's unit is divided once; the plane's base
//   is 64-bit. The grid has at most 65,535 blocks and each loops over its
//   units, so any plane count runs.
//
// On an H100 (PERF.md, upsample table) both hourglass calls at B = 128 take
// 0.0192 device ms forward and 0.0271 backward, against a bound of 0.0157
// (the one-thread-an-element design: 0.0711 and 0.0313).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 65535;
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Eight consecutive values from a 16-byte aligned address.
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t words[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    v[2 * t] = __uint_as_float(words[t] << 16);
    v[2 * t + 1] = __uint_as_float(words[t] & 0xffff0000u);
  }
}

// Four consecutive values to an aligned address (16 bytes float32, 8 bf16).
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(bf16_bits(v[0]) | (bf16_bits(v[1]) << 16),
                                            bf16_bits(v[2]) | (bf16_bits(v[3]) << 16));
}

// Up to four values of a row: all four by one store where ``vec``, else the
// first ``count`` one by one.
template <typename T>
__device__ __forceinline__ void store_run(T* p, const float* v, int count, bool vec) {
  if (vec) {
    store4(p, v);
    return;
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (t < count) store(p + t, v[t]);
  }
}

// How the grid walks over work items: a unit is one block's share. Planes of
// ``items`` <= kThreads work items go ``per_block`` to a unit; larger ones
// take ``units_per_plane`` units each.
struct Walk {
  int64_t planes;
  int items;
  int per_block;        // > 0: small planes
  int units_per_plane;  // > 0: large planes
  int64_t units;
};

// The plane and work item of this thread in ``unit``; false if it has none.
__device__ __forceinline__ bool locate(const Walk& wk, int64_t unit, int64_t& plane, int& item) {
  if (wk.per_block > 0) {
    const int local = (int)threadIdx.x / wk.items;
    if (local >= wk.per_block) return false;
    plane = unit * wk.per_block + local;
    item = (int)threadIdx.x - local * wk.items;
    return plane < wk.planes;
  }
  plane = unit / wk.units_per_plane;
  item = (int)(unit - plane * wk.units_per_plane) * kThreads + (int)threadIdx.x;
  return item < wk.items;
}

// Forward work item (k, q): output rows 2k, 2k+1 at columns 4q .. 4q+3.
template <typename T>
__global__ void __launch_bounds__(kThreads)
upsample2x_fwd(const T* __restrict__ x, T* __restrict__ y, Walk wk, int h, int w, bool vec) {
  const int qw = (w + 1) >> 1, ow = 2 * w;
  for (int64_t unit = blockIdx.x; unit < wk.units; unit += gridDim.x) {
    int64_t plane;
    int item;
    if (!locate(wk, unit, plane, item)) continue;
    const int k = item / qw, q = item - k * qw;
    const T* src = x + plane * (int64_t)(h * w);
    T* dst = y + plane * (int64_t)(4 * h * w) + (2 * k) * ow + 4 * q;
    const int rows[3] = {max(k - 1, 0) * w, k * w, min(k + 1, h - 1) * w};
    int cols[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) cols[t] = min(max(2 * q - 1 + t, 0), w - 1);
    float a[3][4];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int t = 0; t < 4; ++t) a[r][t] = load(src + rows[r] + cols[t]);
    }
    // the rows: even output row 0.25 above + 0.75 own, odd 0.75 own + 0.25 below
    float even[4], odd[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      even[t] = 0.25f * a[0][t] + 0.75f * a[1][t];
      odd[t] = 0.75f * a[1][t] + 0.25f * a[2][t];
    }
    // the columns 4q .. 4q+3 from tap columns 2q-1 .. 2q+2
    const int count = min(4, ow - 4 * q);
    float out[4];
    out[0] = 0.25f * even[0] + 0.75f * even[1];
    out[1] = 0.75f * even[1] + 0.25f * even[2];
    out[2] = 0.25f * even[1] + 0.75f * even[2];
    out[3] = 0.75f * even[2] + 0.25f * even[3];
    store_run(dst, out, count, vec);
    out[0] = 0.25f * odd[0] + 0.75f * odd[1];
    out[1] = 0.75f * odd[1] + 0.25f * odd[2];
    out[2] = 0.25f * odd[1] + 0.75f * odd[2];
    out[3] = 0.75f * odd[2] + 0.25f * odd[3];
    store_run(dst + ow, out, count, vec);
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

// Backward work item (k, p): input row k at columns 4p .. 4p+3, from output
// rows 2k-1 .. 2k+2 and output columns 8p-1 .. 8p+8 (v[0] .. v[9]).
template <typename T>
__global__ void __launch_bounds__(kThreads)
upsample2x_bwd(const T* __restrict__ g, T* __restrict__ gx, Walk wk, int h, int w, bool vec) {
  const int pw = (w + 3) >> 2, oh = 2 * h, ow = 2 * w;
  for (int64_t unit = blockIdx.x; unit < wk.units; unit += gridDim.x) {
    int64_t plane;
    int item;
    if (!locate(wk, unit, plane, item)) continue;
    const int k = item / pw, p = item - k * pw;
    const T* src = g + plane * (int64_t)(4 * h * w);
    const int c0 = 8 * p - 1;
    float rows[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int r = 2 * k - 1 + t;
      if (r < 0 || r >= oh) {
#pragma unroll
        for (int s = 0; s < 4; ++s) rows[t][s] = 0.0f;
        continue;
      }
      const T* row = src + r * ow;
      float v[10];
      v[0] = c0 >= 0 ? load(row + c0) : 0.0f;
      if (vec) {
        load8(row + c0 + 1, v + 1);
      } else {
#pragma unroll
        for (int l = 1; l < 9; ++l) v[l] = c0 + l < ow ? load(row + c0 + l) : 0.0f;
      }
      v[9] = c0 + 9 < ow ? load(row + c0 + 9) : 0.0f;
#pragma unroll
      for (int s = 0; s < 4; ++s)
        rows[t][s] = gather4(4 * p + s, w, v[2 * s], v[2 * s + 1], v[2 * s + 2], v[2 * s + 3]);
    }
    float out[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) out[s] = gather4(k, h, rows[0][s], rows[1][s], rows[2][s],
                                                 rows[3][s]);
    store_run(gx + plane * (int64_t)(h * w) + k * w + 4 * p, out, min(4, w - 4 * p), vec);
  }
}

Walk walk_for(int64_t planes, int items) {
  Walk wk{planes, items, 0, 0, 0};
  if (items <= kThreads) {
    wk.per_block = kThreads / items;
    wk.units = (planes + wk.per_block - 1) / wk.per_block;
  } else {
    wk.units_per_plane = (items + kThreads - 1) / kThreads;
    wk.units = planes * wk.units_per_plane;
  }
  return wk;
}

bool aligned(const void* p, uintptr_t bytes) { return ((uintptr_t)p % bytes) == 0; }

template <typename T>
cudaError_t launch(bool backward, const void* in, void* out, int64_t planes, int h, int w,
                   cudaStream_t s) {
  // offsets inside a plane are 32-bit: the larger plane (2h x 2w) must fit
  if (4LL * h * w > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (planes == 0) return cudaSuccess;
  const int items = backward ? h * ((w + 3) / 4) : h * ((w + 1) / 2);
  const Walk wk = walk_for(planes, items);
  const unsigned blocks = (unsigned)(wk.units < kMaxBlocks ? wk.units : kMaxBlocks);
  if (backward) {
    const bool vec = w % 4 == 0 && aligned(in, 16) && aligned(out, 4 * sizeof(T));
    upsample2x_bwd<T><<<blocks, kThreads, 0, s>>>((const T*)in, (T*)out, wk, h, w, vec);
  } else {
    const bool vec = w % 2 == 0 && aligned(out, 4 * sizeof(T));
    upsample2x_fwd<T><<<blocks, kThreads, 0, s>>>((const T*)in, (T*)out, wk, h, w, vec);
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
