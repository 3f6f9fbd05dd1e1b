// Triangle z-buffer rasterizers for Hopper (sm_90a), bound with ctypes.
//
// Two kernels replace the TPU Pallas kernels of
// spherehand_tpu/render/raster_pallas.py:
//
//   raster_fast_pooled  <- _raster_kernel_fast_paired (raster_pallas.py:633)
//       half-plane coverage on raw barycentrics (w2 = 1 - w0 - w1), depth
//       1/q from the fused affine reciprocal-depth row, z-min over faces,
//       epilogue ((t0 + t1) + (t2 + t3)) * 0.25 of min(z, clamp) written
//       straight into the pooled (B, H, W) canvas.
//   raster_exact        <- _raster_kernel_exact (raster_pallas.py:756)
//       the reference CUDA scanline-span coverage (ceil/trunc spans,
//       vertical-edge flags, precomputed column bounds), depth from clamped
//       and renormalised barycentrics with IEEE division, NaN = uncovered,
//       raw (B, Sy, Sx) buffer with background 1000.
//
// Inputs come from the PyTorch pre-pass (render/raster_cuda.py): per image
// F face records in the JAX field layouts (9 or 24 floats) and a per-face box
// [xmin, xmax, ymin, ymax] (culled faces carry an empty box).
//
// Design. One block of 256 threads per (image, tile of 32 x 8 samples or
// output pixels); a warp owns one tile row. The block walks the face list in
// chunks of 256: each thread tests one face's box against the tile's sample
// range, a ballot compacts the hits, and the hits' records are staged in
// shared memory (field-major, so the inner loop reads them as broadcasts).
// Every thread then keeps its z-min in registers over the staged faces,
// skipping a face for the whole warp when the box misses the warp's row (the
// test is warp-uniform, so no divergence). No atomics, no inter-block
// communication: the result does not depend on scheduling order.
//
// What bounds it on this card: the least time is set by the bytes (records
// of 36 or 96 bytes a face, boxes, canvas: tens of MB at B = 1024 against
// 3.35 TB/s); the face-sample tests a binned render needs (about 22
// operations a test in fast mode, 47 in exact mode, against 67 TFLOP/s
// float32) cost less. What the design spends instead is the per-tile scan:
// every block reads all F face boxes from L2 to find the few that reach
// its tile, and only those are tested, the per-warp row test removing most
// of the rest. It does not sort faces into bins (the TPU's pre-pass sort
// was its largest cost); a coarse per-image binning pass would shorten the
// scan.
//
// Numerics. Built with -fmad=false and without fast math: every product and
// sum rounds on its own, divisions are IEEE, so span bounds (ceilf/truncf)
// and depth bits match the plain PyTorch versions operation for operation.
// The expression order below is that of the plain versions.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kThreads = kTileW * kTileH;
constexpr int kWarps = kThreads / 32;
constexpr int kFieldsFast = 9;
constexpr int kFieldsExact = 24;
constexpr float kBackground = 1000.0f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Block-wide range of the samples the block's threads own. range[0..3] =
// x_lo, x_hi, y_lo, y_hi. Threads without samples pass +inf / -inf.
__device__ void block_range(float x_lo, float x_hi, float y_lo, float y_hi,
                            float (*s_part)[kWarps], float* range) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x_lo = warp_min(x_lo);
  x_hi = warp_max(x_hi);
  y_lo = warp_min(y_lo);
  y_hi = warp_max(y_hi);
  if (lane == 0) {
    s_part[0][warp] = x_lo;
    s_part[1][warp] = x_hi;
    s_part[2][warp] = y_lo;
    s_part[3][warp] = y_hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float r0 = INFINITY, r1 = -INFINITY, r2 = INFINITY, r3 = -INFINITY;
    for (int w = 0; w < kWarps; ++w) {
      r0 = fminf(r0, s_part[0][w]);
      r1 = fmaxf(r1, s_part[1][w]);
      r2 = fminf(r2, s_part[2][w]);
      r3 = fmaxf(r3, s_part[3][w]);
    }
    range[0] = r0;
    range[1] = r1;
    range[2] = r2;
    range[3] = r3;
  }
  __syncthreads();
}

// Stage the faces [base, base + kThreads) whose box meets the tile range:
// their boxes into s_box[0..n) and their records field-major into
// s_rec[k * kThreads + slot]. Returns n, the same in every thread. The
// caller syncs before it stages the next chunk.
template <int kFields>
__device__ int stage_faces(const float* __restrict__ rec, const float4* __restrict__ box,
                           int base, int num_faces, const float* range,
                           float* s_rec, float4* s_box, int* s_count) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int f = base + tid;
  bool hit = false;
  float4 bd = make_float4(0.f, 0.f, 0.f, 0.f);
  if (f < num_faces) {
    bd = box[f];
    hit = bd.y >= range[0] && bd.x <= range[1] && bd.w >= range[2] && bd.z <= range[3];
  }
  const unsigned mask = __ballot_sync(kFull, hit);
  if (lane == 0) s_count[warp] = __popc(mask);
  __syncthreads();
  int offset = 0, total = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int c = s_count[w];
    offset += (w < warp) ? c : 0;
    total += c;
  }
  if (hit) {
    const int slot = offset + __popc(mask & ((1u << lane) - 1u));
    s_box[slot] = bd;
    const float* r = rec + (size_t)f * kFields;
#pragma unroll
    for (int k = 0; k < kFields; ++k) s_rec[k * kThreads + slot] = r[k];
  }
  __syncthreads();
  return total;
}

__device__ __forceinline__ float clamp01(float w) {
  // NaN passes through, as torch.clamp and jnp.clip do.
  return w < 0.0f ? 0.0f : (w > 1.0f ? 1.0f : w);
}

// Thread (col, row) of the tile owns output pixel (oy, ox) and its four
// samples {sx[2ox], sx[2ox+1]} x {sy[2oy], sy[2oy+1]}.
__global__ void __launch_bounds__(kThreads)
raster_fast_pooled_kernel(const float* __restrict__ records, const float4* __restrict__ boxes,
                          const float* __restrict__ sample_x, const float* __restrict__ sample_y,
                          float* __restrict__ out, int num_faces, int out_w, int out_h,
                          float pool_clamp) {
  __shared__ float s_rec[kFieldsFast * kThreads];
  __shared__ float4 s_box[kThreads];
  __shared__ int s_count[kWarps];
  __shared__ float s_part[4][kWarps];
  __shared__ float s_range[4];

  const int b = blockIdx.z;
  const int ox = blockIdx.x * kTileW + (threadIdx.x & 31);
  const int oy = blockIdx.y * kTileH + (threadIdx.x >> 5);
  const bool col_ok = ox < out_w, row_ok = oy < out_h;  // row_ok is warp-uniform
  const float x0 = col_ok ? sample_x[2 * ox] : 0.0f;
  const float x1 = col_ok ? sample_x[2 * ox + 1] : 0.0f;
  const float y0 = row_ok ? sample_y[2 * oy] : 0.0f;
  const float y1 = row_ok ? sample_y[2 * oy + 1] : 0.0f;
  const bool own = col_ok && row_ok;
  const float wy_lo = fminf(y0, y1), wy_hi = fmaxf(y0, y1);  // same in the warp
  block_range(own ? fminf(x0, x1) : INFINITY, own ? fmaxf(x0, x1) : -INFINITY,
              own ? wy_lo : INFINITY, own ? wy_hi : -INFINITY, s_part, s_range);

  const float* rec = records + (size_t)b * num_faces * kFieldsFast;
  const float4* box = boxes + (size_t)b * num_faces;
  float z00 = kBackground, z01 = kBackground, z10 = kBackground, z11 = kBackground;

  for (int base = 0; base < num_faces; base += kThreads) {
    const int n = stage_faces<kFieldsFast>(rec, box, base, num_faces, s_range, s_rec, s_box,
                                           s_count);
    if (row_ok) {
      for (int k = 0; k < n; ++k) {
        const float4 bd = s_box[k];
        if (bd.w < wy_lo || bd.z > wy_hi) continue;  // warp-uniform row test
        const float a0 = s_rec[0 * kThreads + k], b0 = s_rec[1 * kThreads + k];
        const float c0 = s_rec[2 * kThreads + k], a1 = s_rec[3 * kThreads + k];
        const float b1 = s_rec[4 * kThreads + k], c1 = s_rec[5 * kThreads + k];
        const float aq = s_rec[6 * kThreads + k], bq = s_rec[7 * kThreads + k];
        const float cq = s_rec[8 * kThreads + k];
        auto test = [&](float x, float y, float& z) {
          if (!(x >= bd.x && x <= bd.y && y >= bd.z && y <= bd.w)) return;
          const float w0 = a0 * x + b0 * y + c0;
          const float w1 = a1 * x + b1 * y + c1;
          const float w2 = 1.0f - w0 - w1;
          if (w0 >= 0.0f && w1 >= 0.0f && w2 >= 0.0f) {
            z = fminf(z, 1.0f / (aq * x + bq * y + cq));  // fminf drops NaN
          }
        };
        test(x0, y0, z00);
        test(x1, y0, z01);
        test(x0, y1, z10);
        test(x1, y1, z11);
      }
    }
    __syncthreads();
  }
  if (own) {
    const float t0 = fminf(z00, pool_clamp), t1 = fminf(z01, pool_clamp);
    const float t2 = fminf(z10, pool_clamp), t3 = fminf(z11, pool_clamp);
    out[((size_t)b * out_h + oy) * out_w + ox] = ((t0 + t1) + (t2 + t3)) * 0.25f;
  }
}

// Thread (col, row) of the tile owns sample (j, i) at (sx[i], sy[j]).
__global__ void __launch_bounds__(kThreads)
raster_exact_kernel(const float* __restrict__ records, const float4* __restrict__ boxes,
                    const float* __restrict__ sample_x, const float* __restrict__ sample_y,
                    float* __restrict__ out, int num_faces, int sx_n, int sy_n, float height) {
  __shared__ float s_rec[kFieldsExact * kThreads];
  __shared__ float4 s_box[kThreads];
  __shared__ int s_count[kWarps];
  __shared__ float s_part[4][kWarps];
  __shared__ float s_range[4];

  const int b = blockIdx.z;
  const int i = blockIdx.x * kTileW + (threadIdx.x & 31);
  const int j = blockIdx.y * kTileH + (threadIdx.x >> 5);
  const bool col_ok = i < sx_n, row_ok = j < sy_n;  // row_ok is warp-uniform
  const float x = col_ok ? sample_x[i] : 0.0f;
  const float y = row_ok ? sample_y[j] : 0.0f;  // same in the warp
  const bool own = col_ok && row_ok;
  block_range(own ? x : INFINITY, own ? x : -INFINITY, own ? y : INFINITY,
              own ? y : -INFINITY, s_part, s_range);

  const float* rec = records + (size_t)b * num_faces * kFieldsExact;
  const float4* box = boxes + (size_t)b * num_faces;
  const float y_cap = height - 1.0f;
  float zbuf = kBackground;

  for (int base = 0; base < num_faces; base += kThreads) {
    const int n = stage_faces<kFieldsExact>(rec, box, base, num_faces, s_range, s_rec, s_box,
                                            s_count);
    if (row_ok) {
      for (int k = 0; k < n; ++k) {
        const float4 bd = s_box[k];
        if (bd.w < y || bd.z > y) continue;        // warp-uniform row test
        if (!(x >= bd.x && x <= bd.y)) continue;   // column span [xlo, xhi]
        const float* r = s_rec + k;
#define F(n) r[(n) * kThreads]
        const float p0x = F(0), p1x = F(1), p0y = F(3), p1y = F(4);
        float yi1;
        if (x <= p1x) {
          yi1 = F(9) > 0.5f ? p1y : F(6) * (x - p0x) + p0y;
        } else {
          yi1 = F(10) > 0.5f ? p1y : F(7) * (x - p1x) + p1y;
        }
        const float yi2 = F(8) * (x - p0x) + p0y;
        if (isnan(yi1) || isnan(yi2)) continue;  // min/max propagate NaN in the plain version
        const float y_lo = ceilf(fminf(yi1, yi2));
        const float y_hi = truncf(fminf(fmaxf(yi1, yi2), y_cap));
        if (!(y >= y_lo && y <= y_hi)) continue;
        const float w0 = clamp01(F(14) * x + F(16) + F(15) * y);
        const float w1 = clamp01(F(17) * x + F(19) + F(18) * y);
        const float w2 = clamp01(F(20) * x + F(22) + F(21) * y);
        const float w_sum = w0 + w1 + w2;
        const float inv_z = (w0 * F(11) + w1 * F(12) + w2 * F(13)) / w_sum;
        const float depth = 1.0f / inv_z;
#undef F
        if (w_sum > 0.0f && !isnan(depth)) zbuf = fminf(zbuf, depth);
      }
    }
    __syncthreads();
  }
  if (own) out[((size_t)b * sy_n + j) * sx_n + i] = zbuf;
}

dim3 grid_for(int w, int h, int batch) {
  return dim3((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, batch);
}

}  // namespace

extern "C" {

// records (B, F, 9), boxes (B, F, 4), sample_x (2W,), sample_y (2H,),
// out (B, H, W). Returns cudaGetLastError() after the launch.
int shx_raster_fast_pooled(const float* records, const float* boxes, const float* sample_x,
                           const float* sample_y, float* out, int batch, int num_faces,
                           int out_w, int out_h, float pool_clamp, void* stream) {
  if (batch > 0 && out_w > 0 && out_h > 0) {
    raster_fast_pooled_kernel<<<grid_for(out_w, out_h, batch), kThreads, 0,
                                (cudaStream_t)stream>>>(
        records, reinterpret_cast<const float4*>(boxes), sample_x, sample_y, out, num_faces,
        out_w, out_h, pool_clamp);
  }
  return (int)cudaGetLastError();
}

// records (B, F, 24), boxes (B, F, 4), sample_x (Sx,), sample_y (Sy,),
// out (B, Sy, Sx). Returns cudaGetLastError() after the launch.
int shx_raster_exact(const float* records, const float* boxes, const float* sample_x,
                     const float* sample_y, float* out, int batch, int num_faces, int sx_n,
                     int sy_n, float height, void* stream) {
  if (batch > 0 && sx_n > 0 && sy_n > 0) {
    raster_exact_kernel<<<grid_for(sx_n, sy_n, batch), kThreads, 0, (cudaStream_t)stream>>>(
        records, reinterpret_cast<const float4*>(boxes), sample_x, sample_y, out, num_faces,
        sx_n, sy_n, height);
  }
  return (int)cudaGetLastError();
}

const char* shx_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
