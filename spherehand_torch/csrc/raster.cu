// Triangle z-buffer rasterizers for Hopper (sm_90a), bound with ctypes.
//
// Three kernels replace the TPU Pallas kernels of
// spherehand_tpu/render/raster_pallas.py:
//
//   raster_fast_pooled  <- _raster_kernel_fast_paired (raster_pallas.py:633)
//       half-plane coverage on raw barycentrics (w2 = 1 - w0 - w1), depth
//       1/q from the fused affine reciprocal-depth row, z-min over faces,
//       epilogue ((t0 + t1) + (t2 + t3)) * 0.25 of min(z, clamp) written
//       straight into the pooled (B, H, W) canvas.
//   raster_exact        <- _raster_kernel_exact (raster_pallas.py:756)
//       the reference CUDA scanline-span coverage (ceil/trunc spans,
//       vertical-edge flags), depth from clamped and renormalised
//       barycentrics with IEEE division, NaN = uncovered, raw (B, Sy, Sx)
//       buffer with background 1000.
//   raster_fast         <- _raster_kernel_fast (raster_pallas.py:524)
//       the fast coverage and depth (fast_cover) at any sample grid, one
//       sample a thread, raw (B, Sy, Sx) buffer with background 1000, no
//       pooling. It reads the records and face boxes of the PyTorch
//       pre-pass (render/raster_cuda.py: 9 floats and a box a face).
//
// The two main-path kernels, raster_fast_pooled and raster_exact, read the
// projected planes (u, v, z), each (B, 3F) in face-vertex order, and build
// every face's setup themselves: the vertex sort by x with the reference
// tie ladder, the back-face cull, the degenerate test, the box (fast: the
// vertex box grown by kBoxMargin; exact: the column span [ceil(p0x),
// trunc(min(p2x, W-1))] by the vertex y range +-1, unbounded in y where C
// truncation paints column 0 from right of p2x) and, for the faces that
// reach the block's tile, the record the plain pre-pass would build. Every
// expression keeps the plain pre-pass's order.
//
// Design of the two. One block of 512 threads per (image, z-tile of 64 x 64
// samples). The tile's depths live in shared memory as order-preserving
// integer keys (depth_key), initialised to the background.
//   Scan: the block walks the face list in rounds of 1,024 faces, two a
//   thread with their loads in flight together; it sets each face up, tests
//   its box against the tile's sample range, and a ballot compacts the
//   faces that reach the tile into a queue of face indices.
//   Drain, once 512 faces are queued (or the list ends), 512 at a time:
//   each thread builds one queued face's record into shared memory and, by
//   binary search over the tile's sorted sample coordinates, the samples its
//   box holds; a block prefix sum over the faces' work items (fast: one a
//   box sample; exact: one a span column, which computes the two polyline
//   edges and the row span once, then walks the rows inside it) spreads the
//   items over all threads, so no thread walks a large face alone. Each
//   covered sample folds its depth into the tile with a shared-memory
//   atomicMin on its key.
//   Epilogue: the tile, pooled (fast) or raw (exact), to device memory.
//
// Why faces over threads. A hand face covers a few samples of the 128 x 128
// grid. Giving each thread a sample and walking every staged face past it
// (as raster_fast does) makes a warp pay the whole coverage test for the one
// or two lanes inside the face; here only the samples a face's box holds
// are tested. A min is order-free, so the result does not depend on
// scheduling: two launches, and any face order, give the same bits. The one
// exception is the sign of zero: the key orders -0 below +0, so a sample
// that both reach keeps -0; the two are equal as depths.
//
// Why 64 x 64 samples and 512 threads. Every block scans all F faces of its
// image from L2 (24 bytes a face for the cull), so a larger tile reads the
// planes fewer times (4 tiles an image against 16 of 32 x 32), and at large
// batches, where the card is full, that wins. At the small batches of
// training (B = 25 a view of the real batch, 48 synthetic) a launch is as
// long as its slowest block, the tile that holds most of the hand (about
// three times the mean faces, five times the mean samples); 512 threads give
// that block twice the warps of 256 to hide its latency. The trade-off is
// measured by python -m spherehand_torch.raster_sweep.
//
// What bounds them on this card: the least time is set by the bytes (36
// bytes a face of planes, the canvas: tens of MB at B = 1024 against 3.35
// TB/s); the coverage tests and face setups cost less against 67 TFLOP/s
// float32. What the design spends instead is latency: each block's scan and
// drain rounds wait on L2 and on the block's barriers, the hand's heaviest
// tile sets a small launch's time, and every tile sets up every face of its
// image again. A per-image binning pass would take the repeated setups out.
//
// Numerics. Built with -fmad=false and without fast math: every product and
// sum rounds on its own, divisions are IEEE, so span bounds (ceilf/truncf)
// and depth bits match the plain PyTorch versions operation for operation.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kThreads = kTileW * kTileH;
constexpr int kWarps = kThreads / 32;
constexpr int kFieldsFast = 9;
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

// One staged fast face: its record and box, read from shared memory once
// for all the samples a thread owns.
struct FastFace {
  float a0, b0, c0, a1, b1, c1, aq, bq, cq;
  float4 box;
};

__device__ __forceinline__ FastFace load_fast_face(const float* s_rec, const float4* s_box,
                                                   int k) {
  FastFace f;
  f.a0 = s_rec[0 * kThreads + k];
  f.b0 = s_rec[1 * kThreads + k];
  f.c0 = s_rec[2 * kThreads + k];
  f.a1 = s_rec[3 * kThreads + k];
  f.b1 = s_rec[4 * kThreads + k];
  f.c1 = s_rec[5 * kThreads + k];
  f.aq = s_rec[6 * kThreads + k];
  f.bq = s_rec[7 * kThreads + k];
  f.cq = s_rec[8 * kThreads + k];
  f.box = s_box[k];
  return f;
}

// Fast-mode coverage of sample (x, y) by face f: inside the face box and all
// three raw barycentrics >= 0; a covered sample keeps min(z, 1/q) (fminf
// drops a NaN depth).
__device__ __forceinline__ void fast_cover(const FastFace& f, float x, float y, float& z) {
  if (!(x >= f.box.x && x <= f.box.y && y >= f.box.z && y <= f.box.w)) return;
  const float w0 = f.a0 * x + f.b0 * y + f.c0;
  const float w1 = f.a1 * x + f.b1 * y + f.c1;
  const float w2 = 1.0f - w0 - w1;
  if (w0 >= 0.0f && w1 >= 0.0f && w2 >= 0.0f) z = fminf(z, 1.0f / (f.aq * x + f.bq * y + f.cq));
}

// Thread (col, row) of the tile owns sample (j, i) at (sx[i], sy[j]).
__global__ void __launch_bounds__(kThreads)
raster_fast_kernel(const float* __restrict__ records, const float4* __restrict__ boxes,
                   const float* __restrict__ sample_x, const float* __restrict__ sample_y,
                   float* __restrict__ out, int num_faces, int sx_n, int sy_n) {
  __shared__ float s_rec[kFieldsFast * kThreads];
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

  const float* rec = records + (size_t)b * num_faces * kFieldsFast;
  const float4* box = boxes + (size_t)b * num_faces;
  float z = kBackground;

  for (int base = 0; base < num_faces; base += kThreads) {
    const int n = stage_faces<kFieldsFast>(rec, box, base, num_faces, s_range, s_rec, s_box,
                                           s_count);
    if (row_ok) {
      for (int k = 0; k < n; ++k) {
        if (s_box[k].w < y || s_box[k].z > y) continue;  // warp-uniform row test
        fast_cover(load_fast_face(s_rec, s_box, k), x, y, z);
      }
    }
    __syncthreads();
  }
  if (own) out[((size_t)b * sy_n + j) * sx_n + i] = z;
}

dim3 grid_for(int w, int h, int batch) {
  return dim3((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, batch);
}

// ------------------------------------------------- z-tile kernels (planes)

constexpr int kZTile = 64;                      // samples a side of a block's z-tile
constexpr int kZThreads = 512;                  // threads of a z-tile block
constexpr int kZWarps = kZThreads / 32;
constexpr int kPerThread = 2;                   // faces a thread culls in one scan round
constexpr int kChunk = kPerThread * kZThreads;  // faces one scan round culls
constexpr int kDrain = kZThreads;               // queued faces that start a drain
constexpr int kQueue = kDrain + kChunk;         // < kDrain left over + one round
constexpr int kBatch = kZThreads;               // records a drain round builds, one a thread
constexpr float kBoxMargin = 1.0f;       // raster_cuda.BOX_MARGIN

// Order-preserving key of a float depth: a < b as floats iff key(a) <
// key(b) as unsigned integers, for every value but NaN (which never reaches
// it); -0 keys below +0. raster_cuda.depth_key is its plain mirror.
__device__ __forceinline__ unsigned depth_key(float d) {
  const unsigned bits = __float_as_uint(d);
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

__device__ __forceinline__ float key_depth(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// First k in [0, n) with a[k] >= v, n if none (a sorted ascending).
__device__ __forceinline__ int lower_bound(const float* a, int n, float v) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (a[lo + half] < v) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

// First k in [0, n) with a[k] > v, n if none (a sorted ascending).
__device__ __forceinline__ int upper_bound(const float* a, int n, float v) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (a[lo + half] <= v) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

__device__ __forceinline__ float pick(int i, float a, float b, float c) {
  return i == 0 ? a : (i == 1 ? b : c);
}

// A face's vertices sorted by x with the reference tie ladder
// (raster.sort_order), the determinant of its barycentric inverse and the
// front-facing, non-degenerate test (raster_cuda._setup_cols). A NaN
// coordinate fails the back-face test, so a valid face's box is never NaN.
struct Sorted {
  float px0, px1, px2, py0, py1, py2;
  int o0, o1, o2;
  float den;
  bool valid;
};

__device__ __forceinline__ Sorted sort_face(const float* __restrict__ u,
                                            const float* __restrict__ v, int f) {
  const float x0 = u[3 * f], x1 = u[3 * f + 1], x2 = u[3 * f + 2];
  const float y0 = v[3 * f], y1 = v[3 * f + 1], y2 = v[3 * f + 2];
  Sorted s;
  const bool front = (y2 - y0) * (x1 - x0) >= (y1 - y0) * (x2 - x0);
  const bool c01 = x0 < x1;
  s.o0 = c01 ? (x2 < x0 ? 2 : 0) : (x2 < x1 ? 2 : 1);
  s.o2 = c01 ? (x1 < x2 ? 2 : 1) : (x0 < x2 ? 2 : 0);
  s.o1 = 3 - s.o0 - s.o2;
  s.px0 = pick(s.o0, x0, x1, x2);
  s.px1 = pick(s.o1, x0, x1, x2);
  s.px2 = pick(s.o2, x0, x1, x2);
  s.py0 = pick(s.o0, y0, y1, y2);
  s.py1 = pick(s.o1, y0, y1, y2);
  s.py2 = pick(s.o2, y0, y1, y2);
  s.den = s.px2 * (s.py0 - s.py1) + s.px0 * (s.py1 - s.py2) + s.px1 * (s.py2 - s.py0);
  s.valid = front && s.px0 != s.px2 && s.den != 0.0f;
  return s;
}

// Rows of the barycentric inverse, each [x-coef, y-coef, const] over the
// determinant (raster.barycentric_rows; a valid face has den != 0).
struct Rows {
  float a[3], b[3], c[3];
};

__device__ __forceinline__ Rows barycentric_rows(const Sorted& s) {
  Rows r;
  r.a[0] = (s.py1 - s.py2) / s.den;
  r.b[0] = (s.px2 - s.px1) / s.den;
  r.c[0] = (s.px1 * s.py2 - s.px2 * s.py1) / s.den;
  r.a[1] = (s.py2 - s.py0) / s.den;
  r.b[1] = (s.px0 - s.px2) / s.den;
  r.c[1] = (s.px2 * s.py0 - s.px0 * s.py2) / s.den;
  r.a[2] = (s.py0 - s.py1) / s.den;
  r.b[2] = (s.px1 - s.px0) / s.den;
  r.c[2] = (s.px0 * s.py1 - s.px1 * s.py0) / s.den;
  return r;
}

// The box a face is culled and (fast mode) clipped by: [x0, x1] x [y0, y1],
// as prepass_fast / prepass_exact build it.
struct Box {
  float x0, x1, y0, y1;
};

template <bool kExact>
__device__ __forceinline__ Box face_box(const Sorted& s, float width) {
  const float ymin = fminf(fminf(s.py0, s.py1), s.py2);
  const float ymax = fmaxf(fmaxf(s.py0, s.py1), s.py2);
  if constexpr (!kExact) {
    return {s.px0 - kBoxMargin, s.px2 + kBoxMargin, ymin - kBoxMargin, ymax + kBoxMargin};
  }
  const float xhi = truncf(fminf(s.px2, width - 1.0f));
  const bool extrapolated = xhi > s.px2;  // column 0 painted from right of p2x
  return {ceilf(s.px0), xhi, extrapolated ? -INFINITY : ymin - 1.0f,
          extrapolated ? INFINITY : ymax + 1.0f};
}

__device__ __forceinline__ float finite_or_zero(float c) { return isfinite(c) ? c : 0.0f; }

// Fields of a queued face's record in shared memory, field-major
// (rec[field * kBatch] for the face's slot in the drain round):
//   fast  0-2 row 0 [a b c], 3-5 row 1, 6-8 the reciprocal-depth row q
//         (prepass_fast, sanitised finite);
//   exact 0 p0x 1 p1x 2 p0y 3 p1y 4-6 slopes s01 s12 s02 7 vertical-edge
//         bits (01, 12) 8-10 1/z 11-13 a_k 14-16 b_k 17-19 c_k
//         (prepass_exact, rows of the barycentric inverse w_k = a x + b y + c).
constexpr int kRecFast = 9;
constexpr int kRecExact = 20;

// Fast mode: the record of face f into rec, and its box's sample range in
// the tile packed into ranges (ilo | ihi << 8 | jlo << 16). Returns its work
// items, one a sample of its box (0 if the box holds no sample of the tile).
__device__ int build_fast(const float* __restrict__ u, const float* __restrict__ v,
                          const float* __restrict__ z, int f, int nx, int ny,
                          const float* s_sx, const float* s_sy, float* rec, int& ranges) {
  const float z0 = z[3 * f], z1 = z[3 * f + 1], z2 = z[3 * f + 2];
  const Sorted s = sort_face(u, v, f);
  const Box bx = face_box<false>(s, 0.0f);
  const int ilo = lower_bound(s_sx, nx, bx.x0), ihi = upper_bound(s_sx, nx, bx.x1);
  const int jlo = lower_bound(s_sy, ny, bx.y0), jhi = upper_bound(s_sy, ny, bx.y1);
  ranges = ilo | ihi << 8 | jlo << 16;
  if (!(ilo < ihi && jlo < jhi)) return 0;
  const Rows r = barycentric_rows(s);
  const float pz0 = pick(s.o0, z0, z1, z2), pz1 = pick(s.o1, z0, z1, z2),
              pz2 = pick(s.o2, z0, z1, z2);
  const float r0 = pz0 == 0.0f ? 0.0f : 1.0f / pz0;
  const float r1 = pz1 == 0.0f ? 0.0f : 1.0f / pz1;
  const float r2 = pz2 == 0.0f ? 0.0f : 1.0f / pz2;
  const float fields[kRecFast] = {
      r.a[0], r.b[0], r.c[0], r.a[1], r.b[1], r.c[1],
      r0 * r.a[0] + r1 * r.a[1] + r2 * r.a[2],
      r0 * r.b[0] + r1 * r.b[1] + r2 * r.b[2],
      r0 * r.c[0] + r1 * r.c[1] + r2 * r.c[2]};
#pragma unroll
  for (int n = 0; n < kRecFast; ++n) rec[n * kBatch] = finite_or_zero(fields[n]);
  return (ihi - ilo) * (jhi - jlo);
}

// Fast mode, work item `item` of a queued face: one sample of its box, row
// by row.
__device__ void fast_sample(const float* rec, int ranges, int item, const float* s_sx,
                            const float* s_sy, unsigned* s_z) {
  const int ilo = ranges & 0xff, width = ((ranges >> 8) & 0xff) - ilo;
  const int j = ((ranges >> 16) & 0xff) + item / width, i = ilo + item % width;
  const float x = s_sx[i], y = s_sy[j];
  const float w0 = rec[0 * kBatch] * x + rec[1 * kBatch] * y + rec[2 * kBatch];
  const float w1 = rec[3 * kBatch] * x + rec[4 * kBatch] * y + rec[5 * kBatch];
  const float w2 = 1.0f - w0 - w1;
  if (!(w0 >= 0.0f && w1 >= 0.0f && w2 >= 0.0f)) return;
  const float depth = 1.0f / (rec[6 * kBatch] * x + rec[7 * kBatch] * y + rec[8 * kBatch]);
  if (!isnan(depth)) atomicMin(&s_z[j * kZTile + i], depth_key(depth));
}

// Exact mode: the record of face f into rec, and the first column of its
// span in the tile into ranges. Returns its work items, one a column of the
// span [ceil(p0x), trunc(min(p2x, W-1))] (0 if the box holds no sample).
__device__ int build_exact(const float* __restrict__ u, const float* __restrict__ v,
                           const float* __restrict__ z, int f, int nx, int ny, float width,
                           const float* s_sx, const float* s_sy, float* rec, int& ranges) {
  const float z0 = z[3 * f], z1 = z[3 * f + 1], z2 = z[3 * f + 2];
  const Sorted s = sort_face(u, v, f);
  const Box bx = face_box<true>(s, width);
  const int ilo = lower_bound(s_sx, nx, bx.x0), ihi = upper_bound(s_sx, nx, bx.x1);
  const int jlo = lower_bound(s_sy, ny, bx.y0), jhi = upper_bound(s_sy, ny, bx.y1);
  ranges = ilo;
  if (!(ilo < ihi && jlo < jhi)) return 0;
  const Rows r = barycentric_rows(s);
  // safe_slope: a vertical edge (dx == 0) takes p1y instead of its slope
  const bool vert01 = s.px1 == s.px0, vert12 = s.px2 == s.px1;
  const float fields[kRecExact] = {
      s.px0, s.px1, s.py0, s.py1,
      vert01 ? 0.0f : (s.py1 - s.py0) / (s.px1 - s.px0),
      vert12 ? 0.0f : (s.py2 - s.py1) / (s.px2 - s.px1),
      (s.py2 - s.py0) / (s.px2 - s.px0),  // px0 != px2 for a valid face
      __int_as_float(vert01 | vert12 << 1),
      1.0f / pick(s.o0, z0, z1, z2), 1.0f / pick(s.o1, z0, z1, z2),
      1.0f / pick(s.o2, z0, z1, z2),
      r.a[0], r.a[1], r.a[2], r.b[0], r.b[1], r.b[2], r.c[0], r.c[1], r.c[2]};
#pragma unroll
  for (int n = 0; n < kRecExact; ++n) rec[n * kBatch] = fields[n];
  return ihi - ilo;
}

// Exact mode, work item `item` of a queued face: one column of its span,
// the two polyline edges and the row span once, then the tile's rows inside
// the span.
__device__ void exact_column(const float* rec, int ranges, int item, int ny, float y_cap,
                             const float* s_sx, const float* s_sy, unsigned* s_z) {
  const int i = ranges + item;
  const float x = s_sx[i];
  const float px0 = rec[0 * kBatch], px1 = rec[1 * kBatch];
  const float py0 = rec[2 * kBatch], py1 = rec[3 * kBatch];
  const int vert = __float_as_int(rec[7 * kBatch]);
  const float yi1 = x <= px1 ? ((vert & 1) ? py1 : rec[4 * kBatch] * (x - px0) + py0)
                             : ((vert & 2) ? py1 : rec[5 * kBatch] * (x - px1) + py1);
  const float yi2 = rec[6 * kBatch] * (x - px0) + py0;
  if (isnan(yi1) || isnan(yi2)) return;  // min/max propagate NaN in the plain version
  const float y_lo = ceilf(fminf(yi1, yi2));
  const float y_hi = truncf(fminf(fmaxf(yi1, yi2), y_cap));
  const int jlo = lower_bound(s_sy, ny, y_lo), jhi = upper_bound(s_sy, ny, y_hi);
  const float r0 = rec[8 * kBatch], r1 = rec[9 * kBatch], r2 = rec[10 * kBatch];
  const float b0 = rec[14 * kBatch], b1 = rec[15 * kBatch], b2 = rec[16 * kBatch];
  // w_k = (a_k x + c_k) + b_k y: the column's part once
  const float e0 = rec[11 * kBatch] * x + rec[17 * kBatch];
  const float e1 = rec[12 * kBatch] * x + rec[18 * kBatch];
  const float e2 = rec[13 * kBatch] * x + rec[19 * kBatch];
  for (int j = jlo; j < jhi; ++j) {
    const float y = s_sy[j];
    const float w0 = clamp01(e0 + b0 * y);
    const float w1 = clamp01(e1 + b1 * y);
    const float w2 = clamp01(e2 + b2 * y);
    const float w_sum = w0 + w1 + w2;
    const float inv_z = (w0 * r0 + w1 * r1 + w2 * r2) / w_sum;
    const float depth = 1.0f / inv_z;
    if (w_sum > 0.0f && !isnan(depth)) atomicMin(&s_z[j * kZTile + i], depth_key(depth));
  }
}

// Exclusive prefix sum of a[0..n), n <= 2 * kZThreads, in place, over a
// z-tile block; returns the total in every thread. s_warp holds kZWarps
// partial sums.
__device__ int block_exclusive_scan(int* a, int n, int* s_warp) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int x0 = 2 * tid < n ? a[2 * tid] : 0;
  const int x1 = 2 * tid + 1 < n ? a[2 * tid + 1] : 0;
  int incl = x0 + x1;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before = 0, total = 0;
  for (int w = 0; w < kZWarps; ++w) {
    const int c = s_warp[w];
    before += (w < warp) ? c : 0;
    total += c;
  }
  const int excl = before + incl - (x0 + x1);
  if (2 * tid < n) a[2 * tid] = excl;
  if (2 * tid + 1 < n) a[2 * tid + 1] = excl + x0;
  __syncthreads();
  return total;
}

// Last k in [0, n) with a[k] <= v (a non-decreasing, a[0] <= v).
__device__ __forceinline__ int last_at_most(const int* a, int n, int v) {
  int lo = 0;
  while (n > 1) {
    const int half = n >> 1;
    if (a[lo + half] <= v) {
      lo += half;
      n -= half;
    } else {
      n = half;
    }
  }
  return lo;
}

// The shared body of both z-tile kernels: stage the tile's sample
// coordinates, clear the z-tile to the background, then scan the faces of
// image blockIdx.z and fold every covered sample of tile (blockIdx.x,
// blockIdx.y) into s_z. Ends synchronised. Needs kRec * kBatch floats of
// dynamic shared memory for the records.
template <bool kExact>
__device__ void fill_ztile(const float* __restrict__ u_plane, const float* __restrict__ v_plane,
                           const float* __restrict__ z_plane,
                           const float* __restrict__ sample_x, const float* __restrict__ sample_y,
                           int num_faces, int sx_n, int sy_n, float width, float height,
                           unsigned* s_z, float* s_sx, float* s_sy, int& nx, int& ny) {
  extern __shared__ float s_rec[];           // a drain round's records, field-major
  __shared__ int s_face[kQueue];             // queued faces
  __shared__ int s_ranges[kBatch];           // a drain round's packed sample ranges
  __shared__ int s_start[kBatch];            // and first work items
  __shared__ int s_count[kPerThread * kZWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = blockIdx.x * kZTile, j0 = blockIdx.y * kZTile;
  nx = min(kZTile, sx_n - i0);
  ny = min(kZTile, sy_n - j0);
  const unsigned background = depth_key(kBackground);
  for (int k = tid; k < kZTile * kZTile; k += kZThreads) s_z[k] = background;
  if (tid < nx) s_sx[tid] = sample_x[i0 + tid];
  if (tid >= kZTile && tid - kZTile < ny) s_sy[tid - kZTile] = sample_y[j0 + tid - kZTile];
  __syncthreads();
  const float tx_lo = s_sx[0], tx_hi = s_sx[nx - 1], ty_lo = s_sy[0], ty_hi = s_sy[ny - 1];
  const float y_cap = height - 1.0f;

  const size_t plane = (size_t)blockIdx.z * 3 * num_faces;
  const float* u = u_plane + plane;
  const float* v = v_plane + plane;
  const float* z = z_plane + plane;
  int queued = 0;  // the same in every thread
  for (int base = 0; base < num_faces; base += kChunk) {
    // Scan round: kPerThread faces a thread, their loads in flight together.
    bool hit[kPerThread];
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const int f = base + r * kZThreads + tid;
      hit[r] = false;
      if (f < num_faces) {
        const Sorted s = sort_face(u, v, f);
        const Box bx = face_box<kExact>(s, width);
        hit[r] = s.valid && bx.x1 >= tx_lo && bx.x0 <= tx_hi && bx.y1 >= ty_lo && bx.y0 <= ty_hi;
      }
    }
    unsigned mask[kPerThread];
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      mask[r] = __ballot_sync(kFull, hit[r]);
      if (lane == 0) s_count[r * kZWarps + warp] = __popc(mask[r]);
    }
    __syncthreads();
    int total = 0;
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      int offset = queued + total;
      for (int w = 0; w < kZWarps; ++w) {
        const int c = s_count[r * kZWarps + w];
        offset += (w < warp) ? c : 0;
        total += c;
      }
      if (hit[r]) s_face[offset + __popc(mask[r] & ((1u << lane) - 1u))] = base + r * kZThreads + tid;
    }
    queued += total;
    __syncthreads();
    if (queued < kDrain && base + kChunk < num_faces) continue;
    // Drain, kBatch faces a round: each face's record and work items, one
    // face a thread; then the items of all of them spread over the block.
    for (int first = 0; first < queued; first += kBatch) {
      const int n = min(kBatch, queued - first);
      if (tid < n) {
        int ranges;
        s_start[tid] = kExact ? build_exact(u, v, z, s_face[first + tid], nx, ny, width, s_sx,
                                            s_sy, s_rec + tid, ranges)
                              : build_fast(u, v, z, s_face[first + tid], nx, ny, s_sx, s_sy,
                                           s_rec + tid, ranges);
        s_ranges[tid] = ranges;
      }
      __syncthreads();
      const int items = block_exclusive_scan(s_start, n, s_count);
      for (int w = tid; w < items; w += kZThreads) {
        const int k = last_at_most(s_start, n, w);
        if constexpr (kExact) {
          exact_column(s_rec + k, s_ranges[k], w - s_start[k], ny, y_cap, s_sx, s_sy, s_z);
        } else {
          fast_sample(s_rec + k, s_ranges[k], w - s_start[k], s_sx, s_sy, s_z);
        }
      }
      __syncthreads();
    }
    queued = 0;
  }
}

// Planes (B, 3F) each, sample grid (2W,) x (2H,) sorted ascending ->
// pooled (B, H, W): each output pixel reads its four samples from the tile.
__global__ void __launch_bounds__(kZThreads)
raster_fast_pooled_kernel(const float* __restrict__ u, const float* __restrict__ v,
                          const float* __restrict__ z, const float* __restrict__ sample_x,
                          const float* __restrict__ sample_y, float* __restrict__ out,
                          int num_faces, int out_w, int out_h, float pool_clamp) {
  __shared__ unsigned s_z[kZTile * kZTile];
  __shared__ float s_sx[kZTile], s_sy[kZTile];
  int nx, ny;
  fill_ztile<false>(u, v, z, sample_x, sample_y, num_faces, 2 * out_w, 2 * out_h, 0.0f, 0.0f,
                    s_z, s_sx, s_sy, nx, ny);
  constexpr int kHalf = kZTile / 2;
  const int ox0 = blockIdx.x * kHalf, oy0 = blockIdx.y * kHalf;
  for (int k = threadIdx.x; k < kHalf * kHalf; k += kZThreads) {
    const int ly = k / kHalf, lx = k % kHalf;
    if (2 * lx >= nx || 2 * ly >= ny) continue;
    const unsigned* row0 = s_z + 2 * ly * kZTile + 2 * lx;
    const unsigned* row1 = row0 + kZTile;
    const float t0 = fminf(key_depth(row0[0]), pool_clamp);
    const float t1 = fminf(key_depth(row0[1]), pool_clamp);
    const float t2 = fminf(key_depth(row1[0]), pool_clamp);
    const float t3 = fminf(key_depth(row1[1]), pool_clamp);
    out[((size_t)blockIdx.z * out_h + oy0 + ly) * out_w + ox0 + lx] =
        ((t0 + t1) + (t2 + t3)) * 0.25f;
  }
}

// Planes (B, 3F) each, sample grid (Sx,) x (Sy,) sorted ascending -> raw
// (B, Sy, Sx), background 1000.
__global__ void __launch_bounds__(kZThreads)
raster_exact_kernel(const float* __restrict__ u, const float* __restrict__ v,
                    const float* __restrict__ z, const float* __restrict__ sample_x,
                    const float* __restrict__ sample_y, float* __restrict__ out, int num_faces,
                    int sx_n, int sy_n, float width, float height) {
  __shared__ unsigned s_z[kZTile * kZTile];
  __shared__ float s_sx[kZTile], s_sy[kZTile];
  int nx, ny;
  fill_ztile<true>(u, v, z, sample_x, sample_y, num_faces, sx_n, sy_n, width, height, s_z, s_sx,
                   s_sy, nx, ny);
  const int i0 = blockIdx.x * kZTile, j0 = blockIdx.y * kZTile;
  for (int k = threadIdx.x; k < kZTile * kZTile; k += kZThreads) {
    const int ly = k / kZTile, lx = k % kZTile;
    if (lx < nx && ly < ny) {
      out[((size_t)blockIdx.z * sy_n + j0 + ly) * sx_n + i0 + lx] = key_depth(s_z[k]);
    }
  }
}

dim3 ztile_grid(int sx_n, int sy_n, int batch) {
  return dim3((sx_n + kZTile - 1) / kZTile, (sy_n + kZTile - 1) / kZTile, batch);
}

// Launch a z-tile kernel with its drain round's records (rec_fields floats
// a face) in dynamic shared memory, first opting in to that size: with the
// static part, the exact kernel passes the 48 KB a block gets unasked.
// Returns the launch's error.
template <typename Kernel, typename... Args>
cudaError_t launch_ztile(Kernel kernel, int rec_fields, dim3 grid, cudaStream_t stream,
                         Args... args) {
  const int bytes = rec_fields * kBatch * (int)sizeof(float);
  const cudaError_t opt_in =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (opt_in != cudaSuccess) return opt_in;
  kernel<<<grid, kZThreads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// u, v, z planes (B, 3F) each, sample_x (2W,), sample_y (2H,) sorted
// ascending, out (B, H, W). Returns cudaGetLastError() after the launch.
int shx_raster_fast_pooled(const float* u, const float* v, const float* z,
                           const float* sample_x, const float* sample_y, float* out, int batch,
                           int num_faces, int out_w, int out_h, float pool_clamp, void* stream) {
  if (batch > 0 && out_w > 0 && out_h > 0) {
    return (int)launch_ztile(raster_fast_pooled_kernel, kRecFast,
                             ztile_grid(2 * out_w, 2 * out_h, batch), (cudaStream_t)stream, u, v,
                             z, sample_x, sample_y, out, num_faces, out_w, out_h, pool_clamp);
  }
  return (int)cudaGetLastError();
}

// records (B, F, 9), boxes (B, F, 4), sample_x (Sx,), sample_y (Sy,),
// out (B, Sy, Sx). Returns cudaGetLastError() after the launch.
int shx_raster_fast(const float* records, const float* boxes, const float* sample_x,
                    const float* sample_y, float* out, int batch, int num_faces, int sx_n,
                    int sy_n, void* stream) {
  if (batch > 0 && sx_n > 0 && sy_n > 0) {
    raster_fast_kernel<<<grid_for(sx_n, sy_n, batch), kThreads, 0, (cudaStream_t)stream>>>(
        records, reinterpret_cast<const float4*>(boxes), sample_x, sample_y, out, num_faces,
        sx_n, sy_n);
  }
  return (int)cudaGetLastError();
}

// u, v, z planes (B, 3F) each, sample_x (Sx,), sample_y (Sy,) sorted
// ascending, out (B, Sy, Sx). Returns cudaGetLastError() after the launch.
int shx_raster_exact(const float* u, const float* v, const float* z, const float* sample_x,
                     const float* sample_y, float* out, int batch, int num_faces, int sx_n,
                     int sy_n, float width, float height, void* stream) {
  if (batch > 0 && sx_n > 0 && sy_n > 0) {
    return (int)launch_ztile(raster_exact_kernel, kRecExact, ztile_grid(sx_n, sy_n, batch),
                             (cudaStream_t)stream, u, v, z, sample_x, sample_y, out, num_faces,
                             sx_n, sy_n, width, height);
  }
  return (int)cudaGetLastError();
}

const char* shx_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
