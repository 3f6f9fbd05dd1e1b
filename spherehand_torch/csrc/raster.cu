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
//       the fast coverage and depth of raster_fast_pooled at any ascending
//       sample grid, raw (B, Sy, Sx) buffer with background 1000, no
//       pooling.
//
// All three are modes of one z-tile body. They read the projected planes
// (u, v, z), each (B, 3F) in face-vertex order, and build every face's
// setup themselves: the vertex sort by x with the reference tie ladder, the
// back-face cull, the degenerate test, the box (fast: the vertex box grown
// by kBoxMargin; exact: the column span [ceil(p0x), trunc(min(p2x, W-1))]
// by the vertex y range +-1, unbounded in y where C truncation paints
// column 0 from right of p2x) and, for the faces that reach the block's
// tile, the record the plain pre-pass would build. Every expression keeps
// the plain pre-pass's order.
//
// Design. One block of 512 threads per (image, z-tile of 64 x 64 samples),
// all in gridDim.x. The tile's depths live in shared memory as
// order-preserving integer keys (depth_key), initialised to the background.
//   Face list. raster_fast_pooled and raster_exact scan: the block walks all
//   F faces of its image in rounds of 1,024, two a thread with their loads
//   in flight together; it sets each face up, tests its box against the
//   tile's sample range, and a ballot compacts the faces that reach the tile
//   into a queue. raster_fast takes its list from a binning pass instead
//   (up to raster_cuda.BIN_MAX_TILES tiles an image; it scans beyond): one
//   thread a face sets each face up once, finds the z-tiles whose sample
//   range its box meets, and appends the face to those tiles' lists (a
//   count and F entries a tile of int32 scratch); each block then drains
//   its own list. Scanning, every tile sets up every face of its image
//   again, 100 times a face on the 640 x 640 canvas, where most tiles hold
//   no face at all.
//   Drain, 512 faces at a time: each thread builds one listed face's record
//   into shared memory and, by binary search over the tile's sorted sample
//   coordinates, the samples its box holds; a block prefix sum over the
//   faces' work items (fast: one a box sample; exact: one a span column,
//   which computes the two polyline edges and the row span once, then walks
//   the rows inside it) spreads the items over all threads, so no thread
//   walks a large face alone: item w to thread w mod 512, each looking its
//   face up by binary search. raster_fast, where a round's faces hold 32
//   samples or more on average (the canvas: a few hundred a face), gives
//   each thread one contiguous run of items instead and walks it face by
//   face with the record in registers (fast_walk). Each covered sample folds
//   its depth into the tile with a shared-memory atomicMin on its key.
//   Epilogue: the tile, pooled or raw, to device memory.
//
// Why faces over threads. A hand face covers a few samples of the 128 x 128
// grid. Giving each thread a sample and walking every face past it (the
// first raster_fast design) makes a warp pay the whole coverage test for
// the one or two lanes inside the face; here only the samples a face's box
// holds are tested. A min is order-free, so the result depends neither on scheduling
// nor on the order of a bin's list: two launches, and any face order, give
// the same bits. The one exception is the sign of zero: the key orders -0
// below +0, so a sample that both reach keeps -0; the two are equal as
// depths.
//
// Why 64 x 64 samples and 512 threads. A scanning block reads all F faces
// of its image from L2 (24 bytes a face for the cull), so a larger tile
// reads the planes fewer times (4 tiles an image against 16 of 32 x 32),
// and at large batches, where the card is full, that wins. At the small
// batches of training (B = 25 a view of the real batch, 48 synthetic) a
// launch is as long as its slowest block, the tile that holds most of the
// hand (about three times the mean faces, five times the mean samples); 512
// threads give that block twice the warps of 256 to hide its latency. The
// trade-off is measured by python -m spherehand_torch.raster_sweep; scan
// against bins, and each kernel against another build, by python -m
// spherehand_torch.raster_ab.
//
// What bounds them on this card: the least time is set by the bytes (36
// bytes a face of planes, the canvas: tens of MB at B = 1024 against 3.35
// TB/s); the coverage tests and face setups cost less against 67 TFLOP/s
// float32. What the design spends instead is latency: each block's scan and
// drain rounds wait on L2 and on the block's barriers, and the hand's
// heaviest tile sets a small launch's time.
//
// Numerics. Built with -fmad=false and without fast math: every product and
// sum rounds on its own, divisions are IEEE, so span bounds (ceilf/truncf)
// and depth bits match the plain PyTorch versions operation for operation.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kBackground = 1000.0f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float clamp01(float w) {
  // NaN passes through, as torch.clamp and jnp.clip do.
  return w < 0.0f ? 0.0f : (w > 1.0f ? 1.0f : w);
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
// Mean box samples a face from which raster_fast's drain walks contiguous
// runs of items (fast_walk) instead of spreading them strided.
constexpr int kWalkItems = 32;

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

// Fast mode, the work items [w, end) of one thread, contiguous: a binary
// search over the drain round's first items (s_start, n faces, `items` in
// all) finds the face of the first; the thread then walks its face's box
// samples row by row, with the record in registers, and steps to the next
// face with items. The strided spread (fast_sample) searches for every
// item and reads the record again; both compute each sample as fast_sample
// does.
__device__ void fast_walk(int w, int end, const int* s_start, int n, int items,
                          const float* s_rec, const int* s_ranges, const float* s_sx,
                          const float* s_sy, unsigned* s_z) {
  if (w >= end) return;
  int k = last_at_most(s_start, n, w);
  while (true) {
    const float* rec = s_rec + k;
    const float a0 = rec[0 * kBatch], b0 = rec[1 * kBatch], c0 = rec[2 * kBatch];
    const float a1 = rec[3 * kBatch], b1 = rec[4 * kBatch], c1 = rec[5 * kBatch];
    const float aq = rec[6 * kBatch], bq = rec[7 * kBatch], cq = rec[8 * kBatch];
    const int ranges = s_ranges[k];
    const int ilo = ranges & 0xff, ihi = (ranges >> 8) & 0xff;
    const int off = w - s_start[k];
    int j = ((ranges >> 16) & 0xff) + off / (ihi - ilo), i = ilo + off % (ihi - ilo);
    const int stop = min(end, k + 1 < n ? s_start[k + 1] : items);
    for (; w < stop; ++w) {
      const float x = s_sx[i], y = s_sy[j];
      const float w0 = a0 * x + b0 * y + c0;
      const float w1 = a1 * x + b1 * y + c1;
      const float w2 = 1.0f - w0 - w1;
      if (w0 >= 0.0f && w1 >= 0.0f && w2 >= 0.0f) {
        const float depth = 1.0f / (aq * x + bq * y + cq);
        if (!isnan(depth)) atomicMin(&s_z[j * kZTile + i], depth_key(depth));
      }
      if (++i == ihi) {
        i = ilo;
        ++j;
      }
    }
    if (w >= end) return;
    ++k;  // the next face with items: the last whose first item is <= w
    while (k + 1 < n && s_start[k + 1] <= w) ++k;
  }
}

// The (image, z-tile) a block owns. A z-tile launch puts all its blocks in
// gridDim.x, whose limit is 2^31 - 1 (gridDim.z stops at 65,535 images):
// image-major, the tiles of an image row by row, so block k is also slot k
// of the binning pass's lists.
struct ZTile {
  int b, i0, j0;  // image, first sample column, first sample row
};

__device__ __forceinline__ ZTile ztile_of_block(int sx_n, int sy_n) {
  const unsigned tiles_x = (sx_n + kZTile - 1) / kZTile;
  const unsigned per_image = tiles_x * ((sy_n + kZTile - 1) / kZTile);
  const unsigned t = blockIdx.x % per_image;
  return {(int)(blockIdx.x / per_image), (int)(t % tiles_x) * kZTile,
          (int)(t / tiles_x) * kZTile};
}

// Stage tile t's sample coordinates and clear its z-tile to the background;
// nx, ny are the tile's sample columns and rows. Ends synchronised.
__device__ void begin_ztile(const ZTile& t, const float* __restrict__ sample_x,
                            const float* __restrict__ sample_y, int sx_n, int sy_n,
                            unsigned* s_z, float* s_sx, float* s_sy, int& nx, int& ny) {
  const int tid = threadIdx.x;
  nx = min(kZTile, sx_n - t.i0);
  ny = min(kZTile, sy_n - t.j0);
  const unsigned background = depth_key(kBackground);
  for (int k = tid; k < kZTile * kZTile; k += kZThreads) s_z[k] = background;
  if (tid < nx) s_sx[tid] = sample_x[t.i0 + tid];
  if (tid >= kZTile && tid - kZTile < ny) s_sy[tid - kZTile] = sample_y[t.j0 + tid - kZTile];
  __syncthreads();
}

// Fold the `count` faces listed at `faces` (shared or device memory) into
// s_z, kBatch a round: each face's record and work items, one face a
// thread; then the items of all of them spread over the block, strided
// (item w to thread w % kZThreads) or, with kWalk (fast mode) in a round
// whose faces hold kWalkItems samples or more on average, one contiguous
// run a thread (fast_walk). Needs kRec * kBatch floats of dynamic shared
// memory for the records. Ends synchronised.
template <bool kExact, bool kWalk = false>
__device__ __forceinline__ void drain_faces(const int* faces, int count,
                                            const float* __restrict__ u,
                                            const float* __restrict__ v,
                                            const float* __restrict__ z, int nx, int ny,
                                            float width, float y_cap, const float* s_sx,
                                            const float* s_sy, unsigned* s_z) {
  extern __shared__ float s_rec[];   // a drain round's records, field-major
  __shared__ int s_ranges[kBatch];   // a drain round's packed sample ranges
  __shared__ int s_start[kBatch];    // and first work items
  __shared__ int s_warp[kZWarps];
  const int tid = threadIdx.x;
  for (int first = 0; first < count; first += kBatch) {
    const int n = min(kBatch, count - first);
    if (tid < n) {
      int ranges;
      s_start[tid] = kExact ? build_exact(u, v, z, faces[first + tid], nx, ny, width, s_sx, s_sy,
                                          s_rec + tid, ranges)
                            : build_fast(u, v, z, faces[first + tid], nx, ny, s_sx, s_sy,
                                         s_rec + tid, ranges);
      s_ranges[tid] = ranges;
    }
    __syncthreads();
    const int items = block_exclusive_scan(s_start, n, s_warp);
    if (kWalk && items >= kWalkItems * n) {
      const int per = (items + kZThreads - 1) / kZThreads;
      fast_walk(tid * per, min(items, (tid + 1) * per), s_start, n, items, s_rec, s_ranges, s_sx,
                s_sy, s_z);
    } else {
      for (int w = tid; w < items; w += kZThreads) {
        const int k = last_at_most(s_start, n, w);
        if constexpr (kExact) {
          exact_column(s_rec + k, s_ranges[k], w - s_start[k], ny, y_cap, s_sx, s_sy, s_z);
        } else {
          fast_sample(s_rec + k, s_ranges[k], w - s_start[k], s_sx, s_sy, s_z);
        }
      }
    }
    __syncthreads();
  }
}

// The scan of the z-tile kernels: walk all F faces of the image (planes u,
// v, z), queue those whose box meets the tile's sample range, and drain the
// queue whenever kDrain faces wait (or the list ends). Ends synchronised.
template <bool kExact, bool kWalk = false>
__device__ void scan_ztile(const float* __restrict__ u, const float* __restrict__ v,
                           const float* __restrict__ z, int num_faces, int nx, int ny,
                           float width, float height, const float* s_sx, const float* s_sy,
                           unsigned* s_z) {
  __shared__ int s_face[kQueue];  // queued faces
  __shared__ int s_count[kPerThread * kZWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float tx_lo = s_sx[0], tx_hi = s_sx[nx - 1], ty_lo = s_sy[0], ty_hi = s_sy[ny - 1];
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
    drain_faces<kExact, kWalk>(s_face, queued, u, v, z, nx, ny, width, height - 1.0f, s_sx,
                               s_sy, s_z);
    queued = 0;
  }
}

// Write tile t of s_z to the raw (B, Sy, Sx) canvas as depths.
__device__ __forceinline__ void write_raw(const ZTile& t, const unsigned* s_z, int nx, int ny,
                                          int sx_n, int sy_n, float* __restrict__ out) {
  for (int k = threadIdx.x; k < kZTile * kZTile; k += kZThreads) {
    const int ly = k / kZTile, lx = k % kZTile;
    if (lx < nx && ly < ny) {
      out[((size_t)t.b * sy_n + t.j0 + ly) * sx_n + t.i0 + lx] = key_depth(s_z[k]);
    }
  }
}

// Planes (B, 3F) each, sample grid (2W,) x (2H,) sorted ascending ->
// pooled (B, H, W): each output pixel reads its four samples from the tile.
__global__ void __launch_bounds__(kZThreads)
raster_fast_pooled_kernel(const float* __restrict__ u_plane, const float* __restrict__ v_plane,
                          const float* __restrict__ z_plane, const float* __restrict__ sample_x,
                          const float* __restrict__ sample_y, float* __restrict__ out,
                          int num_faces, int out_w, int out_h, float pool_clamp) {
  __shared__ unsigned s_z[kZTile * kZTile];
  __shared__ float s_sx[kZTile], s_sy[kZTile];
  const ZTile t = ztile_of_block(2 * out_w, 2 * out_h);
  int nx, ny;
  begin_ztile(t, sample_x, sample_y, 2 * out_w, 2 * out_h, s_z, s_sx, s_sy, nx, ny);
  const size_t plane = (size_t)t.b * 3 * num_faces;
  scan_ztile<false>(u_plane + plane, v_plane + plane, z_plane + plane, num_faces, nx, ny, 0.0f,
                    0.0f, s_sx, s_sy, s_z);
  constexpr int kHalf = kZTile / 2;
  const int ox0 = t.i0 / 2, oy0 = t.j0 / 2;
  for (int k = threadIdx.x; k < kHalf * kHalf; k += kZThreads) {
    const int ly = k / kHalf, lx = k % kHalf;
    if (2 * lx >= nx || 2 * ly >= ny) continue;
    const unsigned* row0 = s_z + 2 * ly * kZTile + 2 * lx;
    const unsigned* row1 = row0 + kZTile;
    const float t0 = fminf(key_depth(row0[0]), pool_clamp);
    const float t1 = fminf(key_depth(row0[1]), pool_clamp);
    const float t2 = fminf(key_depth(row1[0]), pool_clamp);
    const float t3 = fminf(key_depth(row1[1]), pool_clamp);
    out[((size_t)t.b * out_h + oy0 + ly) * out_w + ox0 + lx] = ((t0 + t1) + (t2 + t3)) * 0.25f;
  }
}

// Planes (B, 3F) each, sample grid (Sx,) x (Sy,) sorted ascending -> raw
// (B, Sy, Sx), background 1000.
__global__ void __launch_bounds__(kZThreads)
raster_exact_kernel(const float* __restrict__ u_plane, const float* __restrict__ v_plane,
                    const float* __restrict__ z_plane, const float* __restrict__ sample_x,
                    const float* __restrict__ sample_y, float* __restrict__ out, int num_faces,
                    int sx_n, int sy_n, float width, float height) {
  __shared__ unsigned s_z[kZTile * kZTile];
  __shared__ float s_sx[kZTile], s_sy[kZTile];
  const ZTile t = ztile_of_block(sx_n, sy_n);
  int nx, ny;
  begin_ztile(t, sample_x, sample_y, sx_n, sy_n, s_z, s_sx, s_sy, nx, ny);
  const size_t plane = (size_t)t.b * 3 * num_faces;
  scan_ztile<true>(u_plane + plane, v_plane + plane, z_plane + plane, num_faces, nx, ny, width,
                   height, s_sx, s_sy, s_z);
  write_raw(t, s_z, nx, ny, sx_n, sy_n, out);
}

// Planes (B, 3F) each, sample grid (Sx,) x (Sy,) sorted ascending -> raw
// (B, Sy, Sx), background 1000, by the fast rule. kBinned: the block drains
// its own tile's list (lists + blockIdx.x * F, counts[blockIdx.x] faces, as
// bin_faces_kernel built it); else it scans all F faces of its image, as
// raster_fast_pooled does.
template <bool kBinned>
__global__ void __launch_bounds__(kZThreads)
raster_fast_kernel(const float* __restrict__ u_plane, const float* __restrict__ v_plane,
                   const float* __restrict__ z_plane, const float* __restrict__ sample_x,
                   const float* __restrict__ sample_y, float* __restrict__ out,
                   const int* __restrict__ counts, const int* __restrict__ lists, int num_faces,
                   int sx_n, int sy_n) {
  __shared__ unsigned s_z[kZTile * kZTile];
  __shared__ float s_sx[kZTile], s_sy[kZTile];
  const ZTile t = ztile_of_block(sx_n, sy_n);
  int nx, ny;
  begin_ztile(t, sample_x, sample_y, sx_n, sy_n, s_z, s_sx, s_sy, nx, ny);
  const size_t plane = (size_t)t.b * 3 * num_faces;
  const float *u = u_plane + plane, *v = v_plane + plane, *z = z_plane + plane;
  if constexpr (kBinned) {
    drain_faces<false, true>(lists + (size_t)blockIdx.x * num_faces, counts[blockIdx.x], u, v, z,
                             nx, ny, 0.0f, 0.0f, s_sx, s_sy, s_z);
  } else {
    scan_ztile<false, true>(u, v, z, num_faces, nx, ny, 0.0f, 0.0f, s_sx, s_sy, s_z);
  }
  write_raw(t, s_z, nx, ny, sx_n, sy_n, out);
}

constexpr int kBinThreads = 256;

// The binning pass of raster_fast, one thread a face, a block kBinThreads
// faces of one image: the face's setup as the z-tile kernels make it
// (sort_face, the front-facing and non-degenerate test, face_box<false>);
// the face's index goes into the list of every z-tile whose sample range
// (first to last sample in x and in y, the scan's test) its box meets. A
// box that falls between two samples of a tile lists the face there too;
// its drain finds no samples. Each (image, tile) slot has room for F faces
// (a face enters a tile once) and its count, zeroed before the pass, is the
// list's length.
//   Dynamic shared memory (bin_smem_bytes): the tiles' first and last
// sample coordinates, where a binary search finds the tile columns [tx0,
// tx1] and rows [ty0, ty1] a box meets, and two counters a tile of the
// image. The block counts its faces a tile with shared atomics, reserves
// each tile's run in the list with one device atomic, then writes its
// faces into the runs. Device atomics a face, one a (warp, tile) even,
// measured several times slower: their contention on an image's few
// counters set the pass's time.
//   The lists' order depends on scheduling; the z-min that drains them
// does not.
__global__ void __launch_bounds__(kBinThreads)
bin_faces_kernel(const float* __restrict__ u_plane, const float* __restrict__ v_plane,
                 const float* __restrict__ sample_x, const float* __restrict__ sample_y,
                 int* __restrict__ counts, int* __restrict__ lists, int num_faces, int sx_n,
                 int sy_n) {
  extern __shared__ float s_bin[];
  const int tid = threadIdx.x;
  const unsigned chunks = (num_faces + kBinThreads - 1) / kBinThreads;
  const int b = (int)(blockIdx.x / chunks);
  const int face = (int)(blockIdx.x % chunks) * kBinThreads + tid;
  const int tiles_x = (sx_n + kZTile - 1) / kZTile;
  const int tiles_y = (sy_n + kZTile - 1) / kZTile;
  const int per_image = tiles_x * tiles_y;
  float* x_first = s_bin;
  float* x_last = x_first + tiles_x;
  float* y_first = x_last + tiles_x;
  float* y_last = y_first + tiles_y;
  int* s_count = reinterpret_cast<int*>(y_last + tiles_y);  // the block's faces a tile
  int* s_next = s_count + per_image;                         // a tile's next list entry
  for (int t = tid; t < tiles_x; t += kBinThreads) {
    x_first[t] = sample_x[t * kZTile];
    x_last[t] = sample_x[min(t * kZTile + kZTile - 1, sx_n - 1)];
  }
  for (int t = tid; t < tiles_y; t += kBinThreads) {
    y_first[t] = sample_y[t * kZTile];
    y_last[t] = sample_y[min(t * kZTile + kZTile - 1, sy_n - 1)];
  }
  for (int t = tid; t < per_image; t += kBinThreads) s_count[t] = 0;
  __syncthreads();
  int tx0 = 0, tx1 = -1, ty0 = 0, ty1 = -1;
  if (face < num_faces) {
    const size_t plane = (size_t)b * 3 * num_faces;
    const Sorted s = sort_face(u_plane + plane, v_plane + plane, face);
    if (s.valid) {
      const Box bx = face_box<false>(s, 0.0f);
      tx0 = lower_bound(x_last, tiles_x, bx.x0);
      tx1 = upper_bound(x_first, tiles_x, bx.x1) - 1;
      ty0 = lower_bound(y_last, tiles_y, bx.y0);
      ty1 = upper_bound(y_first, tiles_y, bx.y1) - 1;
    }
  }
  for (int ty = ty0; ty <= ty1; ++ty) {
    for (int tx = tx0; tx <= tx1; ++tx) atomicAdd(&s_count[ty * tiles_x + tx], 1);
  }
  __syncthreads();
  for (int t = tid; t < per_image; t += kBinThreads) {
    const int c = s_count[t];
    s_next[t] = c > 0 ? atomicAdd(&counts[b * per_image + t], c) : 0;
  }
  __syncthreads();
  for (int ty = ty0; ty <= ty1; ++ty) {
    for (int tx = tx0; tx <= tx1; ++tx) {
      const int t = ty * tiles_x + tx;
      lists[((size_t)b * per_image + t) * num_faces + atomicAdd(&s_next[t], 1)] = face;
    }
  }
}

// Dynamic shared memory of bin_faces_kernel over a (Sx,) x (Sy,) grid.
size_t bin_smem_bytes(int sx_n, int sy_n) {
  const size_t tiles_x = (sx_n + kZTile - 1) / kZTile, tiles_y = (sy_n + kZTile - 1) / kZTile;
  return 2 * sizeof(float) * (tiles_x + tiles_y) + 2 * sizeof(int) * tiles_x * tiles_y;
}

// Blocks of a z-tile launch over a (Sx,) x (Sy,) sample grid, or -1 past
// gridDim.x's limit.
long long ztile_blocks(int sx_n, int sy_n, int batch) {
  const long long blocks = (long long)((sx_n + kZTile - 1) / kZTile) *
                           ((sy_n + kZTile - 1) / kZTile) * batch;
  return blocks > 0x7fffffffLL ? -1 : blocks;
}

// Launch a z-tile kernel with its drain round's records (rec_fields floats
// a face) in dynamic shared memory, first opting in to that size: with the
// static part, the exact kernel passes the 48 KB a block gets unasked.
// Returns the launch's error.
template <typename Kernel, typename... Args>
cudaError_t launch_ztile(Kernel kernel, int rec_fields, long long blocks, cudaStream_t stream,
                         Args... args) {
  if (blocks < 0) return cudaErrorInvalidValue;
  const int bytes = rec_fields * kBatch * (int)sizeof(float);
  const cudaError_t opt_in =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (opt_in != cudaSuccess) return opt_in;
  kernel<<<(unsigned)blocks, kZThreads, bytes, stream>>>(args...);
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
                             ztile_blocks(2 * out_w, 2 * out_h, batch), (cudaStream_t)stream, u,
                             v, z, sample_x, sample_y, out, num_faces, out_w, out_h, pool_clamp);
  }
  return (int)cudaGetLastError();
}

// u, v, z planes (B, 3F) each, sample_x (Sx,), sample_y (Sy,) sorted
// ascending, out (B, Sy, Sx). With scratch `counts` (B * T,) and `lists`
// (B * T, F) int32, T the z-tiles of an image, the binning pass runs first
// and each z-tile drains its own list; with lists == NULL each z-tile scans
// all F faces of its image. Returns cudaGetLastError() after the launches.
int shx_raster_fast(const float* u, const float* v, const float* z, const float* sample_x,
                    const float* sample_y, float* out, int* counts, int* lists, int batch,
                    int num_faces, int sx_n, int sy_n, void* stream) {
  if (!(batch > 0 && sx_n > 0 && sy_n > 0)) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const long long blocks = ztile_blocks(sx_n, sy_n, batch);
  if (lists == nullptr) {
    return (int)launch_ztile(raster_fast_kernel<false>, kRecFast, blocks, s, u, v, z, sample_x,
                             sample_y, out, (const int*)nullptr, (const int*)nullptr, num_faces,
                             sx_n, sy_n);
  }
  const long long bin_blocks = (long long)batch * ((num_faces + kBinThreads - 1) / kBinThreads);
  if (blocks < 0 || bin_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(counts, 0, (size_t)blocks * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = bin_smem_bytes(sx_n, sy_n);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;  // raster_cuda.BIN_MAX_TILES
  if (bin_blocks > 0) {
    bin_faces_kernel<<<(unsigned)bin_blocks, kBinThreads, smem, s>>>(
        u, v, sample_x, sample_y, counts, lists, num_faces, sx_n, sy_n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch_ztile(raster_fast_kernel<true>, kRecFast, blocks, s, u, v, z, sample_x,
                           sample_y, out, (const int*)counts, (const int*)lists, num_faces, sx_n,
                           sy_n);
}

// u, v, z planes (B, 3F) each, sample_x (Sx,), sample_y (Sy,) sorted
// ascending, out (B, Sy, Sx). Returns cudaGetLastError() after the launch.
int shx_raster_exact(const float* u, const float* v, const float* z, const float* sample_x,
                     const float* sample_y, float* out, int batch, int num_faces, int sx_n,
                     int sy_n, float width, float height, void* stream) {
  if (batch > 0 && sx_n > 0 && sy_n > 0) {
    return (int)launch_ztile(raster_exact_kernel, kRecExact, ztile_blocks(sx_n, sy_n, batch),
                             (cudaStream_t)stream, u, v, z, sample_x, sample_y, out, num_faces,
                             sx_n, sy_n, width, height);
  }
  return (int)cudaGetLastError();
}

const char* shx_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
