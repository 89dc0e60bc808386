// Gram matrix G = D^T D in fp32, for the offline PCA fit.
//
// Replaces: src/repro/kernels/gram.py::gram_pallas (the Pallas kernel that
// keeps the (d, d) accumulator resident in VMEM while row strips stream).
//
// Bound on an H100: operations. G is symmetric, so the function needs the
// d (d + 1) / 2 entries of one triangle, n d (d + 1) FLOP, over n d 4 bytes
// read: about (d + 1) / 4 = 192 FLOP per byte at d = 768, far above the
// card's fp32 ridge (67 TFLOP/s over 3.35 TB/s = 20). So the kernel lives
// or dies by how close its inner loop keeps the FMA pipes busy: loads must
// stay in flight while the FMAs run, with few barriers.
//
// The TPU kernel walks the rows in one sequential grid. On the card the
// output's 128 x 128 tiles on or above the diagonal (21 of 36 at d = 768)
// are split over CTAs, and to fill 132 SMs, and to keep each fp32 sum chain
// short, the rows are also split into `splits` contiguous ranges of at most
// 16,384 rows. blockIdx.x walks the tiles fastest, so the CTAs of one range
// read its rows from L2 after the first.
//
// Each (tile, range) CTA is a pipelined SGEMM mainloop, the one of
// pca_project.cu: 16-row slabs through a 4-stage shared-memory ring, filled
// by 16-byte cp.async copies, with one barrier per slab; the copy of slab
// s + 3 is in flight while slab s is multiplied. D's rows are the reduction
// dimension, so a slab needs no transpose: operand row kk of the tile's
// column block [i0, i0 + 128) is 128 contiguous elements of D's row r0 + kk
// (512 bytes f32, 256 bytes bf16). bf16 is copied as bf16 and upcast when
// read. A diagonal tile (i0 == j0) copies one slab and reads it as both
// operands. A warp owns 32 x 64 outputs, a thread 8 x 8: per row of the
// slab it reads two 16-byte pieces of each operand (4 distinct A pieces and
// 8 distinct B pieces per warp, one wavefront each) for 64 FMAs. Ragged
// shapes (d off the 16-byte piece, an unaligned D) take scalar loads into
// the same ring. No tensor core, no library call.
//
// A second pass sums the ranges' partial tiles in range order and writes
// each upper tile's transpose into the lower triangle (with one range, the
// mainloop's epilogue writes both). No atomics, so the result is the same
// from run to run.
//
// Invariant, kept by every redesign so results stay bitwise the same:
//   - gram_splits and gram_range_rows fix the ranges; they start at
//     multiples of 16 rows whatever the slab depth, and rows of a slab past
//     its range's end are zeros, which add exactly;
//   - each output element of a range is one fp32 fmaf chain over the
//     range's rows in ascending order, starting from 0.f;
//   - the reduce sums the ranges' partials in range order from 0.f;
//   - the lower triangle is a bit copy of the upper one. A diagonal tile's
//     two halves are separate chains of the same products (a b == b a in
//     IEEE fp32), so G is exactly symmetric.
#include "common.cuh"
#include "pipeline.cuh"

namespace {

constexpr int GB = 128;        // output tile edge
constexpr int GK = 16;         // rows per slab; also the range granularity
constexpr int GT = 256;        // threads: 4 x 2 warps of 32 x 64 outputs
constexpr int STAGES = 4;
constexpr int64_t MAX_RANGE_ROWS = 16384;

// four consecutive slab entries as f32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
}

// v[0..3] into row[col..col + 3], the columns below d; one 16-byte store
// when d % 4 == 0 (row starts and col are then 16-byte aligned)
__device__ __forceinline__ void store4(float* row, int col, int d, const float* v) {
  if (d % 4 == 0 && col + 3 < d) {
    *reinterpret_cast<float4*>(row + col) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int t = 0; t < 4; ++t)
    if (col + t < d) row[col + t] = v[t];
}

// Fill one ring stage with rows [r0, r0 + GK) of D's column blocks
// [i0, i0 + GB) into A and, off the diagonal, [j0, j0 + GB) into B. VEC:
// 16-byte copies (d a multiple of the piece, D 16-byte aligned); else
// scalar loads. Rows at or past r_end and columns at or past d are zero.
template <typename T, bool VEC>
__device__ __forceinline__ void load_slab(const T* __restrict__ D, T* A, T* B, bool diag,
                                          int64_t r0, int64_t r_end, int d, int i0, int j0,
                                          int tid) {
  if (VEC) {
    constexpr int EPP = 16 / sizeof(T);          // elements per 16-byte piece
    constexpr int PER_ROW = GB / EPP;            // pieces per slab row
#pragma unroll
    for (int i = 0; i < GK * PER_ROW / GT; ++i) {
      const int e = tid + i * GT;
      const int kk = e / PER_ROW, c = (e % PER_ROW) * EPP;
      const int64_t row = r0 + kk;
      const bool row_ok = row < r_end;
      const T* src = D + (row_ok ? row : 0) * d;
      const bool a_ok = row_ok && i0 + c < d;
      cp_async16(A + kk * GB + c, src + (a_ok ? i0 + c : 0), a_ok);
      if (!diag) {
        const bool b_ok = row_ok && j0 + c < d;
        cp_async16(B + kk * GB + c, src + (b_ok ? j0 + c : 0), b_ok);
      }
    }
  } else {
    for (int e = tid; e < GK * GB; e += GT) {
      const int kk = e / GB, c = e % GB;
      const int64_t row = r0 + kk;
      const bool row_ok = row < r_end;
      A[kk * GB + c] = (row_ok && i0 + c < d) ? D[row * d + i0 + c] : T(0.f);
      if (!diag) B[kk * GB + c] = (row_ok && j0 + c < d) ? D[row * d + j0 + c] : T(0.f);
    }
  }
}

// One (tile, range) CTA: the range's partial of one upper output tile into
// out (d, d). `mirror` (one range: out is G) also writes the transpose of
// an off-diagonal tile.
template <typename T, bool VEC>
__global__ void __launch_bounds__(GT, 2)
gram_partial_kernel(const T* __restrict__ D, int64_t n, int d, int64_t rows_per_split,
                    float* __restrict__ partial, int mirror) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);          // [STAGES][A, B][GK][GB]
  // blockIdx.x walks the tiles (ti, tj), ti <= tj, row by row
  const int nt = (d + GB - 1) / GB;
  int t = blockIdx.x, ti = 0;
  while (t >= nt - ti) { t -= nt - ti; ++ti; }
  const int i0 = ti * GB;
  const int j0 = (ti + t) * GB;
  const bool diag = t == 0;
  const int64_t r_begin = static_cast<int64_t>(blockIdx.y) * rows_per_split;
  const int64_t r_end = r_begin + rows_per_split < n ? r_begin + rows_per_split : n;
  const int nslab = r_end > r_begin ? static_cast<int>((r_end - r_begin + GK - 1) / GK) : 0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wr = warp / 2, wc = warp % 2;        // warp's 32-row and 64-column block
  const int rg = lane / 8, cg = lane % 8;        // thread: rows wr*32 + 16 i2 + 4 rg + 0..3,
                                                 // columns wc*64 + 32 h + 4 cg + 0..3

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  auto stage = [&](int st, int op) { return ring + (st * 2 + op) * GK * GB; };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nslab)
      load_slab<T, VEC>(D, stage(s, 0), stage(s, 1), diag, r_begin + s * GK, r_end, d, i0,
                        j0, tid);
    cp_async_commit();
  }
  for (int s = 0; s < nslab; ++s) {
    cp_async_wait<STAGES - 2>();       // slab s has landed (this thread's copies)
    __syncthreads();                   // ... everyone's; and slab s - 1 is consumed
    const int nx = s + STAGES - 1;
    if (nx < nslab) {
      const int st = nx % STAGES;
      load_slab<T, VEC>(D, stage(st, 0), stage(st, 1), diag,
                        r_begin + static_cast<int64_t>(nx) * GK, r_end, d, i0, j0, tid);
    }
    cp_async_commit();
    const T* a_s = stage(s % STAGES, 0) + wr * 32 + 4 * rg;
    const T* b_s = stage(s % STAGES, diag ? 0 : 1) + wc * 64 + 4 * cg;
#pragma unroll
    for (int kk = 0; kk < GK; ++kk) {
      const float4 a0 = load4(a_s + kk * GB), a1 = load4(a_s + kk * GB + 16);
      const float4 b0 = load4(b_s + kk * GB), b1 = load4(b_s + kk * GB + 32);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  // acc[4 i2 + r][4 h + c] is output (i0 + wr*32 + 16 i2 + 4 rg + r,
  //                                   j0 + wc*64 + 32 h + 4 cg + c)
  float* P = partial + static_cast<int64_t>(blockIdx.y) * d * d;
#pragma unroll
  for (int i2 = 0; i2 < 2; ++i2)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + wr * 32 + 16 * i2 + 4 * rg + r;
      if (i >= d) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store4(P + static_cast<int64_t>(i) * d, j0 + wc * 64 + 32 * h + 4 * cg, d,
               &acc[4 * i2 + r][4 * h]);
    }
  if (mirror && !diag) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + wc * 64 + 32 * h + 4 * cg + c;
        if (j >= d) continue;
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2) {
          const float v[4] = {acc[4 * i2][4 * h + c], acc[4 * i2 + 1][4 * h + c],
                              acc[4 * i2 + 2][4 * h + c], acc[4 * i2 + 3][4 * h + c]};
          store4(P + static_cast<int64_t>(j) * d, i0 + wr * 32 + 16 * i2 + 4 * rg, d, v);
        }
      }
  }
}

// Sum the ranges' partials for the entries of the upper tiles, in range
// order, and write each off-diagonal tile's entries into the lower one too.
__global__ void gram_reduce_kernel(const float* __restrict__ partial,
                                   int splits, int d,
                                   float* __restrict__ out) {
  const int64_t dd = static_cast<int64_t>(d) * d;
  for (int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       idx < dd; idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int i = static_cast<int>(idx / d), j = static_cast<int>(idx % d);
    if (i / GB > j / GB) continue;
    float s = 0.f;
    for (int p = 0; p < splits; ++p) s += partial[p * dd + idx];
    out[idx] = s;
    if (i / GB < j / GB) out[static_cast<int64_t>(j) * d + i] = s;
  }
}

template <typename T, bool VEC>
cudaError_t launch_partial(const T* D, int64_t n, int d, int splits, int64_t rows_per_split,
                           float* dst, cudaStream_t stream) {
  auto kern = gram_partial_kernel<T, VEC>;
  const int smem = STAGES * 2 * GK * GB * static_cast<int>(sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nt = (d + GB - 1) / GB;
  kern<<<dim3(nt * (nt + 1) / 2, splits), GT, smem, stream>>>(D, n, d, rows_per_split, dst,
                                                               splits == 1);
  return cudaGetLastError();
}

int64_t range_rows(int64_t n, int splits) {
  const int64_t r = (n + splits - 1) / splits;
  return (r + GK - 1) / GK * GK;
}

template <typename T>
int launch(const void* D, int64_t n, int d, int splits, float* partial, float* out,
           cudaStream_t stream, int* launched) {
  if (splits < 1 || splits > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const T* Dt = static_cast<const T*>(D);
  const int64_t rows_per_split = range_rows(n, splits);
  float* dst = splits == 1 ? out : partial;
  const bool vec = d % (16 / static_cast<int>(sizeof(T))) == 0 &&
                   reinterpret_cast<uintptr_t>(D) % 16 == 0;
  cudaError_t err = vec ? launch_partial<T, true>(Dt, n, d, splits, rows_per_split, dst, stream)
                        : launch_partial<T, false>(Dt, n, d, splits, rows_per_split, dst, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  ++*launched;
  if (splits > 1) {
    const int64_t dd = static_cast<int64_t>(d) * d;
    const int64_t want = (dd + 255) / 256;
    const int blocks = static_cast<int>(want < 4096 ? want : 4096);
    gram_reduce_kernel<<<blocks, 256, 0, stream>>>(partial, splits, d, out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launched;
  }
  return 0;
}

}  // namespace

// Row ranges for an (n, d) input on a card with `sms` SMs: at least about
// two CTAs per SM over the upper output tiles, and ranges of at most 16,384
// rows.
// Each range is one sequential fp32 chain per element: at 8.8M rows, seven
// ranges (1.26M rows each) left a relative error of 4.7e-4 against cuBLAS.
// The partials (splits * d * d floats) are capped at 2 GiB (540 ranges at
// d = 768 and 8.8M rows take 1.27 GB), and a range is at least one slab.
extern "C" int gram_splits(int64_t n, int d, int sms) {
  const int64_t nt = (d + GB - 1) / GB;
  int64_t s = (2 * static_cast<int64_t>(sms)) / (nt * (nt + 1) / 2);
  const int64_t by_rows = (n + MAX_RANGE_ROWS - 1) / MAX_RANGE_ROWS;
  if (s < by_rows) s = by_rows;
  const int64_t cap = (int64_t{1} << 29) / (static_cast<int64_t>(d) * d);
  if (s > cap) s = cap;
  const int64_t slabs = (n + GK - 1) / GK;
  if (s > slabs) s = slabs;
  return s < 1 ? 1 : static_cast<int>(s);
}

// Rows of each range when n rows are split `splits` ways: range p is
// [p r, min((p + 1) r, n)), r a multiple of 16 (a trailing range may be
// empty, and adds zeros).
extern "C" int64_t gram_range_rows(int64_t n, int splits) {
  return splits < 1 ? 0 : range_rows(n, splits);
}

// dtype: 0 = f32, 1 = bf16. partial holds splits * d * d floats (unused
// when splits == 1; only the upper tiles are written). *launched counts the
// kernel launches made. Returns the first cudaError_t.
extern "C" int gram_f32(const void* D, int64_t n, int d, int dtype, int splits, void* partial,
                        void* out, void* stream, int* launched) {
  auto s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<float*>(partial);
  auto o = static_cast<float*>(out);
  *launched = 0;
  if (dtype == 0) return launch<float>(D, n, d, splits, p, o, s, launched);
  if (dtype == 1) return launch<__nv_bfloat16>(D, n, d, splits, p, o, s, launched);
  return static_cast<int>(cudaErrorInvalidValue);
}

namespace {

template <typename T>
int partial_smem(int) { return STAGES * 2 * GK * GB * static_cast<int>(sizeof(T)); }

const KernelEntry KERNELS[] = {
    {"gram_partial_kernel<f32,vec>",
     reinterpret_cast<const void*>(gram_partial_kernel<float, true>), GT, partial_smem<float>},
    {"gram_partial_kernel<f32,scalar>",
     reinterpret_cast<const void*>(gram_partial_kernel<float, false>), GT, partial_smem<float>},
    {"gram_partial_kernel<bf16,vec>",
     reinterpret_cast<const void*>(gram_partial_kernel<__nv_bfloat16, true>), GT,
     partial_smem<__nv_bfloat16>},
    {"gram_partial_kernel<bf16,scalar>",
     reinterpret_cast<const void*>(gram_partial_kernel<__nv_bfloat16, false>), GT,
     partial_smem<__nv_bfloat16>},
    {"gram_reduce_kernel", reinterpret_cast<const void*>(gram_reduce_kernel), 256, nullptr},
};

}  // namespace

// The resource check's view of every kernel in this file (common.cuh's
// kernel_attrs); m is unused (the tiles do not depend on the width).
extern "C" int gram_kernel_attrs(int i, int m, const char** name, int* attrs) {
  return kernel_attrs(KERNELS, static_cast<int>(sizeof(KERNELS) / sizeof(KERNELS[0])), i, m,
                      name, attrs);
}
