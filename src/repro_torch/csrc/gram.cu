// Gram matrix G = D^T D in fp32, for the offline PCA fit.
//
// Replaces: src/repro/kernels/gram.py::gram_pallas (the Pallas kernel that
// keeps the (d, d) accumulator resident in VMEM while row strips stream).
//
// Bound on an H100: operations. G is symmetric, so the function needs the
// d (d + 1) / 2 entries of one triangle, n d (d + 1) FLOP, over n d 4 bytes
// read: about (d + 1) / 4 = 192 FLOP per byte at d = 768, far above the
// card's fp32 ridge (67 TFLOP/s over 3.35 TB/s = 20). So the design spends
// its effort on FMA throughput: 128 x 128 output tiles, 8 x 8 register
// blocks per thread, k-slabs of 16 rows staged in shared memory, and only
// the tiles on or above the diagonal are computed (21 of 36 at d = 768);
// a last pass mirrors them into the lower triangle.
//
// The TPU kernel walks the rows in one sequential grid. On the card the
// output's upper tiles are split over CTAs, and to fill 132 SMs, and to
// keep each fp32 sum chain short, the rows are also split into `splits`
// contiguous ranges of at most 16,384 rows. Each (tile, range) CTA writes
// its partial tile; a second pass sums the partials in range order. No
// atomics, so the sum order, and the result, is the same from run to run.
// A diagonal tile's two halves are summed in the same order (a b == b a in
// IEEE fp32), so the result is exactly symmetric.
#include "common.cuh"

namespace {

constexpr int GB = 128;        // output tile edge
constexpr int GK = 16;         // rows per shared-memory slab
constexpr int GLD = GB + 4;    // padded slab row (keeps float4 alignment)
constexpr int GT = 256;        // threads: 16 x 16, each an 8 x 8 block
constexpr int64_t MAX_RANGE_ROWS = 16384;

template <typename T>
__global__ void __launch_bounds__(GT)
gram_partial_kernel(const T* __restrict__ D, int64_t n, int d,
                    int64_t rows_per_split, float* __restrict__ partial) {
  __shared__ __align__(16) float As[GK][GLD];
  __shared__ __align__(16) float Bs[GK][GLD];
  // blockIdx.x walks the tiles (ti, tj), ti <= tj, row by row
  const int nt = (d + GB - 1) / GB;
  int t = blockIdx.x, ti = 0;
  while (t >= nt - ti) { t -= nt - ti; ++ti; }
  const int i0 = ti * GB;
  const int j0 = (ti + t) * GB;
  const int64_t r_begin = static_cast<int64_t>(blockIdx.y) * rows_per_split;
  const int64_t r_end =
      r_begin + rows_per_split < n ? r_begin + rows_per_split : n;
  const int tid = threadIdx.x, tm = tid / 16, tn = tid % 16;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int64_t r0 = r_begin; r0 < r_end; r0 += GK) {
    // a warp reads 32 neighbouring columns of one row: coalesced
    for (int e = tid; e < GK * GB; e += GT) {
      const int kk = e / GB, c = e % GB;
      const int64_t r = r0 + kk;
      const bool row_ok = r < r_end;
      As[kk][c] = (row_ok && i0 + c < d) ? to_f32(D[r * d + i0 + c]) : 0.f;
      Bs[kk][c] = (row_ok && j0 + c < d) ? to_f32(D[r * d + j0 + c]) : 0.f;
    }
    __syncthreads();
    tile_fma<GB, GB, GK, 2, 2, GLD, GLD>(&As[0][0], &Bs[0][0], acc, tm, tn);
    __syncthreads();
  }

  float* P = partial + static_cast<int64_t>(blockIdx.y) * d * d;
#pragma unroll
  for (int si = 0; si < 8; ++si) {
    const int i = i0 + tile_pos<GB, 2>(si, tm);
    if (i >= d) continue;
#pragma unroll
    for (int sj = 0; sj < 8; ++sj) {
      const int j = j0 + tile_pos<GB, 2>(sj, tn);
      if (j < d) P[static_cast<int64_t>(i) * d + j] = acc[si][sj];
    }
  }
}

// Sum the ranges' partials for the entries of the upper tiles.
__global__ void gram_reduce_kernel(const float* __restrict__ partial,
                                   int splits, int d,
                                   float* __restrict__ out) {
  const int64_t dd = static_cast<int64_t>(d) * d;
  for (int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       idx < dd; idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    if (static_cast<int>(idx / d) / GB > static_cast<int>(idx % d) / GB) continue;
    float s = 0.f;
    for (int p = 0; p < splits; ++p) s += partial[p * dd + idx];
    out[idx] = s;
  }
}

// Copy the upper tiles into the lower ones: out[i][j] = out[j][i] where
// i's tile lies below j's.
__global__ void gram_mirror_kernel(int d, float* __restrict__ out) {
  const int64_t dd = static_cast<int64_t>(d) * d;
  for (int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       idx < dd; idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int i = static_cast<int>(idx / d), j = static_cast<int>(idx % d);
    if (i / GB > j / GB) out[idx] = out[static_cast<int64_t>(j) * d + i];
  }
}

template <typename T>
int launch(const void* D, int64_t n, int d, int splits, float* partial,
           float* out, cudaStream_t stream) {
  const int nt = (d + GB - 1) / GB;
  int64_t rows_per_split = (n + splits - 1) / splits;
  rows_per_split = (rows_per_split + GK - 1) / GK * GK;
  float* dst = splits == 1 ? out : partial;
  gram_partial_kernel<T><<<dim3(nt * (nt + 1) / 2, splits), GT, 0, stream>>>(
      static_cast<const T*>(D), n, d, rows_per_split, dst);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t dd = static_cast<int64_t>(d) * d;
  const int64_t want = (dd + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  if (splits > 1) {
    gram_reduce_kernel<<<blocks, 256, 0, stream>>>(partial, splits, d, out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gram_mirror_kernel<<<blocks, 256, 0, stream>>>(d, out);
  return static_cast<int>(cudaGetLastError());
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

// dtype: 0 = f32, 1 = bf16. partial holds splits * d * d floats (unused
// when splits == 1; only the upper tiles are written). Returns the
// cudaError_t of the launches.
extern "C" int gram_f32(const void* D, int64_t n, int d, int dtype,
                        int splits, void* partial, void* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<float*>(partial);
  auto o = static_cast<float*>(out);
  if (dtype == 0) return launch<float>(D, n, d, splits, p, o, s);
  if (dtype == 1) return launch<__nv_bfloat16>(D, n, d, splits, p, o, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
