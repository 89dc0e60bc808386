// PCA projection D_hat = D W_m in fp32, with an optional fused int8 epilogue.
//
// Replaces: src/repro/kernels/pca_project.py::pca_project_pallas (output in
// D's dtype) and ::pca_project_quant_pallas (output
// int8(clip(round(t * (1 / max(scale, 1e-12))), -127, 127)), so no f32
// index ever reaches device memory).
//
// Bound on an H100: operations. 2 n d m FLOP over n (d + m) 4 bytes is
// about 256 FLOP per byte at d = 768, m = 384, far above the fp32 ridge of
// 20. The (n, m) output is split over CTAs by 128 x 128 output tile and each
// CTA loops over d in slabs of 16. Output tiles of one row block are
// neighbouring CTAs (the column tile varies fastest), so the D rows they all
// read come from L2 after the first. There is no reduction across CTAs.
#include "common.cuh"

namespace {

constexpr int PB = 128;       // rows of D per tile
constexpr int PN = 128;       // columns of W per tile
constexpr int PK = 16;        // slab depth over d
constexpr int PLD = 128 + 4;  // padded slab row
constexpr int PT = 256;       // threads: 16 x 16, each an 8 x 8 block

__device__ __forceinline__ void store_out(float* out, int64_t i, float v) { out[i] = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* out, int64_t i, float v) {
  out[i] = __float2bfloat16_rn(v);
}

template <typename T, bool QUANT>
__global__ void __launch_bounds__(PT)
pca_project_kernel(const T* __restrict__ D, const float* __restrict__ W,
                   const float* __restrict__ scale, void* __restrict__ out,
                   int64_t n, int d, int m) {
  __shared__ __align__(16) float As[PK][PLD];   // As[k][r] = D[r0 + r][k0 + k]
  __shared__ __align__(16) float Bs[PK][PLD];   // Bs[k][c] = W[k0 + k][c0 + c]
  const int ntn = (m + PN - 1) / PN;
  const int64_t r0 = (static_cast<int64_t>(blockIdx.x) / ntn) * PB;
  const int c0 = (blockIdx.x % ntn) * PN;
  const int tid = threadIdx.x, tm = tid / 16, tn = tid % 16;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += PK) {
    for (int e = tid; e < PB * PK; e += PT) {
      const int r = e / PK, kk = e % PK;     // a half-warp reads one row's slab
      const int64_t row = r0 + r;
      As[kk][r] = (row < n && k0 + kk < d) ? to_f32(D[row * d + k0 + kk]) : 0.f;
    }
    for (int e = tid; e < PK * PN; e += PT) {
      const int kk = e / PN, c = e % PN;
      Bs[kk][c] = (k0 + kk < d && c0 + c < m)
                      ? W[static_cast<int64_t>(k0 + kk) * m + c0 + c] : 0.f;
    }
    __syncthreads();
    tile_fma<PB, PN, PK, 2, 2, PLD, PLD>(&As[0][0], &Bs[0][0], acc, tm, tn);
    __syncthreads();
  }

#pragma unroll
  for (int sj = 0; sj < 8; ++sj) {
    const int c = c0 + tile_pos<PN, 2>(sj, tn);
    if (c >= m) continue;
    float inv = 0.f;
    if (QUANT) inv = 1.0f / fmaxf(scale[c], 1e-12f);   // IEEE divide, as the TPU epilogue
#pragma unroll
    for (int si = 0; si < 8; ++si) {
      const int64_t row = r0 + tile_pos<PB, 2>(si, tm);
      if (row >= n) continue;
      if (QUANT) {
        float q = rintf(__fmul_rn(acc[si][sj], inv));  // round half to even
        q = fminf(fmaxf(q, -127.f), 127.f);
        static_cast<int8_t*>(out)[row * m + c] = static_cast<int8_t>(q);
      } else {
        store_out(static_cast<T*>(out), row * m + c, acc[si][sj]);
      }
    }
  }
}

template <typename T>
int launch(const void* D, const float* W, const float* scale, void* out,
           int64_t n, int d, int m, cudaStream_t stream) {
  const int64_t tiles = ((n + PB - 1) / PB) * ((m + PN - 1) / PN);
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (scale != nullptr)
    pca_project_kernel<T, true><<<static_cast<unsigned>(tiles), PT, 0, stream>>>(
        static_cast<const T*>(D), W, scale, out, n, d, m);
  else
    pca_project_kernel<T, false><<<static_cast<unsigned>(tiles), PT, 0, stream>>>(
        static_cast<const T*>(D), W, nullptr, out, n, d, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype of D: 0 = f32, 1 = bf16. W is (d, m) f32. With scale == nullptr the
// output is D's dtype; with an (m,) f32 scale it is int8.
extern "C" int pca_project_f32(const void* D, const void* W, const void* scale,
                               void* out, int64_t n, int d, int m, int dtype,
                               void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto w = static_cast<const float*>(W);
  auto sc = static_cast<const float*>(scale);
  if (dtype == 0) return launch<float>(D, w, sc, out, n, d, m, s);
  if (dtype == 1) return launch<__nv_bfloat16>(D, w, sc, out, n, d, m, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
