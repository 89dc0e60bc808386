// PCA projection D_hat = D W_m in fp32, with an optional fused int8 epilogue.
//
// Replaces: src/repro/kernels/pca_project.py::pca_project_pallas (output in
// D's dtype) and ::pca_project_quant_pallas (output
// int8(clip(round(t * (1 / max(scale, 1e-12))), -127, 127)), so no f32
// index ever reaches device memory).
//
// Bound on an H100: operations. 2 n d m FLOP over n (d + m) 4 bytes is
// about 256 FLOP per byte at d = 768, m = 384, far above the fp32 ridge of
// 20, so the kernel lives or dies by how close its inner loop keeps the FMA
// pipes to 4 warp-instructions per clock per SM: loads must stay in flight
// while the FMAs run, with few barriers and no transposing loader.
//
// This design is a pipelined SGEMM. The (n, m) output is split over CTAs by
// 128 x 128 tile (the column tile varies fastest, so the CTAs of one row
// block read D's rows from L2 after the first), and each CTA walks d in
// 16-deep slabs through a 4-stage ring in shared memory. A slab of D is
// copied as it lies in memory (16-byte cp.async row pieces, f32 or bf16, no
// transpose) and a slab of W likewise; the copy of slab s + 3 is in flight
// while slab s is multiplied, with one barrier per slab. A warp owns 32 rows
// x 64 columns, a thread 8 rows x 8 columns: per 4-deep step it reads its 8
// rows as one 16-byte piece each along d (4 distinct pieces per warp, a
// broadcast, conflict-free with the 20-float row stride) and 8 float4 of W
// (8 lanes over 128 contiguous bytes): 16 shared loads for 256 FMAs.
// Ragged shapes (d % 16, m % 4, unaligned operands) take scalar loads into
// the same ring. There is no split over d and no tensor core.
//
// Invariant: every output is one fp32 fmaf chain over d in ascending order,
// starting from 0.f (slabs past d add exact zeros). A redesign keeps it, so
// results stay bitwise the same, and any row range projects bitwise as
// those rows of the whole.
#include "common.cuh"
#include "pipeline.cuh"

namespace {

constexpr int PB = 128;       // rows of D per tile
constexpr int PN = 128;       // columns of W per tile
constexpr int PK = 16;        // slab depth over d
constexpr int PT = 256;       // threads: 4 x 2 warps of 32 rows x 64 columns
constexpr int STAGES = 4;
constexpr int ALD = PK + 4;   // f32 row stride of a D slab (floats)
constexpr int BLD = PK + 8;   // bf16 row stride of a D slab (elements, 48 bytes)

template <typename T> struct ASlab;
template <> struct ASlab<float> { static constexpr int LD = ALD; };
template <> struct ASlab<__nv_bfloat16> { static constexpr int LD = BLD; };

// four consecutive d-values of one row of a D slab, as f32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void store4(float* out, int64_t i, const float* v) {
  *reinterpret_cast<float4*>(out + i) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* out, int64_t i, const float* v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(out + i) = u;
}
__device__ __forceinline__ void store1(float* out, int64_t i, float v) { out[i] = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* out, int64_t i, float v) {
  out[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ int8_t quant(float acc, float inv) {
  float q = rintf(__fmul_rn(acc, inv));   // round half to even
  q = fminf(fmaxf(q, -127.f), 127.f);
  return static_cast<int8_t>(q);
}

// Fill ring stage `st` with slab k0 of D rows [r0, r0 + PB) and W columns
// [c0, c0 + PN). VEC: 16-byte copies (d % 16 == 0, m % 4 == 0, aligned);
// else scalar loads. Out-of-range elements are zero.
template <typename T, bool VEC>
__device__ __forceinline__ void load_slab(const T* __restrict__ D, const float* __restrict__ W,
                                          T* As, float* Bs, int64_t n, int d, int m,
                                          int64_t r0, int c0, int k0, int tid) {
  constexpr int LD = ASlab<T>::LD;
  if (VEC) {
    constexpr int PER_ROW = PK * sizeof(T) / 16;          // 16-byte pieces per row
#pragma unroll
    for (int i = 0; i < PB * PER_ROW / PT; ++i) {
      const int e = tid + i * PT;
      const int r = e / PER_ROW, c = e % PER_ROW;
      const int64_t row = r0 + r;
      const bool ok = row < n;
      cp_async16(As + r * LD + c * (16 / sizeof(T)),
                 D + (ok ? row : 0) * d + k0 + c * (16 / sizeof(T)), ok);
    }
#pragma unroll
    for (int i = 0; i < PK * (PN / 4) / PT; ++i) {
      const int e = tid + i * PT;
      const int kr = e / (PN / 4), c = e % (PN / 4);
      const bool ok = c0 + 4 * c < m;
      cp_async16(Bs + kr * PN + 4 * c,
                 W + static_cast<int64_t>(k0 + kr) * m + (ok ? c0 + 4 * c : 0), ok);
    }
  } else {
    for (int e = tid; e < PB * PK; e += PT) {
      const int r = e / PK, kk = e % PK;
      const int64_t row = r0 + r;
      As[r * LD + kk] = (row < n && k0 + kk < d) ? D[row * d + k0 + kk] : T(0.f);
    }
    for (int e = tid; e < PK * PN; e += PT) {
      const int kr = e / PN, c = e % PN;
      Bs[kr * PN + c] = (k0 + kr < d && c0 + c < m)
                            ? W[static_cast<int64_t>(k0 + kr) * m + c0 + c] : 0.f;
    }
  }
}

template <typename T, bool QUANT, bool VEC>
__global__ void __launch_bounds__(PT, 2)
pca_project_kernel(const T* __restrict__ D, const float* __restrict__ W,
                   const float* __restrict__ scale, void* __restrict__ out,
                   int64_t n, int d, int m) {
  constexpr int LD = ASlab<T>::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);                                  // [STAGES][PB][LD]
  float* Bs = reinterpret_cast<float*>(smem + STAGES * PB * LD * sizeof(T));  // [STAGES][PK][PN]
  const int ntn = (m + PN - 1) / PN;
  const int64_t r0 = (static_cast<int64_t>(blockIdx.x) / ntn) * PB;
  const int c0 = (blockIdx.x % ntn) * PN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wr = warp / 2, wc = warp % 2;           // warp's 32-row and 64-column block
  const int rg = lane / 8, cg = lane % 8;           // thread: rows wr*32 + 4i + rg,
                                                    // columns wc*64 + 32h + 4cg + 0..3
  const int nslab = (d + PK - 1) / PK;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nslab)
      load_slab<T, VEC>(D, W, As + s * PB * LD, Bs + s * PK * PN, n, d, m, r0, c0, s * PK, tid);
    cp_async_commit();
  }
  for (int s = 0; s < nslab; ++s) {
    cp_async_wait<STAGES - 2>();       // slab s has landed (this thread's copies)
    __syncthreads();                   // ... everyone's; and slab s - 1 is consumed
    const int nx = s + STAGES - 1;
    if (nx < nslab) {
      const int st = nx % STAGES;
      load_slab<T, VEC>(D, W, As + st * PB * LD, Bs + st * PK * PN, n, d, m, r0, c0,
                        nx * PK, tid);
    }
    cp_async_commit();
    const T* a_s = As + (s % STAGES) * PB * LD + (wr * 32 + rg) * LD;
    const float* b_s = Bs + (s % STAGES) * PK * PN + wc * 64 + cg * 4;
#pragma unroll
    for (int k4 = 0; k4 < PK; k4 += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = load4(a_s + 4 * i * LD + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b0 = *reinterpret_cast<const float4*>(b_s + (k4 + kk) * PN);
        const float4 b1 = *reinterpret_cast<const float4*>(b_s + (k4 + kk) * PN + 32);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = comp(a[i], kk);
          acc[i][0] = fmaf(av, b0.x, acc[i][0]);
          acc[i][1] = fmaf(av, b0.y, acc[i][1]);
          acc[i][2] = fmaf(av, b0.z, acc[i][2]);
          acc[i][3] = fmaf(av, b0.w, acc[i][3]);
          acc[i][4] = fmaf(av, b1.x, acc[i][4]);
          acc[i][5] = fmaf(av, b1.y, acc[i][5]);
          acc[i][6] = fmaf(av, b1.z, acc[i][6]);
          acc[i][7] = fmaf(av, b1.w, acc[i][7]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = c0 + wc * 64 + 32 * h + 4 * cg;
    if (c >= m) continue;
    float inv[4] = {0.f, 0.f, 0.f, 0.f};
    if (QUANT) {
#pragma unroll
      for (int t = 0; t < 4; ++t)   // IEEE divide, as the TPU epilogue
        if (c + t < m) inv[t] = 1.0f / fmaxf(scale[c + t], 1e-12f);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int64_t row = r0 + wr * 32 + 4 * i + rg;
      if (row >= n) continue;
      const float* v = &acc[i][4 * h];
      if (VEC) {                     // m % 4 == 0: all four columns are in range
        if (QUANT) {
          char4 q = make_char4(quant(v[0], inv[0]), quant(v[1], inv[1]),
                               quant(v[2], inv[2]), quant(v[3], inv[3]));
          *reinterpret_cast<char4*>(static_cast<int8_t*>(out) + row * m + c) = q;
        } else {
          store4(static_cast<T*>(out), row * m + c, v);
        }
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (c + t >= m) break;
          if (QUANT)
            static_cast<int8_t*>(out)[row * m + c + t] = quant(v[t], inv[t]);
          else
            store1(static_cast<T*>(out), row * m + c + t, v[t]);
        }
      }
    }
  }
}

template <typename T, bool QUANT, bool VEC>
cudaError_t launch_one(const T* D, const float* W, const float* scale, void* out,
                       int64_t n, int d, int m, unsigned tiles, cudaStream_t stream) {
  auto kern = pca_project_kernel<T, QUANT, VEC>;
  const int smem = STAGES * (PB * ASlab<T>::LD * static_cast<int>(sizeof(T)) + PK * PN * 4);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<tiles, PT, smem, stream>>>(D, W, scale, out, n, d, m);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* D, const float* W, const float* scale, void* out,
           int64_t n, int d, int m, cudaStream_t stream) {
  const int64_t tiles = ((n + PB - 1) / PB) * ((m + PN - 1) / PN);
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const T* Dt = static_cast<const T*>(D);
  const bool vec = d % PK == 0 && m % 4 == 0 && reinterpret_cast<uintptr_t>(D) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(W) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const unsigned t = static_cast<unsigned>(tiles);
  cudaError_t err;
  if (scale != nullptr)
    err = vec ? launch_one<T, true, true>(Dt, W, scale, out, n, d, m, t, stream)
              : launch_one<T, true, false>(Dt, W, scale, out, n, d, m, t, stream);
  else
    err = vec ? launch_one<T, false, true>(Dt, W, nullptr, out, n, d, m, t, stream)
              : launch_one<T, false, false>(Dt, W, nullptr, out, n, d, m, t, stream);
  return static_cast<int>(err);
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

namespace {

template <typename T>
int project_smem(int) {
  return STAGES * (PB * ASlab<T>::LD * static_cast<int>(sizeof(T)) + PK * PN * 4);
}

#define PROJECT(T, TN, Q, QN, V, VN)                                                     \
  {"pca_project_kernel<" TN "," QN "," VN ">",                                           \
   reinterpret_cast<const void*>(pca_project_kernel<T, Q, V>), PT, project_smem<T>}
#define PROJECTS(T, TN)                                                                   \
  PROJECT(T, TN, false, "plain", true, "vec"), PROJECT(T, TN, false, "plain", false, "scalar"), \
      PROJECT(T, TN, true, "quant", true, "vec"), PROJECT(T, TN, true, "quant", false, "scalar")

const KernelEntry KERNELS[] = {PROJECTS(float, "f32"), PROJECTS(__nv_bfloat16, "bf16")};
#undef PROJECTS
#undef PROJECT

}  // namespace

// The resource check's view of every kernel in this file (common.cuh's
// kernel_attrs); m is unused (the tiles do not depend on the width).
extern "C" int pca_project_kernel_attrs(int i, int m, const char** name, int* attrs) {
  return kernel_attrs(KERNELS, static_cast<int>(sizeof(KERNELS) / sizeof(KERNELS[0])), i, m,
                      name, attrs);
}
