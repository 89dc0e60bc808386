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
// A call of few rows takes a second kernel (pca_project_small_kernel): there
// the tiled grid is a handful of CTAs on a 132-SM card (one at 32 rows and
// m 128, each spending most of its FMAs on zero rows past n), and the time
// is one tile's FMAs on one SM. The small kernel gives each CTA 32 columns
// (a lane each) by 8 rows (two a warp), so one output is one thread's chain
// and the CTAs spread over the SMs. Its W column strip and D rows stream in
// 32-deep slabs through a cp.async ring; the chain is latency-bound (d
// dependent FMAs), W is read once per 8 rows from L2. The wrapper chooses
// the kernel (kernels/pca_project.py::project_path) and passes its choice.
//
// Invariant: every output is one fp32 fmaf chain over d in ascending order,
// starting from 0.f, ceil(d / 16) * 16 terms long (past d they add exact
// zeros). A redesign keeps it, so results stay bitwise the same, any row
// range projects bitwise as those rows of the whole, and both kernels give
// the same bits for the same rows.
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

// One CTA an SM: the register tile takes 167-203 registers a thread with no
// spill; a 128-register cap (two CTAs an SM) spills 40-56 bytes in the f32
// instances and is no faster.
template <typename T, bool QUANT, bool VEC>
__global__ void __launch_bounds__(PT, 1)
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

// ---------------------------------------------------------------------------
// Few rows: pca_project_small_kernel
// ---------------------------------------------------------------------------

constexpr int SN = 32;              // columns of W a CTA: one a lane
constexpr int SRW = 2;              // rows of D a warp: a thread's chains
constexpr int SWARPS = 4;
constexpr int SRB = SWARPS * SRW;   // rows of D a CTA
constexpr int SK = 32;              // slab depth over d
constexpr int SSTAGES = 6;
constexpr int ST = SWARPS * 32;     // threads

template <typename T> struct SSlab;
template <> struct SSlab<float> { static constexpr int LD = SK + 4; };
template <> struct SSlab<__nv_bfloat16> { static constexpr int LD = SK + 8; };

template <typename T>
__host__ __device__ constexpr int small_stage_bytes() {
  return SK * SN * 4 + SRB * SSlab<T>::LD * static_cast<int>(sizeof(T));
}

// Fill ring stage `st` with slab k0: W rows [k0, k0 + SK) of columns [c0,
// c0 + SN) and D rows [r0, r0 + SRB) over the same d-values. VEC as
// load_slab (d % 16 == 0, m % 4 == 0, aligned): 16-byte pieces, each wholly
// in or out of range; else scalar loads. Out-of-range elements are zero.
template <typename T, bool VEC>
__device__ __forceinline__ void load_small_slab(const T* __restrict__ D,
                                                const float* __restrict__ W, float* Ws, T* Ds,
                                                int64_t n, int d, int m, int64_t r0, int c0,
                                                int k0, int tid) {
  constexpr int LD = SSlab<T>::LD;
  if (VEC) {
#pragma unroll
    for (int i = 0; i < SK * (SN / 4) / ST; ++i) {
      const int e = tid + i * ST;
      const int kr = e / (SN / 4), c = e % (SN / 4);
      const bool ok = k0 + kr < d && c0 + 4 * c < m;
      cp_async16(Ws + kr * SN + 4 * c,
                 W + (ok ? static_cast<int64_t>(k0 + kr) * m + c0 + 4 * c : 0), ok);
    }
    constexpr int PER_ROW = SK * sizeof(T) / 16;
    if (tid < SRB * PER_ROW) {
      const int r = tid / PER_ROW, c = tid % PER_ROW;
      const int64_t row = r0 + r;
      const int kk = k0 + c * (16 / sizeof(T));
      const bool ok = row < n && kk < d;
      cp_async16(Ds + r * LD + c * (16 / sizeof(T)), D + (ok ? row * d + kk : 0), ok);
    }
  } else {
    for (int e = tid; e < SK * SN; e += ST) {
      const int kr = e / SN, c = e % SN;
      Ws[kr * SN + c] = (k0 + kr < d && c0 + c < m)
                            ? W[static_cast<int64_t>(k0 + kr) * m + c0 + c] : 0.f;
    }
    for (int e = tid; e < SRB * SK; e += ST) {
      const int r = e / SK, kk = e % SK;
      const int64_t row = r0 + r;
      Ds[r * LD + kk] = (row < n && k0 + kk < d) ? D[row * d + k0 + kk] : T(0.f);
    }
  }
}

// KD d-values of one slab into the thread's SRW chains (rows a, a + LD, ...
// of the slab, broadcast to the warp; column w[.. * SN], one a lane): every
// operand is loaded, then the warp synchronises, then the FMAs run, so the
// chains wait for one load latency a slab and not one a step (left to
// itself the compiler issues each load just before its FMA).
template <int KD, typename T>
__device__ __forceinline__ void small_fma(const T* a, const float* w, float (&acc)[SRW]) {
  constexpr int LD = SSlab<T>::LD;
  float4 dv[SRW][KD / 4];
  float wv[KD];
#pragma unroll
  for (int r = 0; r < SRW; ++r)
#pragma unroll
    for (int j = 0; j < KD / 4; ++j) dv[r][j] = load4(a + r * LD + 4 * j);
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) wv[kk] = w[kk * SN];
  __syncwarp();
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
#pragma unroll
    for (int r = 0; r < SRW; ++r) acc[r] = fmaf(comp(dv[r][kk / 4], kk % 4), wv[kk], acc[r]);
}

// Few rows of D W: CTA b owns rows [8 (b / ntn), +8) and columns [32 (b %
// ntn), +32); lane l of warp w computes column l of rows 2 w and 2 w + 1,
// each one chain of ceil(d / 16) * 16 fmaf in ascending d (the last slab
// may be 16 deep), as the tiled kernel. A warp whose rows all lie past n runs
// no FMA. Bound on an H100: latency, d dependent FMAs a chain (about 1.5 us
// at d 768), then W's bytes once per 8 rows from L2.
template <typename T, bool QUANT, bool VEC>
__global__ void __launch_bounds__(ST)
pca_project_small_kernel(const T* __restrict__ D, const float* __restrict__ W,
                         const float* __restrict__ scale, void* __restrict__ out, int64_t n,
                         int d, int m) {
  constexpr int LD = SSlab<T>::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ws = reinterpret_cast<float*>(smem);                            // [SSTAGES][SK][SN]
  T* Ds = reinterpret_cast<T*>(smem + SSTAGES * SK * SN * 4);            // [SSTAGES][SRB][LD]
  const int ntn = (m + SN - 1) / SN;
  const int64_t r0 = (static_cast<int64_t>(blockIdx.x) / ntn) * SRB;
  const int c0 = (blockIdx.x % ntn) * SN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int dpad = (d + PK - 1) / PK * PK;     // the tiled kernel's chain length
  const int nslab = (dpad + SK - 1) / SK;
  const bool live = r0 + warp * SRW < n;

  float acc[SRW];
#pragma unroll
  for (int r = 0; r < SRW; ++r) acc[r] = 0.f;
  auto load = [&](int s) {
    const int st = s % SSTAGES;
    load_small_slab<T, VEC>(D, W, Ws + st * SK * SN, Ds + st * SRB * LD, n, d, m, r0, c0,
                            s * SK, tid);
  };
#pragma unroll
  for (int s = 0; s < SSTAGES - 1; ++s) {
    if (s < nslab) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < nslab; ++s) {
    cp_async_wait<SSTAGES - 2>();      // slab s has landed (this thread's copies)
    __syncthreads();                   // ... everyone's; and slab s - 1 is consumed
    if (s + SSTAGES - 1 < nslab) load(s + SSTAGES - 1);
    cp_async_commit();
    if (live) {
      const int st = s % SSTAGES;
      const T* a = Ds + st * SRB * LD + warp * SRW * LD;
      const float* w = Ws + st * SK * SN + lane;
      if (dpad - s * SK >= SK)         // the last slab may be 16 deep
        small_fma<SK>(a, w, acc);
      else
        small_fma<PK>(a, w, acc);
    }
  }
  cp_async_wait<0>();

  const int c = c0 + lane;
  if (c >= m) return;
  float inv = 0.f;
  if (QUANT) inv = 1.0f / fmaxf(scale[c], 1e-12f);   // IEEE divide, as the tiled kernel
#pragma unroll
  for (int r = 0; r < SRW; ++r) {
    const int64_t row = r0 + warp * SRW + r;
    if (row >= n) continue;
    if (QUANT)
      static_cast<int8_t*>(out)[row * m + c] = quant(acc[r], inv);
    else
      store1(static_cast<T*>(out), row * m + c, acc[r]);
  }
}

template <typename T, bool QUANT, bool VEC>
cudaError_t launch_one(const T* D, const float* W, const float* scale, void* out,
                       int64_t n, int d, int m, bool small, cudaStream_t stream) {
  if (small) {
    const int64_t ctas = ((n + SRB - 1) / SRB) * ((m + SN - 1) / SN);
    if (ctas > 0x7fffffff) return cudaErrorInvalidValue;
    pca_project_small_kernel<T, QUANT, VEC><<<static_cast<unsigned>(ctas), ST,
                                              SSTAGES * small_stage_bytes<T>(), stream>>>(
        D, W, scale, out, n, d, m);
    return cudaGetLastError();
  }
  const int64_t tiles = ((n + PB - 1) / PB) * ((m + PN - 1) / PN);
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  auto kern = pca_project_kernel<T, QUANT, VEC>;
  const int smem = STAGES * (PB * ASlab<T>::LD * static_cast<int>(sizeof(T)) + PK * PN * 4);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<static_cast<unsigned>(tiles), PT, smem, stream>>>(D, W, scale, out, n, d, m);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* D, const float* W, const float* scale, void* out,
           int64_t n, int d, int m, bool small, cudaStream_t stream) {
  const T* Dt = static_cast<const T*>(D);
  // the small kernel stores one value a lane: the output's alignment does
  // not matter to it
  const bool vec = d % PK == 0 && m % 4 == 0 && reinterpret_cast<uintptr_t>(D) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(W) % 16 == 0 &&
                   (small || reinterpret_cast<uintptr_t>(out) % 16 == 0);
  cudaError_t err;
  if (scale != nullptr)
    err = vec ? launch_one<T, true, true>(Dt, W, scale, out, n, d, m, small, stream)
              : launch_one<T, true, false>(Dt, W, scale, out, n, d, m, small, stream);
  else
    err = vec ? launch_one<T, false, true>(Dt, W, nullptr, out, n, d, m, small, stream)
              : launch_one<T, false, false>(Dt, W, nullptr, out, n, d, m, small, stream);
  return static_cast<int>(err);
}

}  // namespace

// dtype of D: 0 = f32, 1 = bf16. W is (d, m) f32. With scale == nullptr the
// output is D's dtype; with an (m,) f32 scale it is int8. path: 0 = the
// 128 x 128 tiled kernel, 1 = the few-row kernel (the wrapper's
// project_path); both give the same bits.
extern "C" int pca_project_f32(const void* D, const void* W, const void* scale,
                               void* out, int64_t n, int d, int m, int dtype,
                               void* stream, int path) {
  auto s = static_cast<cudaStream_t>(stream);
  auto w = static_cast<const float*>(W);
  auto sc = static_cast<const float*>(scale);
  if (path != 0 && path != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return launch<float>(D, w, sc, out, n, d, m, path == 1, s);
  if (dtype == 1) return launch<__nv_bfloat16>(D, w, sc, out, n, d, m, path == 1, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

namespace {

template <typename T>
int project_smem(int) {
  return STAGES * (PB * ASlab<T>::LD * static_cast<int>(sizeof(T)) + PK * PN * 4);
}
template <typename T>
int small_smem(int) { return SSTAGES * small_stage_bytes<T>(); }

#define PROJECT(K, T, TN, Q, QN, V, VN, THREADS, SMEM)                                     \
  {#K "<" TN "," QN "," VN ">", reinterpret_cast<const void*>(K<T, Q, V>), THREADS, SMEM<T>}
#define PROJECTS(K, T, TN, THREADS, SMEM)                                                  \
  PROJECT(K, T, TN, false, "plain", true, "vec", THREADS, SMEM),                          \
      PROJECT(K, T, TN, false, "plain", false, "scalar", THREADS, SMEM),                  \
      PROJECT(K, T, TN, true, "quant", true, "vec", THREADS, SMEM),                       \
      PROJECT(K, T, TN, true, "quant", false, "scalar", THREADS, SMEM)

const KernelEntry KERNELS[] = {
    PROJECTS(pca_project_kernel, float, "f32", PT, project_smem),
    PROJECTS(pca_project_kernel, __nv_bfloat16, "bf16", PT, project_smem),
    PROJECTS(pca_project_small_kernel, float, "f32", ST, small_smem),
    PROJECTS(pca_project_small_kernel, __nv_bfloat16, "bf16", ST, small_smem)};
#undef PROJECTS
#undef PROJECT

}  // namespace

// The resource check's view of every kernel in this file (common.cuh's
// kernel_attrs); m is unused (neither kernel's tile depends on the width).
extern "C" int pca_project_kernel_attrs(int i, int m, const char** name, int* attrs) {
  return kernel_attrs(KERNELS, static_cast<int>(sizeof(KERNELS) / sizeof(KERNELS[0])), i, m,
                      name, attrs);
}
