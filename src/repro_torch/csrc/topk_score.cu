// Exact top-k of Q D^T per query: the per-request kernel of the search path.
//
// Replaces: src/repro/kernels/topk_score.py::topk_score_pallas, plain mode
// (ids are row positions, rows with id >= n_valid are masked) and row_ids
// mode (each row reports row_ids[row], negative ids are masked).
//
// Bound on an H100: at the serving shapes (B = 32 queries, m = 384) an f32
// index is about even between bytes (n m 4 over 3.35 TB/s) and fp32 FMA
// (2 B n m over 67 TFLOP/s); an int8 index moves a quarter of the bytes and
// is bound by the FMAs. The index is read once per 32-query tile in its
// storage dtype and upcast in registers.
//
// The TPU kernel walks the whole index in one sequential grid per batch
// tile, carrying a running top-k. At B <= 128 that would be one CTA on a
// 132-SM card, so here n is split instead:
//   1. topk_chunk_kernel: one CTA per (512-row chunk, 32-query tile). It
//      scores its chunk with a register-blocked fp32 product into shared
//      memory, then each warp selects, per query, the chunk's top k.
//   2. topk_merge_kernel: one warp per (group of chunk lists, query) keeps
//      the top k of the group; launched again until one list remains, and
//      the last launch writes scores and ids.
// Every candidate is a 64-bit key that orders (score desc, id asc), so the
// result does not depend on the order chunks are visited or merged: the
// lowest-id tie-break, n_valid masking and the (-inf, -1) pads all follow
// from that one order. k <= 32 selects by repeated warp arg-max over keys
// held in registers; larger k (up to 1024) sorts keys in shared memory.
// The TPU kernel's block-skip guard and lane-fold select are not carried.
//
// Paged mode replaces src/repro/kernels/topk_score.py::
// topk_score_paged_pallas: the index lives in fixed pages of R rows behind
// an int32 page table (a stable pool and an append tail), and a call walks
// logical slots [lo, hi). The TPU kernel pipelines page DMAs through one
// sequential walk; here topk_page_kernel takes one CTA per (page, or
// 512-row piece of a page, 32-query tile), reads the page in its storage
// dtype straight from whichever tier the table names, folds the page's
// scale row into the query tile, and hands k keys per query to the same
// merge kernel. A carry (B, k) from an earlier call enters the merge as one
// more list. The bound is the dense kernel's over the walked pages.
#include "common.cuh"

namespace {

constexpr int CQ = 32;          // queries per tile
constexpr int CR = 512;         // index rows per chunk
constexpr int CK = 16;          // slab depth over m
constexpr int CT = 256;         // threads of the chunk kernel: 8 warps
constexpr int QLD = CQ + 4;
constexpr int DLD = CR + 4;
constexpr int SMALL_K = 32;     // k at or below: register select
constexpr int K_CAP = 1024;
constexpr int MERGE_SMALL = 1024;   // candidates per warp in a register merge
constexpr int MT = 128;             // threads of the merge kernel: 4 warps
constexpr unsigned FULL = 0xffffffffu;

// (-inf, id -1): beats every real row at -inf, loses to every finite score.
constexpr uint64_t PAD_KEY = (static_cast<uint64_t>(0x007FFFFFu) << 32) | 0x80000000u;

__device__ __forceinline__ uint64_t encode_key(float s, int id) {
  if (s == 0.0f) s = 0.0f;      // -0 and +0 tie, as they do in the reference
  const unsigned bits = __float_as_uint(s);
  const unsigned hi = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  const unsigned lo = static_cast<unsigned>(0x7FFFFFFFLL - static_cast<long long>(id));
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

__device__ __forceinline__ float key_score(uint64_t key) {
  const unsigned hi = static_cast<unsigned>(key >> 32);
  return __uint_as_float((hi & 0x80000000u) ? (hi & 0x7FFFFFFFu) : ~hi);
}

__device__ __forceinline__ int key_id(uint64_t key) {
  return static_cast<int>(0x7FFFFFFFLL - static_cast<long long>(key & 0xFFFFFFFFull));
}

__device__ __forceinline__ uint64_t warp_max(uint64_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const uint64_t o = __shfl_xor_sync(FULL, v, off);
    v = o > v ? o : v;
  }
  return v;
}

// Emit the k largest of the warp's PER_LANE * 32 keys, in descending order.
// Keys at or below PAD_KEY come out as PAD_KEY.
template <int PER_LANE, typename Emit>
__device__ __forceinline__ void warp_extract(uint64_t (&keys)[PER_LANE], int k,
                                             Emit emit) {
  const int lane = threadIdx.x & 31;
  uint64_t local = 0;
#pragma unroll
  for (int t = 0; t < PER_LANE; ++t) local = keys[t] > local ? keys[t] : local;
  int j = 0;
  for (; j < k; ++j) {
    const uint64_t best = warp_max(local);
    if (best <= PAD_KEY) break;
    if (lane == 0) emit(j, best);
    const unsigned owner = __ffs(__ballot_sync(FULL, local == best)) - 1;
    if (lane == static_cast<int>(owner)) {
      bool removed = false;
      uint64_t next = 0;
#pragma unroll
      for (int t = 0; t < PER_LANE; ++t) {
        if (!removed && keys[t] == best) { keys[t] = 0; removed = true; }
        next = keys[t] > next ? keys[t] : next;
      }
      local = next;
    }
  }
  for (int jj = j + lane; jj < k; jj += 32) emit(jj, PAD_KEY);
}

// Bitonic sort of N keys (a power of two) in shared memory, descending, by
// one warp.
__device__ void warp_bitonic_desc(uint64_t* buf, int N) {
  const int lane = threadIdx.x & 31;
  for (int size = 2; size <= N; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = lane; i < N / 2; i += 32) {
        const int lo = (i / stride) * 2 * stride + (i % stride);
        const int hi = lo + stride;
        const uint64_t a = buf[lo], b = buf[hi];
        const bool desc = (lo & size) == 0;
        if (desc ? (a < b) : (a > b)) { buf[lo] = b; buf[hi] = a; }
      }
      __syncwarp();
    }
  }
}

// 16 consecutive elements (one slab row) upcast to f32, 16-byte loads.
__device__ __forceinline__ void load_slab(const float* p, float (&v)[CK]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 x = reinterpret_cast<const float4*>(p)[i];
    v[4 * i] = x.x; v[4 * i + 1] = x.y; v[4 * i + 2] = x.z; v[4 * i + 3] = x.w;
  }
}
__device__ __forceinline__ void load_slab(const __nv_bfloat16* p, float (&v)[CK]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 x = reinterpret_cast<const uint4*>(p)[i];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[8 * i + 2 * j] = f.x; v[8 * i + 2 * j + 1] = f.y;
    }
  }
}
__device__ __forceinline__ void load_slab(const int8_t* p, float (&v)[CK]) {
  const int4 x = *reinterpret_cast<const int4*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&x);
#pragma unroll
  for (int i = 0; i < CK; ++i) v[i] = static_cast<float>(b[i]);
}

template <typename T, bool WITH_IDS, bool VEC, bool BIG_K>
__global__ void __launch_bounds__(CT)
topk_chunk_kernel(const T* __restrict__ D, const float* __restrict__ Q,
                  const int* __restrict__ row_ids, int64_t n, int m, int B,
                  int64_t n_valid, int k, int nchunks,
                  uint64_t* __restrict__ cand) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);                 // [CK][QLD]
  float* Ds = Qs + CK * QLD;                                   // [CK][DLD]
  float* Ss = reinterpret_cast<float*>(smem);                 // [CQ][CR], after the product
  uint64_t* Kbuf = reinterpret_cast<uint64_t*>(smem + CQ * CR * sizeof(float));
  const int chunk = blockIdx.x;
  const int q0 = blockIdx.y * CQ;
  const int64_t row0 = static_cast<int64_t>(chunk) * CR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  float acc[4][16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < m; k0 += CK) {
    for (int e = tid; e < CQ * CK; e += CT) {
      const int q = e / CK, kk = e % CK;
      Qs[kk * QLD + q] = (q0 + q < B && k0 + kk < m)
                             ? Q[static_cast<int64_t>(q0 + q) * m + k0 + kk] : 0.f;
    }
    if (VEC) {
      // one thread per slab row: conflict-free column stores
      for (int r = tid; r < CR; r += CT) {
        const int64_t row = row0 + r;
        float v[CK];
        if (row < n) {
          load_slab(D + row * m + k0, v);
        } else {
#pragma unroll
          for (int kk = 0; kk < CK; ++kk) v[kk] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < CK; ++kk) Ds[kk * DLD + r] = v[kk];
      }
    } else {
      for (int e = tid; e < CR * CK; e += CT) {
        const int r = e / CK, kk = e % CK;
        const int64_t row = row0 + r;
        Ds[kk * DLD + r] = (row < n && k0 + kk < m) ? to_f32(D[row * m + k0 + kk]) : 0.f;
      }
    }
    __syncthreads();
    tile_fma<CQ, CR, CK, 1, 4, QLD, DLD>(Qs, Ds, acc, warp, lane);
    __syncthreads();
  }

  // scores to shared memory: the slabs are dead, every read is behind the
  // barrier above
#pragma unroll
  for (int si = 0; si < 4; ++si) {
    const int q = warp * 4 + si;
#pragma unroll
    for (int jg = 0; jg < 4; ++jg) {
      float4 v = make_float4(acc[si][4 * jg], acc[si][4 * jg + 1],
                             acc[si][4 * jg + 2], acc[si][4 * jg + 3]);
      *reinterpret_cast<float4*>(Ss + q * CR + jg * (CR / 4) + lane * 4) = v;
    }
  }
  __syncthreads();

  // lane holds rows lane + 32 t of the chunk
  int ids[CR / 32];
  bool ok[CR / 32];
#pragma unroll
  for (int t = 0; t < CR / 32; ++t) {
    const int64_t row = row0 + lane + 32 * t;
    ids[t] = -1;
    ok[t] = false;
    if (row < n) {
      if (WITH_IDS) {
        ids[t] = row_ids[row];
        ok[t] = ids[t] >= 0;
      } else {
        ids[t] = static_cast<int>(row);
        ok[t] = row < n_valid;
      }
    }
  }

  for (int qi = 0; qi < 4; ++qi) {
    const int q = warp * 4 + qi;
    if (q0 + q >= B) break;
    uint64_t* dst = cand + (static_cast<int64_t>(q0 + q) * nchunks + chunk) * k;
    const float* srow = Ss + q * CR;
    if (!BIG_K) {
      uint64_t keys[CR / 32];
#pragma unroll
      for (int t = 0; t < CR / 32; ++t)
        keys[t] = ok[t] ? encode_key(srow[lane + 32 * t], ids[t]) : PAD_KEY;
      warp_extract<CR / 32>(keys, k, [&](int j, uint64_t key) { dst[j] = key; });
    } else {
      uint64_t* buf = Kbuf + warp * CR;
#pragma unroll
      for (int t = 0; t < CR / 32; ++t)
        buf[lane + 32 * t] = ok[t] ? encode_key(srow[lane + 32 * t], ids[t]) : PAD_KEY;
      __syncwarp();
      warp_bitonic_desc(buf, CR);
      for (int j = lane; j < k; j += 32) dst[j] = j < CR ? buf[j] : PAD_KEY;
      __syncwarp();
    }
  }
}

// With `unfinal` the last level numbers the -inf slots as the reference's
// un-finalized running list does: slot j after c finite slots gets id
// -(j - c + 2), so a carry chained into a later call keeps the same ids.
template <bool BIG_K>
__global__ void __launch_bounds__(MT)
topk_merge_kernel(const uint64_t* __restrict__ cand, int L, int k, int G,
                  int Lout, int cap, uint64_t* __restrict__ next,
                  float* __restrict__ out_s, int* __restrict__ out_i,
                  int unfinal) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = blockIdx.x * (MT / 32) + warp;
  const int q = blockIdx.y;
  if (g >= Lout) return;                       // whole warp; no block barrier below
  const int l0 = g * G;
  const int C = (G < L - l0 ? G : L - l0) * k;
  const uint64_t* src = cand + (static_cast<int64_t>(q) * L + l0) * k;
  auto emit = [&](int j, uint64_t key) {
    if (next == nullptr) {
      const float s = key_score(key);
      out_s[static_cast<int64_t>(q) * k + j] = s;
      out_i[static_cast<int64_t>(q) * k + j] =
          s == __int_as_float(0xff800000) ? -1 : key_id(key);   // -inf slots are pads
    } else {
      next[(static_cast<int64_t>(q) * Lout + g) * k + j] = key;
    }
  };
  if (!BIG_K) {
    uint64_t keys[MERGE_SMALL / 32];
#pragma unroll
    for (int t = 0; t < MERGE_SMALL / 32; ++t) {
      const int idx = lane + 32 * t;
      keys[t] = idx < C ? src[idx] : 0;
    }
    warp_extract<MERGE_SMALL / 32>(keys, k, emit);
  } else {
    uint64_t* buf = reinterpret_cast<uint64_t*>(smem) + static_cast<int64_t>(warp) * cap;
    for (int i = lane; i < cap; i += 32) buf[i] = i < C ? src[i] : 0;
    __syncwarp();
    warp_bitonic_desc(buf, cap);
    for (int j = lane; j < k; j += 32) emit(j, buf[j]);
  }
  if (next == nullptr && unfinal) {
    __syncwarp();                               // the warp's own stores above
    const float* srow = out_s + static_cast<int64_t>(q) * k;
    int* irow = out_i + static_cast<int64_t>(q) * k;
    int c = 0;
    for (int j0 = 0; j0 < k; j0 += 32) {
      const int j = j0 + lane;
      c += __popc(__ballot_sync(FULL, j < k && srow[j] != __int_as_float(0xff800000)));
    }
    for (int j = lane; j < k; j += 32)
      if (srow[j] == __int_as_float(0xff800000)) irow[j] = -(j - c + 2);
  }
}

// Paged chunk kernel: one CTA per (PR-row piece of a logical page slot in
// [lo, hi), 32-query tile); piece `list` of the launch covers rows
// [r0, r0 + PR) of slot lo + list / ppp. The page table picks the tier:
// entries below pool_pages address the pool, the rest the tail; an entry
// outside both masks the page. With a scale row the query tile is
// multiplied by it before the product (the reference's fold order), then
// the same fp32 FMA chain as the dense chunk kernel, so an unmodified base
// scores bitwise as it does there. Row r reports page_offset[slot] + r and
// is masked at or beyond page_nvalid[slot]; with ids_pool it reports
// ids_pool[slot, r] and negative ids are masked.
template <typename T, bool BIG_K, int PR>
__global__ void __launch_bounds__(CT)
topk_page_kernel(const T* __restrict__ pool, const T* __restrict__ tail,
                 const int* __restrict__ table, const int* __restrict__ nvalid,
                 const int* __restrict__ offset, const float* __restrict__ scale,
                 const int* __restrict__ ids_pool, const float* __restrict__ Q,
                 int pool_pages, int tail_pages, int R, int m, int B, int lo,
                 int ppp, int k, int nlists, int vec,
                 uint64_t* __restrict__ cand) {
  constexpr int DLDP = PR + 4;
  constexpr int JN = PR / 128;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);                 // [CK][QLD]
  float* Ds = Qs + CK * QLD;                                   // [CK][DLDP]
  float* Ss = reinterpret_cast<float*>(smem);                 // [CQ][PR], after the product
  uint64_t* Kbuf = reinterpret_cast<uint64_t*>(smem + CQ * PR * sizeof(float));
  const int list = blockIdx.x;
  const int64_t slot = lo + list / ppp;
  const int r0 = (list % ppp) * PR;
  const int q0 = blockIdx.y * CQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const int phys = table[slot];
  const T* page = nullptr;
  if (phys >= 0 && phys < pool_pages)
    page = pool + static_cast<int64_t>(phys) * R * m;
  else if (phys >= pool_pages && phys - pool_pages < tail_pages)
    page = tail + static_cast<int64_t>(phys - pool_pages) * R * m;
  const int rows = page == nullptr ? 0 : min(PR, R - r0);
  const float* srow = scale == nullptr ? nullptr : scale + slot * m;

  float acc[4][4 * JN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * JN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < m; k0 += CK) {
    for (int e = tid; e < CQ * CK; e += CT) {
      const int q = e / CK, kk = e % CK;
      float v = 0.f;
      if (q0 + q < B && k0 + kk < m) {
        v = Q[static_cast<int64_t>(q0 + q) * m + k0 + kk];
        if (srow != nullptr) v *= srow[k0 + kk];
      }
      Qs[kk * QLD + q] = v;
    }
    if (vec) {
      for (int r = tid; r < PR; r += CT) {
        float v[CK];
        if (r < rows) {
          load_slab(page + static_cast<int64_t>(r0 + r) * m + k0, v);
        } else {
#pragma unroll
          for (int kk = 0; kk < CK; ++kk) v[kk] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < CK; ++kk) Ds[kk * DLDP + r] = v[kk];
      }
    } else {
      for (int e = tid; e < PR * CK; e += CT) {
        const int r = e / CK, kk = e % CK;
        Ds[kk * DLDP + r] = (r < rows && k0 + kk < m)
                                ? to_f32(page[static_cast<int64_t>(r0 + r) * m + k0 + kk]) : 0.f;
      }
    }
    __syncthreads();
    tile_fma<CQ, PR, CK, 1, JN, QLD, DLDP>(Qs, Ds, acc, warp, lane);
    __syncthreads();
  }

#pragma unroll
  for (int si = 0; si < 4; ++si) {
    const int q = warp * 4 + si;
#pragma unroll
    for (int jg = 0; jg < JN; ++jg) {
      float4 v = make_float4(acc[si][4 * jg], acc[si][4 * jg + 1],
                             acc[si][4 * jg + 2], acc[si][4 * jg + 3]);
      *reinterpret_cast<float4*>(Ss + q * PR + jg * 128 + lane * 4) = v;
    }
  }
  __syncthreads();

  // lane holds piece rows lane + 32 t
  const int nv = nvalid[slot];
  const int off = offset[slot];
  int ids[PR / 32];
  bool ok[PR / 32];
#pragma unroll
  for (int t = 0; t < PR / 32; ++t) {
    const int r = lane + 32 * t;
    const int pr = r0 + r;
    ids[t] = -1;
    ok[t] = false;
    if (r < rows) {
      if (ids_pool != nullptr) {
        ids[t] = ids_pool[slot * R + pr];
        ok[t] = ids[t] >= 0;
      } else {
        ids[t] = off + pr;
        ok[t] = pr < nv;
      }
    }
  }

  for (int qi = 0; qi < 4; ++qi) {
    const int q = warp * 4 + qi;
    if (q0 + q >= B) break;
    uint64_t* dst = cand + (static_cast<int64_t>(q0 + q) * nlists + list) * k;
    const float* sq = Ss + q * PR;
    if (!BIG_K) {
      uint64_t keys[PR / 32];
#pragma unroll
      for (int t = 0; t < PR / 32; ++t)
        keys[t] = ok[t] ? encode_key(sq[lane + 32 * t], ids[t]) : PAD_KEY;
      warp_extract<PR / 32>(keys, k, [&](int j, uint64_t key) { dst[j] = key; });
    } else {
      uint64_t* buf = Kbuf + warp * PR;
#pragma unroll
      for (int t = 0; t < PR / 32; ++t)
        buf[lane + 32 * t] = ok[t] ? encode_key(sq[lane + 32 * t], ids[t]) : PAD_KEY;
      __syncwarp();
      warp_bitonic_desc(buf, PR);
      for (int j = lane; j < k; j += 32) dst[j] = j < PR ? buf[j] : PAD_KEY;
      __syncwarp();
    }
  }
}

// The carry (B, k) enters the merge as list nlists - 1 of every query; its
// -inf slots are pads.
__global__ void carry_keys_kernel(const float* __restrict__ cs,
                                  const int* __restrict__ ci, int B, int k,
                                  int nlists, uint64_t* __restrict__ cand) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<int64_t>(B) * k) return;
  const int64_t q = e / k;
  const int j = static_cast<int>(e % k);
  const float s = cs[e];
  cand[(q * nlists + nlists - 1) * k + j] =
      s == __int_as_float(0xff800000) ? PAD_KEY : encode_key(s, ci[e]);
}

struct Plan {
  int nchunks, G, cap;
};

// L lists of k keys per query: how many lists one merge warp joins.
Plan plan_lists(int64_t L, int k) {
  Plan p;
  p.nchunks = static_cast<int>(L);
  if (k <= SMALL_K) {
    p.cap = MERGE_SMALL;
  } else {
    p.cap = 64;
    while (p.cap < 2 * k) p.cap <<= 1;
  }
  p.G = p.cap / k;
  return p;
}

Plan plan_for(int64_t n, int k) { return plan_lists((n + CR - 1) / CR, k); }

// The merge levels after a first kernel left L lists of k keys per query in
// `a`: one launch per level, alternating between a and b, until one list is
// left; the last level writes scores and ids.
int run_merges(const Plan& p, int L, int B, int k, uint64_t* a, uint64_t* b,
               void* out_s, void* out_i, int unfinal, cudaStream_t s,
               int* launched) {
  const bool big = k > SMALL_K;
  const size_t msmem = big ? (MT / 32) * static_cast<size_t>(p.cap) * sizeof(uint64_t) : 0;
  cudaError_t err;
  if (big) {
    err = cudaFuncSetAttribute(topk_merge_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(msmem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  uint64_t* src = a;
  uint64_t* dst = b;
  auto* os = static_cast<float*>(out_s);
  auto* oi = static_cast<int*>(out_i);
  while (true) {
    const int Lout = (L + p.G - 1) / p.G;
    const bool last = Lout == 1;
    const dim3 grid((Lout + MT / 32 - 1) / (MT / 32), B);
    uint64_t* next = last ? nullptr : dst;
    if (big)
      topk_merge_kernel<true><<<grid, MT, msmem, s>>>(src, L, k, p.G, Lout, p.cap, next, os, oi, unfinal);
    else
      topk_merge_kernel<false><<<grid, MT, 0, s>>>(src, L, k, p.G, Lout, p.cap, next, os, oi, unfinal);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launched;
    if (last) break;
    L = Lout;
    uint64_t* t = src;
    src = dst;
    dst = t;
  }
  return 0;
}

template <typename T, bool WITH_IDS, bool VEC, bool BIG_K>
cudaError_t launch_chunks(const void* D, const float* Q, const int* ids,
                          int64_t n, int m, int B, int64_t n_valid, int k,
                          int nchunks, uint64_t* cand, cudaStream_t stream) {
  auto kern = topk_chunk_kernel<T, WITH_IDS, VEC, BIG_K>;
  const size_t smem = CQ * CR * sizeof(float) + (BIG_K ? (CT / 32) * CR * sizeof(uint64_t) : 0);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(nchunks, (B + CQ - 1) / CQ);
  kern<<<grid, CT, smem, stream>>>(static_cast<const T*>(D), Q, ids, n, m, B,
                                   n_valid, k, nchunks, cand);
  return cudaGetLastError();
}

template <typename T, bool WITH_IDS>
cudaError_t dispatch_chunks(bool vec, bool big, const void* D, const float* Q,
                            const int* ids, int64_t n, int m, int B,
                            int64_t n_valid, int k, int nchunks, uint64_t* cand,
                            cudaStream_t s) {
  if (vec && big) return launch_chunks<T, WITH_IDS, true, true>(D, Q, ids, n, m, B, n_valid, k, nchunks, cand, s);
  if (vec) return launch_chunks<T, WITH_IDS, true, false>(D, Q, ids, n, m, B, n_valid, k, nchunks, cand, s);
  if (big) return launch_chunks<T, WITH_IDS, false, true>(D, Q, ids, n, m, B, n_valid, k, nchunks, cand, s);
  return launch_chunks<T, WITH_IDS, false, false>(D, Q, ids, n, m, B, n_valid, k, nchunks, cand, s);
}

template <typename T>
cudaError_t dispatch_dtype(bool with_ids, bool vec, bool big, const void* D,
                           const float* Q, const int* ids, int64_t n, int m,
                           int B, int64_t n_valid, int k, int nchunks,
                           uint64_t* cand, cudaStream_t s) {
  if (with_ids) return dispatch_chunks<T, true>(vec, big, D, Q, ids, n, m, B, n_valid, k, nchunks, cand, s);
  return dispatch_chunks<T, false>(vec, big, D, Q, ids, n, m, B, n_valid, k, nchunks, cand, s);
}

template <typename T, bool BIG_K, int PR>
cudaError_t launch_pages(const void* pool, const void* tail, const int* table,
                         const int* nvalid, const int* offset, const float* scale,
                         const int* ids_pool, const float* Q, int pool_pages,
                         int tail_pages, int R, int m, int B, int lo, int nslots,
                         int ppp, int k, int nlists, int vec, uint64_t* cand,
                         cudaStream_t stream) {
  auto kern = topk_page_kernel<T, BIG_K, PR>;
  const size_t smem = CQ * PR * sizeof(float) + (BIG_K ? (CT / 32) * PR * sizeof(uint64_t) : 0);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(nslots * ppp, (B + CQ - 1) / CQ);
  kern<<<grid, CT, smem, stream>>>(static_cast<const T*>(pool), static_cast<const T*>(tail),
                                   table, nvalid, offset, scale, ids_pool, Q, pool_pages,
                                   tail_pages, R, m, B, lo, ppp, k, nlists, vec, cand);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_pages(bool big, int pr, const void* pool, const void* tail,
                           const int* table, const int* nvalid, const int* offset,
                           const float* scale, const int* ids_pool, const float* Q,
                           int pool_pages, int tail_pages, int R, int m, int B, int lo,
                           int nslots, int ppp, int k, int nlists, int vec,
                           uint64_t* cand, cudaStream_t s) {
#define PAGES(BIG, P) launch_pages<T, BIG, P>(pool, tail, table, nvalid, offset, scale, ids_pool, \
      Q, pool_pages, tail_pages, R, m, B, lo, nslots, ppp, k, nlists, vec, cand, s)
  if (pr == 512) return big ? PAGES(true, 512) : PAGES(false, 512);
  return big ? PAGES(true, 256) : PAGES(false, 256);
#undef PAGES
}

// Rows per CTA of the paged kernel for pages of R rows: 256 up to R = 256,
// else 512 (a page of more rows takes one CTA per 512-row piece).
int piece_rows(int R) { return R <= 256 ? 256 : 512; }

}  // namespace

// Scratch plan for (n, k): out[0] = chunks (lists after the chunk kernel),
// out[1] = lists merged per warp, out[2] = lists after the first merge.
extern "C" int topk_plan(int64_t n, int k, int64_t* out) {
  if (n < 1 || k < 1 || k > K_CAP) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan_for(n, k);
  out[0] = p.nchunks;
  out[1] = p.G;
  out[2] = (p.nchunks + p.G - 1) / p.G;
  return 0;
}

// D (n, m) in dtype 0 = f32, 1 = bf16, 2 = int8; Q (B, m) f32; row_ids
// (n,) int32 or null. scratch_a holds B * chunks * k keys, scratch_b
// B * (lists after the first merge) * k keys. Writes out_s (B, k) f32 and
// out_i (B, k) int32. `vec` asserts m % 16 == 0 and a 16-byte aligned D.
// *launched counts the kernel launches made (the chunk kernel and each
// merge level). Returns the first cudaError_t.
extern "C" int topk_score_f32(const void* D, const void* Q, const void* row_ids,
                              int64_t n, int m, int B, int64_t n_valid, int k,
                              int dtype, int vec, void* scratch_a,
                              void* scratch_b, void* out_s, void* out_i,
                              void* stream, int* launched) {
  auto s = static_cast<cudaStream_t>(stream);
  auto q = static_cast<const float*>(Q);
  auto ids = static_cast<const int*>(row_ids);
  *launched = 0;
  if (n < 1 || k < 1 || k > K_CAP || B < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan_for(n, k);
  const bool big = k > SMALL_K;
  auto* a = static_cast<uint64_t*>(scratch_a);
  auto* b = static_cast<uint64_t*>(scratch_b);
  cudaError_t err;
  if (dtype == 0) err = dispatch_dtype<float>(ids != nullptr, vec, big, D, q, ids, n, m, B, n_valid, k, p.nchunks, a, s);
  else if (dtype == 1) err = dispatch_dtype<__nv_bfloat16>(ids != nullptr, vec, big, D, q, ids, n, m, B, n_valid, k, p.nchunks, a, s);
  else if (dtype == 2) err = dispatch_dtype<int8_t>(ids != nullptr, vec, big, D, q, ids, n, m, B, n_valid, k, p.nchunks, a, s);
  else return static_cast<int>(cudaErrorInvalidValue);
  if (err != cudaSuccess) return static_cast<int>(err);
  ++*launched;

  return run_merges(p, p.nchunks, B, k, a, b, out_s, out_i, 0, s, launched);
}

// Scratch plan of the paged kernel over `slots` page slots of R rows, plus
// the carry list when `carry` is set: out[0] = lists after the paged kernel,
// out[1] = lists merged per warp, out[2] = lists after the first merge.
extern "C" int topk_paged_plan(int64_t slots, int R, int k, int carry, int64_t* out) {
  if (slots < 0 || R < 1 || k < 1 || k > K_CAP) return static_cast<int>(cudaErrorInvalidValue);
  const int pr = piece_rows(R);
  const int64_t lists = slots * ((R + pr - 1) / pr) + (carry ? 1 : 0);
  if (lists < 1 || lists > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan_lists(lists, k);
  out[0] = lists;
  out[1] = p.G;
  out[2] = (lists + p.G - 1) / p.G;
  return 0;
}

// Exact top-k over logical page slots [lo, hi) of a page table.
// pool (pool_pages, R, m) and tail (tail_pages, R, m, or null) in dtype
// 0 = f32, 1 = bf16, 2 = int8; table, nvalid, offset (>= hi,) int32;
// scale (>= hi, m) f32 or null; ids_pool (>= hi, R) int32 or null; Q (B, m)
// f32; carry_s / carry_i (B, k) or null. Scratch as topk_paged_plan says:
// scratch_a B * out[0] * k keys, scratch_b B * out[2] * k keys. Writes
// out_s (B, k) f32 and out_i (B, k) int32; -inf slots get id -1 with
// `finalize`, else their rank among pads as -(j - c + 2). `vec` asserts
// m % 16 == 0 and 16-byte aligned pool and tail. *launched counts the kernel
// launches made. Returns the first cudaError_t.
extern "C" int topk_score_paged_f32(
    const void* pool, const void* tail, const void* table, const void* nvalid,
    const void* offset, const void* scale, const void* ids_pool, const void* Q,
    const void* carry_s, const void* carry_i, int pool_pages, int tail_pages,
    int R, int m, int B, int lo, int hi, int k, int dtype, int vec, int finalize,
    void* scratch_a, void* scratch_b, void* out_s, void* out_i, void* stream,
    int* launched) {
  auto s = static_cast<cudaStream_t>(stream);
  *launched = 0;
  const bool carry = carry_s != nullptr;
  const int nslots = hi > lo ? hi - lo : 0;
  if (k < 1 || k > K_CAP || B < 1 || B > 65535 || R < 1 || m < 1 || lo < 0 ||
      (nslots == 0 && !carry) || (carry && carry_i == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int pr = piece_rows(R);
  const int ppp = (R + pr - 1) / pr;
  const int64_t lists64 = static_cast<int64_t>(nslots) * ppp + (carry ? 1 : 0);
  if (lists64 > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const int nlists = static_cast<int>(lists64);
  const Plan p = plan_lists(nlists, k);
  const bool big = k > SMALL_K;
  auto* a = static_cast<uint64_t*>(scratch_a);
  auto* b = static_cast<uint64_t*>(scratch_b);
  auto q = static_cast<const float*>(Q);
  auto tb = static_cast<const int*>(table);
  auto nv = static_cast<const int*>(nvalid);
  auto off = static_cast<const int*>(offset);
  auto sc = static_cast<const float*>(scale);
  auto ip = static_cast<const int*>(ids_pool);
  cudaError_t err;
  if (nslots > 0) {
    if (dtype == 0) err = dispatch_pages<float>(big, pr, pool, tail, tb, nv, off, sc, ip, q, pool_pages, tail_pages, R, m, B, lo, nslots, ppp, k, nlists, vec, a, s);
    else if (dtype == 1) err = dispatch_pages<__nv_bfloat16>(big, pr, pool, tail, tb, nv, off, sc, ip, q, pool_pages, tail_pages, R, m, B, lo, nslots, ppp, k, nlists, vec, a, s);
    else if (dtype == 2) err = dispatch_pages<int8_t>(big, pr, pool, tail, tb, nv, off, sc, ip, q, pool_pages, tail_pages, R, m, B, lo, nslots, ppp, k, nlists, vec, a, s);
    else return static_cast<int>(cudaErrorInvalidValue);
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launched;
  }
  if (carry) {
    const int64_t total = static_cast<int64_t>(B) * k;
    carry_keys_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(
        static_cast<const float*>(carry_s), static_cast<const int*>(carry_i), B, k, nlists, a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launched;
  }
  return run_merges(p, nlists, B, k, a, b, out_s, out_i, finalize ? 0 : 1, s, launched);
}
