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
//   1. topk_chunk_kernel: one persistent CTA per SM and 32-query tile
//      walks 512-row chunks. It keeps the query tile in shared memory,
//      streams the chunks through a cp.async ring, scores each with a
//      register-blocked fp32 product, then each warp selects, per query,
//      the chunk's top k into that chunk's candidate list.
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
#include <type_traits>

#include "common.cuh"
#include "pipeline.cuh"

namespace {

constexpr int CQ = 32;          // queries per tile
constexpr int CR = 512;         // index rows per chunk
constexpr int CK = 16;          // slab depth over m
constexpr int CT = 256;         // threads of the chunk kernel: 8 warps
constexpr int QLD = CQ + 4;
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

// Emit the k largest of the warp's PER_LANE * 32 keys, in descending order:
// emit(j, key) from one lane per slot, and each(key) from every lane for
// each key above PAD_KEY, in order. Keys at or below PAD_KEY come out as
// PAD_KEY.
template <int PER_LANE, typename Emit, typename Each>
__device__ __forceinline__ void warp_extract(uint64_t (&keys)[PER_LANE], int k,
                                             Emit emit, Each each) {
  const int lane = threadIdx.x & 31;
  uint64_t local = 0;
#pragma unroll
  for (int t = 0; t < PER_LANE; ++t) local = keys[t] > local ? keys[t] : local;
  int j = 0;
  for (; j < k; ++j) {
    const uint64_t best = warp_max(local);
    if (best <= PAD_KEY) break;
    if (lane == 0) emit(j, best);
    each(best);
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

struct NoEach {
  __device__ void operator()(uint64_t) const {}
};

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

// Ring geometry of the dense chunk kernel. A D slab is CR rows x CK values.
// As f32 a row's four 16-byte pieces are stored in the order piece ^ ((row
// >> 1) & 3), so the 8 rows a quarter-warp reads at once fall on distinct
// banks with no padding. int8 and bf16 slabs land raw (CK values a row,
// packed) in a 32 KB ring and are upcast once into one of two f32 slabs.
constexpr int RS = CK;
constexpr int KP_MAX = 384;     // m-values of the query tile resident at once
constexpr int HQ = CQ / 2;      // queries whose scores are staged at once
constexpr int SLD = CR + 8;     // score row stride: a warp's 32 stores hit 32 banks
constexpr int RAW_RING = 32768;

template <typename T, bool BIG_K>
struct Chunk {
  static constexpr bool RAW = !std::is_same<T, float>::value;
  static constexpr int STAGE_BYTES = RAW ? CR * CK * static_cast<int>(sizeof(T)) : CR * RS * 4;
  // f32 with the big-k sort buffers has room for three stages
  static constexpr int STAGES = RAW ? RAW_RING / STAGE_BYTES : (BIG_K ? 3 : 4);
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES + (RAW ? 2 * CR * RS * 4 : 0);
};

// Query-tile width for m: whole, rounded up to a slab, or panels of KP_MAX.
__host__ __device__ __forceinline__ int panel_width(int m) {
  const int mp = (m + CK - 1) / CK * CK;
  return mp < KP_MAX ? mp : KP_MAX;
}

// Dynamic shared memory of the chunk kernel: the query tile, half the
// tile's scores, the big-k sort buffers and the ring, side by side, so the
// ring keeps streaming while a chunk's top k is selected.
template <typename T, bool BIG_K>
size_t chunk_smem(int m) {
  return static_cast<size_t>(CQ) * (panel_width(m) + 4) * 4 + HQ * SLD * 4 +
         (BIG_K ? (CT / 32) * CR * sizeof(uint64_t) : 0) + Chunk<T, BIG_K>::RING_BYTES;
}

// Float offset of 16-byte piece c of row r in an f32 slab.
__device__ __forceinline__ int slab_at(int r, int c) { return r * RS + ((c ^ ((r >> 1) & 3)) << 2); }

// Fill ring stage `dst` with slab k0 of chunk rows [row0, row0 + CR), in
// D's storage dtype, as the stage stores it (f32: pieces placed by
// slab_at; raw: CK packed values a row). VEC: 16-byte cp.async pieces (m % 16 == 0, D
// 16-byte aligned); else scalar loads. Out-of-range values are zero.
template <typename T, bool VEC>
__device__ __forceinline__ void load_chunk_slab(const T* __restrict__ D, T* dst, int64_t n,
                                                int m, int64_t row0, int k0, int tid) {
  constexpr bool F32 = std::is_same<T, float>::value;
  if (VEC) {
    constexpr int PER_ROW = CK * sizeof(T) / 16;
#pragma unroll
    for (int i = 0; i < CR * PER_ROW / CT; ++i) {
      const int e = tid + i * CT;
      const int r = e / PER_ROW, c = e % PER_ROW;
      const int64_t row = row0 + r;
      const bool ok = row < n;
      cp_async16(dst + (F32 ? slab_at(r, c) : r * CK + c * (16 / sizeof(T))),
                 D + (ok ? row : 0) * m + k0 + c * (16 / sizeof(T)), ok);
    }
  } else {
    for (int e = tid; e < CR * CK; e += CT) {
      const int r = e / CK, kk = e % CK;
      const int64_t row = row0 + r;
      dst[F32 ? slab_at(r, kk >> 2) + (kk & 3) : r * CK + kk] =
          (row < n && k0 + kk < m) ? D[row * m + k0 + kk] : T(0.f);
    }
  }
}

// 16 int8 as f32, exactly, without the conversion pipe (16 a clock per SM,
// an eighth of the FMA rate): byte b ^ 0x80 = b + 128 is placed in the
// mantissa of 2^23, and 2^23 + 128 is subtracted.
__device__ __forceinline__ void upcast16(const int8_t* p, float (&v)[CK]) {
  const int4 x = *reinterpret_cast<const int4*>(p);
  const unsigned w[4] = {static_cast<unsigned>(x.x) ^ 0x80808080u,
                         static_cast<unsigned>(x.y) ^ 0x80808080u,
                         static_cast<unsigned>(x.z) ^ 0x80808080u,
                         static_cast<unsigned>(x.w) ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < CK; ++i)
    v[i] = __uint_as_float(__byte_perm(w[i / 4], 0x4Bu, 0x4550u | (i % 4))) - 8388736.0f;
}
__device__ __forceinline__ void upcast16(const __nv_bfloat16* p, float (&v)[CK]) { load_slab(p, v); }

// Upcast a raw int8 / bf16 slab into an f32 slab: two rows per thread.
template <typename T>
__device__ __forceinline__ void upcast_slab(const T* raw, float* dst, int tid) {
#pragma unroll
  for (int h = 0; h < CR / CT; ++h) {
    const int r = tid + h * CT;
    float v[CK];
    upcast16(raw + r * CK, v);
#pragma unroll
    for (int c = 0; c < CK / 4; ++c)
      *reinterpret_cast<float4*>(dst + slab_at(r, c)) =
          make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
  }
}

// Query tile panel [kb, kb + kp) of queries [q0, q0 + CQ), scale already
// folded in; zero past B and past m. Eight loads per thread in flight.
__device__ __forceinline__ void load_query_panel(const float* __restrict__ Q, float* Qs,
                                                 int B, int m, int q0, int kb, int kp,
                                                 int tid) {
  const int qld = kp + 4, total = CQ * kp;
  for (int e0 = tid; e0 < total; e0 += 8 * CT) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * CT, q = e / kp, kk = e % kp;
      v[u] = (e < total && q0 + q < B && kb + kk < m)
                 ? Q[static_cast<int64_t>(q0 + q) * m + kb + kk] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * CT;
      if (e < total) Qs[(e / kp) * qld + e % kp] = v[u];
    }
  }
}

// acc[i][j] += Q[4i + qg] . D[64 w + 8j + rg] over one CK-deep slab, k
// ascending: per 4-deep step, 8 query and 8 row 16-byte pieces for 256 FMAs.
__device__ __forceinline__ void slab_fma(const float* Qs, int qld, const float* Ds,
                                         float (&acc)[8][8], int w, int qg, int rg) {
  const float* qb = Qs + qg * qld;
  const float* db = Ds + (w * 64 + rg) * RS;
  const int swz = (rg >> 1) & 3;          // slab_at's order for rows 64 w + 8 j + rg
#pragma unroll
  for (int k4 = 0; k4 < CK; k4 += 4) {
    float4 q[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) q[i] = *reinterpret_cast<const float4*>(qb + 4 * i * qld + k4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 dv =
          *reinterpret_cast<const float4*>(db + 8 * j * RS + (((k4 >> 2) ^ swz) << 2));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i][j] = fmaf(q[i].x, dv.x, acc[i][j]);
        acc[i][j] = fmaf(q[i].y, dv.y, acc[i][j]);
        acc[i][j] = fmaf(q[i].z, dv.z, acc[i][j]);
        acc[i][j] = fmaf(q[i].w, dv.w, acc[i][j]);
      }
    }
  }
}

// The chunk's top k per query, from the scores in acc, into its candidate
// lists; then acc is zeroed. Scores go through shared memory half a tile at
// a time; warp w selects queries 16h + 2w + {0, 1} of half h, so it keeps
// the same four queries across chunks and carries a threshold for each: a
// key below it cannot reach the final top k, because k keys above it are
// already in this CTA's lists, so it is listed as a pad. The final result
// does not change; a chunk's select shrinks to the keys that still matter.
// k <= 32: run[s] holds, lane j, the j-th best key this CTA listed for query
// slot s, and the threshold is lane k - 1's. Larger k: run[s] (the same in
// every lane) is the largest k-th key of one earlier list, and a chunk with
// at most 32 keys above it is selected by arg-max instead of a full sort.
template <bool WITH_IDS, bool BIG_K>
__device__ __forceinline__ void chunk_select(float (&acc)[8][8], float* Ss, uint64_t* Kbuf,
                                             uint64_t (&run)[4], const int* __restrict__ row_ids,
                                             int64_t n, int64_t n_valid, int B, int q0, int k,
                                             int chunk, int nchunks,
                                             uint64_t* __restrict__ cand, int tid) {
  const int warp = tid / 32, lane = tid % 32, qg = lane / 8, rg = lane % 8;
  const int64_t row0 = static_cast<int64_t>(chunk) * CR;
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
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (h) __syncthreads();            // half 0's scores are read
#pragma unroll
    for (int i = 4 * h; i < 4 * h + 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        Ss[(4 * i + qg - HQ * h) * SLD + warp * 64 + 8 * j + rg] = acc[i][j];
    __syncthreads();
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int q = HQ * h + 2 * warp + u;
      if (q0 + q >= B) break;
      uint64_t& rs = run[2 * h + u];
      uint64_t* dst = cand + (static_cast<int64_t>(q0 + q) * nchunks + chunk) * k;
      const float* srow = Ss + (2 * warp + u) * SLD;
      const uint64_t th = BIG_K ? rs : __shfl_sync(FULL, rs, k - 1);
      // a score below the threshold's cannot make a key at or above it
      const float ths = th > PAD_KEY ? key_score(th) : __int_as_float(0xff800000);
      uint64_t keys[CR / 32];
      unsigned live = 0;
#pragma unroll
      for (int t = 0; t < CR / 32; ++t) {
        const float sc = srow[lane + 32 * t];
        uint64_t key = PAD_KEY;
        if (ok[t] && !(sc < ths)) {
          key = encode_key(sc, ids[t]);
          if (key < th) key = PAD_KEY;
        }
        keys[t] = key;
        if (BIG_K) live += __popc(__ballot_sync(FULL, key > PAD_KEY));
      }
      auto emit = [&](int j, uint64_t key) { dst[j] = key; };
      if constexpr (!BIG_K) {
        // each listed key enters the running list at its rank
        warp_extract<CR / 32>(keys, k, emit, [&](uint64_t best) {
          const int pos = __popc(__ballot_sync(FULL, rs > best));
          const uint64_t prev = __shfl_up_sync(FULL, rs, 1);
          rs = lane < pos ? rs : (lane == pos ? best : prev);
        });
      } else if (live <= SMALL_K) {
        // fewer than k live keys: the threshold stays
        warp_extract<CR / 32>(keys, k, emit, NoEach{});
      } else {
        uint64_t* buf = Kbuf + warp * CR;
#pragma unroll
        for (int t = 0; t < CR / 32; ++t) buf[lane + 32 * t] = keys[t];
        __syncwarp();
        warp_bitonic_desc(buf, CR);
        for (int j = lane; j < k; j += 32) dst[j] = j < CR ? buf[j] : PAD_KEY;
        const uint64_t kth = k <= CR ? buf[k - 1] : 0;
        if (kth > PAD_KEY && kth > rs) rs = kth;
        __syncwarp();
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// Persistent: CTA (x, y) walks chunks x, x + gridDim.x, ... of the
// 32-query tile y.
//
// What bounds it on an H100: an f32 index is about even between bytes (n m
// 4 over 3.35 TB/s) and fp32 FMAs (2 B n m over 67 TFLOP/s); int8 moves a
// quarter of the bytes and is bound by the FMAs. Reaching either needs the
// query tile kept on chip, loads in flight during the FMAs, and few
// shared-memory wavefronts per FMA.
//
// This design loads the 32 x m query tile into shared memory once per CTA
// (in panels of 384 values when m is larger, reloaded per chunk) and
// streams D through a ring: 4 f32 stages (3 with big k), or raw int8 /
// bf16 stages upcast once per element into one of two f32 slabs (int8 by a
// byte permute and an exact add, not the conversion pipe), with one
// barrier per slab and later slabs in flight, also across a chunk's
// select. The select keeps a running top k per query (k <= 32), so after
// the first chunks it lists few keys. Rows land as they lie in memory. A
// warp owns 32 queries x 64 rows, a thread 8 queries x 8 rows with lanes
// 4 x 8, reading both operands along m in 16-byte pieces: a quarter-warp
// reads one query piece (2 wavefronts per warp-wide load) or 8 row pieces
// on distinct banks (4), so 48 wavefronts per 256 FMAs. One CTA fills an
// SM. What is left between this and the bound is shared memory: those
// wavefronts, and for int8 the upcast's f32 stores, keep it busy for most
// of the FMA time, and one CTA per SM hides little of it.
//
// Invariant: every score is one fp32 fmaf chain over m in ascending order
// from 0.f (slabs past m add exact zeros), with the query scale-folded by
// the caller. topk_page_kernel computes the same chain, and its bitwise
// equality with this kernel on the same contents rests on it.
template <typename T, bool WITH_IDS, bool VEC, bool BIG_K>
__global__ void __launch_bounds__(CT, 1)
topk_chunk_kernel(const T* __restrict__ D, const float* __restrict__ Q,
                  const int* __restrict__ row_ids, int64_t n, int m, int B,
                  int64_t n_valid, int k, int nchunks,
                  uint64_t* __restrict__ cand) {
  using C = Chunk<T, BIG_K>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kp = panel_width(m), qld = kp + 4;
  float* Qs = reinterpret_cast<float*>(smem);                       // [CQ][qld]
  float* Ss = Qs + CQ * qld;                                        // [HQ][SLD]
  uint64_t* Kbuf = reinterpret_cast<uint64_t*>(Ss + HQ * SLD);      // big k: [8][CR]
  unsigned char* ring = reinterpret_cast<unsigned char*>(Kbuf) +
                        (BIG_K ? (CT / 32) * CR * sizeof(uint64_t) : 0);
  float* Fs = reinterpret_cast<float*>(ring + C::STAGES * C::STAGE_BYTES);  // raw: [2][CR][RS]
  const int q0 = blockIdx.y * CQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qg = lane / 8, rg = lane % 8;     // queries 4i + qg, rows 64 warp + 8j + rg
  const int nslab = (m + CK - 1) / CK;
  const int ppanel = kp / CK;                 // slabs per query panel
  const int mine = (nchunks - 1 - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x) + 1;
  const int total = mine * nslab;             // slabs this CTA walks
  auto stage = [&](int t) {
    return reinterpret_cast<T*>(ring + (t % C::STAGES) * C::STAGE_BYTES);
  };
  auto chunk_of = [&](int t) {
    return static_cast<int>(blockIdx.x) + (t / nslab) * static_cast<int>(gridDim.x);
  };
  auto load = [&](int t) {
    load_chunk_slab<T, VEC>(D, stage(t), n, m, static_cast<int64_t>(chunk_of(t)) * CR,
                            (t % nslab) * CK, tid);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  uint64_t run[4] = {0, 0, 0, 0};     // chunk_select's thresholds

  // f32 multiplies straight out of the ring, slab t + STAGES - 1 in
  // flight; int8 / bf16 upcast slab t + 1 while slab t is multiplied, raw
  // slabs t + 2 .. t + STAGES in flight
  constexpr int AHEAD = C::RAW ? C::STAGES : C::STAGES - 1;
#pragma unroll
  for (int t = 0; t < AHEAD; ++t) {
    if (t < total) load(t);
    cp_async_commit();
  }
  if constexpr (C::RAW) {
    cp_async_wait<C::STAGES - 1>();
    __syncthreads();
    upcast_slab(stage(0), Fs, tid);
  }
  for (int t = 0; t < total; ++t) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();                   // slab t is in (raw: slab t + 1, and f32 slab t);
                                       // slab t - 1 (raw: raw slab t) is consumed
    const int slab = t % nslab;
    if (slab % ppanel == 0 && (t == 0 || nslab > ppanel)) {
      load_query_panel(Q, Qs, B, m, q0, slab * CK, kp, tid);
      __syncthreads();
    }
    if (t + AHEAD < total) load(t + AHEAD);
    cp_async_commit();
    const float* Ds;
    if constexpr (C::RAW) {
      if (t + 1 < total) upcast_slab(stage(t + 1), Fs + ((t + 1) % 2) * CR * RS, tid);
      Ds = Fs + (t % 2) * CR * RS;
    } else {
      Ds = reinterpret_cast<const float*>(stage(t));
    }
    slab_fma(Qs + (slab % ppanel) * CK, qld, Ds, acc, warp, qg, rg);
    if (slab == nslab - 1)
      chunk_select<WITH_IDS, BIG_K>(acc, Ss, Kbuf, run, row_ids, n, n_valid, B, q0, k,
                                    chunk_of(t), nchunks, cand, tid);
  }
  cp_async_wait<0>();
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
    warp_extract<MERGE_SMALL / 32>(keys, k, emit, NoEach{});
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
      warp_extract<PR / 32>(keys, k, [&](int j, uint64_t key) { dst[j] = key; }, NoEach{});
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
  const size_t smem = chunk_smem<T, BIG_K>(m);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // one CTA per SM, the SMs shared among the query tiles
  const int tiles = (B + CQ - 1) / CQ;
  const int per_tile = (sms + tiles - 1) / tiles;
  const dim3 grid(nchunks < per_tile ? nchunks : per_tile, tiles);
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
