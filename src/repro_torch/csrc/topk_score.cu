// Exact top-k of Q D^T per query: the per-request kernels of the search path.
//
// Replaces: src/repro/kernels/topk_score.py::topk_score_pallas, plain mode
// (ids are row positions, rows with id >= n_valid are masked) and row_ids
// mode (each row reports row_ids[row], negative ids are masked); and
// topk_score_paged_pallas, the same top-k over the logical slots [lo, hi)
// of a page table (a stable pool and an append tail of R-row pages, a
// per-page scale row folded into the query, ids from page_offset or
// ids_pool, a carry from an earlier call, finalized or not).
//
// Bound on an H100: at the serving shapes (B = 32 queries, m = 384) an f32
// index is about even between bytes (n m 4 over 3.35 TB/s) and fp32 FMA
// (2 B n m over 67 TFLOP/s); an int8 index moves a quarter of the bytes and
// is bound by the FMAs. The index is read once per 32-query tile in its
// storage dtype and upcast in registers.
//
// The TPU kernels walk the whole index in one sequential grid per batch
// tile, carrying a running top-k. At B <= 128 that would be one CTA on a
// 132-SM card, so here n is split instead. One mainloop serves both: the
// chunk kernel takes a row source, which names row r of 512-row chunk c
// (DenseSrc: D + (512 c + r) m; PagedSrc: a unit table built per call from
// the page table, 64 rows a unit, so every warp's rows lie in one page).
//   1. topk_chunk_kernel: persistent CTAs, at most one an SM, take
//      (segment, query tile) items; an item walks every S-th chunk for a
//      tile of 32 queries (dense rows at B <= 8: a narrow tile of 1 or 8,
//      fed as a bandwidth-bound walk, narrow_walk). It keeps the query
//      tile in shared memory, streams
//      the chunks through a cp.async ring and scores each with a
//      register-blocked fp32 product. Then, for k <= SMALL_K, each warp
//      selects per query the chunk's top k into that chunk's candidate
//      list, against a running threshold; for larger k (list mode) it
//      lists the chunk's keys at or above a running per-query threshold,
//      compacted, into the CTA's own segment of the query's row of keys,
//      and at the end writes how many it listed there. A call whose
//      512-row chunks are fewer than the CTAs a query tile may have takes
//      topk_unit_kernel instead: chunks of one 64-row unit, a CTA of four
//      warps of 8 queries each, the same lists and segments. The wrapper
//      plans which (kernels/topk_score.py::chunk_plan) and passes the plan.
//   2. k <= SMALL_K: topk_merge_kernel, one warp per (group of lists,
//      query) keeps the top k of the group; launched again until one list
//      remains, and the last launch writes scores and ids.
//   3. k > SMALL_K: a select over each query's listed keys, walking only
//      the counted keys of each segment. select_fused_kernel, one CTA per
//      query, does the whole select (radix digits on a shared-memory
//      histogram, gather, bitonic sort, write) where a query's keys fit its
//      budget, in two levels (a CTA a group of a query's segments, then a
//      CTA a query) where few queries would leave most SMs idle; else the
//      multi-CTA radix select (radix_hist / radix_pick,
//      11-bit digits, most significant first), a gather of the keys at or
//      above the threshold, a bitonic sort of those and a write. Scratch
//      keeps room for every row's key, so any k runs whatever is listed.
// Every candidate is a 64-bit key that orders (score desc, id asc), so the
// result does not depend on the order chunks are visited, merged or
// selected, nor on which keys below the final k-th a threshold skipped: the
// lowest-id tie-break, the masks and the (-inf, -1) pads all follow from
// that one order. The TPU kernel's block-skip guard and lane-fold select
// are not carried; the thresholds play the part of its running k-th best.
#include <type_traits>

#include "common.cuh"
#include "pipeline.cuh"

namespace {

constexpr int CQ = 32;          // queries per tile
constexpr int CR = 512;         // index rows per chunk
constexpr int CK = 16;          // slab depth over m
constexpr int CT = 256;         // threads of the chunk kernel: 8 warps
constexpr int UNIT = 64;        // rows of a warp's block, and of a paged unit
constexpr int UPC = CR / UNIT;  // units per chunk
constexpr int SMALL_K = 32;     // k at or below: register select and merge
constexpr int MERGE_SMALL = 1024;   // candidates per warp in a register merge
constexpr int MT = 128;             // threads of the merge kernel: 4 warps
constexpr unsigned FULL = 0xffffffffu;

// (-inf, id -1): beats every real row at -inf, loses to every finite score.
constexpr uint64_t PAD_KEY = (static_cast<uint64_t>(0x007FFFFFu) << 32) | 0x80000000u;

// A key's high word: the score's bits made monotone as unsigned.
__device__ __forceinline__ unsigned key_hi(float s) {
  if (s == 0.0f) s = 0.0f;      // -0 and +0 tie, as they do in the reference
  const unsigned bits = __float_as_uint(s);
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

// A key from its high word and its id: the lower id ranks higher.
__device__ __forceinline__ uint64_t make_key(unsigned hi, int id) {
  const unsigned lo = static_cast<unsigned>(0x7FFFFFFFLL - static_cast<long long>(id));
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

__device__ __forceinline__ uint64_t encode_key(float s, int id) { return make_key(key_hi(s), id); }

// The score of a key's high word (key_hi's inverse).
__device__ __forceinline__ float hi_score(unsigned hi) {
  return __uint_as_float((hi & 0x80000000u) ? (hi & 0x7FFFFFFFu) : ~hi);
}

__device__ __forceinline__ float key_score(uint64_t key) {
  return hi_score(static_cast<unsigned>(key >> 32));
}

__device__ __forceinline__ int key_id(uint64_t key) {
  return static_cast<int>(0x7FFFFFFFLL - static_cast<long long>(key & 0xFFFFFFFFull));
}

// A slot whose score is -inf (a pad, a masked or -inf row) or that holds no
// key (0, below every key): written as (-inf, -1).
__device__ __forceinline__ bool key_is_pad(uint64_t key) {
  return static_cast<unsigned>(key >> 32) <= 0x007FFFFFu;
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
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

// 4 int8 (one word, in memory order) as f32, exactly, without the
// conversion pipe (16 a clock per SM, an eighth of the FMA rate): byte b ^
// 0x80 = b + 128 is placed in the mantissa of 2^23, and 2^23 + 128 is
// subtracted.
__device__ __forceinline__ void upcast4(unsigned w, float* v) {
  w ^= 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v[i] = __uint_as_float(__byte_perm(w, 0x4Bu, 0x4550u | i)) - 8388736.0f;
}

// 8 bf16 (16 bytes, in memory order) as f32; x by value, so a caller's
// 16-byte shared-memory read stays one load.
__device__ __forceinline__ void upcast8(const uint4 x, float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

// ---------------------------------------------------------------------------
// Row sources: row r of chunk c, its id, and the scale row of a warp's rows
// ---------------------------------------------------------------------------

// A dense index: chunk c of ROWS-row chunks is rows [ROWS c, ROWS c + ROWS)
// of D (n, m). Row ids are positions masked at n_valid, or row_ids[row]
// masked when negative.
// n_valid_dev, when set, holds the live count on the device: bound() reads
// it once per block and clamps it to [0, n], so a live delta's search keeps
// one launch whatever its count (a CUDA graph replays it as the count grows).
template <typename T>
struct DenseSrc {
  static constexpr bool SCALED = false;
  const T* D;
  const int* row_ids;
  int64_t n, n_valid;
  int m;
  const int* n_valid_dev;
  __device__ __forceinline__ DenseSrc bound() const {
    DenseSrc s = *this;
    if (n_valid_dev != nullptr) {
      const int64_t v = *n_valid_dev;
      s.n_valid = v < 0 ? 0 : (v > n ? n : v);
    }
    return s;
  }
  template <int ROWS>
  __device__ __forceinline__ const T* row(int chunk, int r, bool& ok) const {
    const int64_t row = static_cast<int64_t>(chunk) * ROWS + r;
    ok = row < n;
    return D + (ok ? row : 0) * m;
  }
  template <int ROWS>
  __device__ __forceinline__ void id(int chunk, int r, int& id, bool& ok) const {
    const int64_t row = static_cast<int64_t>(chunk) * ROWS + r;
    id = -1;
    ok = false;
    if (row < n) {
      if (row_ids != nullptr) {
        id = row_ids[row];
        ok = id >= 0;
      } else {
        id = static_cast<int>(row);
        ok = row < n_valid;
      }
    }
  }
  __device__ __forceinline__ int live_chunks(int nchunks) const { return nchunks; }
  __device__ __forceinline__ const float* scale_row(int, int) const { return nullptr; }
  __device__ __forceinline__ int2 fold_state(int) const { return make_int2(-1, 1); }
  __device__ __forceinline__ const float* slot_scale(int) const { return nullptr; }
};

// One 64-row unit of a paged walk: its first row's address (a valid
// address even when masked), the rows that may be live (0 when the unit is
// masked: past hi, past the page, or a table entry in neither tier), the
// id of its first row (page_offset[slot] + row0), its slot (in range even
// when masked, for the scale row) and its first row within the page.
struct Unit {
  long long base;
  int rows, id0, slot, row0;
};

// A paged walk: unit u of chunk c of ROWS-row chunks is units[(ROWS / 64)
// c + u], built per call by paged_units_kernel. Row rr of a unit reports id0 + rr, or with ids_pool
// ids_pool[slot, row0 + rr] masked when negative. SCALED: fold[c] (from
// paged_fold_kernel) names the slot whose scale row every live unit of
// chunk c shares, or -1 when they differ, and whether the CTA's query tile
// already holds that fold; a chunk of mixed rows multiplies each query
// value by its warp's scale row as it is read (the warp's rows share a
// page). live, when set (a walk whose [lo, hi) is read on the device),
// holds the chunks that cover the range, which paged_units_kernel wrote:
// the chunk kernel walks those and lists the rest as pads.
template <typename T, bool SCALED_>
struct PagedSrc {
  static constexpr bool SCALED = SCALED_;
  const Unit* units;
  const int* ids_pool;
  const float* scale;
  const int2* fold;
  int R, m;
  const int* live;
  __device__ __forceinline__ PagedSrc bound() const { return *this; }
  __device__ __forceinline__ int live_chunks(int nchunks) const {
    return live != nullptr ? *live : nchunks;
  }
  template <int ROWS>
  __device__ __forceinline__ const T* row(int chunk, int r, bool& ok) const {
    const Unit* u = units + chunk * (ROWS / UNIT) + r / UNIT;
    const int rr = r % UNIT;
    ok = rr < __ldg(&u->rows);
    return reinterpret_cast<const T*>(__ldg(&u->base)) + (ok ? rr : 0) * m;
  }
  template <int ROWS>
  __device__ __forceinline__ void id(int chunk, int r, int& id, bool& ok) const {
    const Unit* u = units + chunk * (ROWS / UNIT) + r / UNIT;
    const int rr = r % UNIT;
    ok = rr < __ldg(&u->rows);
    if (ids_pool != nullptr) {
      id = ok ? ids_pool[static_cast<int64_t>(__ldg(&u->slot)) * R + __ldg(&u->row0) + rr] : -1;
      ok = ok && id >= 0;
    } else {
      id = __ldg(&u->id0) + rr;
    }
  }
  __device__ __forceinline__ const float* scale_row(int chunk, int warp) const {
    return SCALED ? slot_scale(__ldg(&units[chunk * UPC + warp].slot)) : nullptr;
  }
  __device__ __forceinline__ int2 fold_state(int chunk) const { return __ldg(&fold[chunk]); }
  __device__ __forceinline__ const float* slot_scale(int slot) const {
    return scale + static_cast<int64_t>(slot) * m;
  }
};

// ---------------------------------------------------------------------------
// The mainloop's pieces
// ---------------------------------------------------------------------------

// Geometry shared by the chunk kernel's tiles and the unit kernel: RS, the
// row stride of a row-major f32 slab (slab_at, the unit kernel's), and
// SLD, the narrow tile's score row stride (a warp's 32 stores hit 32 banks).
constexpr int RS = CK;
constexpr int KP_MAX = 384;     // m-values of the query tile resident at once
constexpr int HQ = CQ / 2;      // queries whose scores are staged at once
constexpr int SLD = CR + 8;

// Query-tile width for m: whole, rounded up to a slab, or panels of KP_MAX.
__host__ __device__ __forceinline__ int panel_width(int m) {
  const int mp = (m + CK - 1) / CK * CK;
  return mp < KP_MAX ? mp : KP_MAX;
}

// List mode's lane lists: LANE_J high words' top halves per lane and query
// slot (4 a warp), in shared memory (registers would spill in the paged
// f32 kernels).
constexpr int LANE_J = 5;              // lane lists: k <= 32 LANE_J
constexpr int LANE_BYTES = (CT / 32) * 4 * LANE_J * 32 * 2;

// The wide tile's slabs. Slab t's raw pieces (CK values of each of the
// chunk's CR rows, in the storage dtype) land by cp.async in a 96 KB ring
// (f32 3 stages, bf16 6, int8 12) and are rewritten once, upcast, into an
// f32 slab stored k-major (value k of row r at k CR + r), which the product
// reads. A chunk's scores (CQ rows of CR) are staged in the f32 slab's room
// once its last slab is multiplied and in as much again beside it.
constexpr int RING = 98304;
constexpr int FS = CK * CR;     // floats of a k-major slab

template <typename T>
struct Chunk {
  static constexpr int P = CK * static_cast<int>(sizeof(T)) / 16;   // 16-byte pieces a row
  static constexpr int STAGE_BYTES = CR * CK * static_cast<int>(sizeof(T));
  static constexpr int STAGES = RING / STAGE_BYTES;
  // f32 asks for two raw slabs at once, a row's whole 128-byte line (its
  // bytes pace it at few query tiles); int8 and bf16, paced by the FMAs,
  // ask for one a slab
  static constexpr bool PAIRED = sizeof(T) == 4;
};

// Dynamic shared memory of the wide tile: the k-major query panel, the f32
// slab with the rest of a chunk's staged scores after it, and the ring,
// side by side, so the ring keeps streaming while a chunk's keys are
// selected or listed; then list mode's lane lists.
static_assert(CQ * CR == 2 * FS, "a chunk's staged scores fill the f32 slab twice");
template <typename T, bool LIST>
size_t chunk_smem(int m) {
  return static_cast<size_t>(panel_width(m)) * CQ * 4 + CQ * CR * 4 + RING +
         (LIST ? LANE_BYTES : 0);
}
// Float offset of 16-byte piece c of row r in an f32 slab.
__device__ __forceinline__ int slab_at(int r, int c) { return r * RS + ((c ^ ((r >> 1) & 3)) << 2); }

// Fill ring stage `dst` with slab k0 of chunk `chunk` (ROWS rows, loaded by
// THREADS threads), in the storage dtype, as the stage stores it (f32:
// pieces placed by slab_at; raw: CK packed values a row). VEC: 16-byte
// cp.async pieces (m % 16 == 0, rows 16-byte aligned); else scalar loads.
// Out-of-range values are zero.
template <typename T, bool VEC, int ROWS, int THREADS, typename Src>
__device__ __forceinline__ void load_chunk_slab(const Src& src, T* dst, int chunk, int m,
                                                int k0, int tid) {
  constexpr bool F32 = std::is_same<T, float>::value;
  if (VEC) {
    constexpr int PER_ROW = CK * sizeof(T) / 16;
    auto piece = [&](int e) {
      const int r = e / PER_ROW, c = e % PER_ROW;
      bool ok;
      const T* p = src.template row<ROWS>(chunk, r, ok);
      cp_async16(dst + (F32 ? slab_at(r, c) : r * CK + c * (16 / sizeof(T))),
                 p + k0 + c * (16 / sizeof(T)), ok);
    };
    if constexpr (ROWS * PER_ROW % THREADS == 0) {
#pragma unroll
      for (int i = 0; i < ROWS * PER_ROW / THREADS; ++i) piece(tid + i * THREADS);
    } else {
      for (int e = tid; e < ROWS * PER_ROW; e += THREADS) piece(e);
    }
  } else {
    for (int e = tid; e < ROWS * CK; e += THREADS) {
      const int r = e / CK, kk = e % CK;
      bool ok;
      const T* p = src.template row<ROWS>(chunk, r, ok);
      dst[F32 ? slab_at(r, kk >> 2) + (kk & 3) : r * CK + kk] =
          (ok && k0 + kk < m) ? p[k0 + kk] : T(0.f);
    }
  }
}

// Query tile panel [kb, kb + kp) of queries [q0, q0 + QN), each value
// multiplied by srow[k] when a scale row is given (one rounding, as the
// dense index folds its scale); zero past B and past m. Loaded by THREADS
// threads, eight loads per thread in flight.
template <int THREADS, int QN = CQ>
__device__ __forceinline__ void load_query_panel(const float* __restrict__ Q, float* Qs,
                                                 int B, int m, int q0, int kb, int kp,
                                                 int tid, const float* srow) {
  const int qld = kp + 4, total = QN * kp;
  for (int e0 = tid; e0 < total; e0 += 8 * THREADS) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * THREADS, q = e / kp, kk = e % kp;
      v[u] = 0.f;
      if (e < total && q0 + q < B && kb + kk < m) {
        v[u] = Q[static_cast<int64_t>(q0 + q) * m + kb + kk];
        if (srow != nullptr) v[u] = __fmul_rn(v[u], __ldg(srow + kb + kk));
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * THREADS;
      if (e < total) Qs[(e / kp) * qld + e % kp] = v[u];
    }
  }
}

// Four scale values of m-positions [k, k + 4) of a scale row; zero past m.
template <bool VEC>
__device__ __forceinline__ float4 load_scale4(const float* s, int k, int m) {
  if (VEC) return __ldg(reinterpret_cast<const float4*>(s + k));
  return make_float4(k < m ? __ldg(s + k) : 0.f, k + 1 < m ? __ldg(s + k + 1) : 0.f,
                     k + 2 < m ? __ldg(s + k + 2) : 0.f, k + 3 < m ? __ldg(s + k + 3) : 0.f);
}

// 16-byte unit of piece c of row r in a wide-tile raw stage. A 128-byte
// line holds 8 / P rows; its eight pieces are permuted by (r >> 2) & 7, so
// the rows 4 (l % 16) + i that lanes l = 0..31 of to_kmajor read at once
// spread over all eight 16-byte bank groups of a line.
template <typename T>
__device__ __forceinline__ int raw_at(int r, int c) {
  constexpr int P = Chunk<T>::P, RL = 8 / P;
  return (r / RL) * 8 + (((r % RL) * P + c) ^ ((r >> 2) & 7));
}

// A lane's 16-byte pieces of its warp's 64 rows of a chunk's slabs (VEC):
// pieces e = lane + 32 i, row 64 w + e / P, piece e % P, each row's
// address found once a chunk (find), then each slab's pieces copied into a
// raw stage (load).
template <typename T>
struct SlabRows {
  static constexpr int P = Chunk<T>::P, PPL = UNIT * P / 32;
  const T* p[PPL];
  unsigned ok;
  template <typename Src>
  __device__ __forceinline__ void find(const Src& src, int chunk, int w, int lane) {
    ok = 0;
#pragma unroll
    for (int i = 0; i < PPL; ++i) {
      bool o;
      p[i] = src.template row<CR>(chunk, UNIT * w + (lane + 32 * i) / P, o);
      ok |= static_cast<unsigned>(o) << i;
    }
  }
  __device__ __forceinline__ void load(unsigned char* dst, int k0, int w, int lane) const {
    constexpr int VPP = 16 / static_cast<int>(sizeof(T));
    const int c = lane % P;
#pragma unroll
    for (int i = 0; i < PPL; ++i)
      cp_async16(dst + raw_at<T>(UNIT * w + (lane + 32 * i) / P, c) * 16, p[i] + k0 + c * VPP,
                 (ok >> i) & 1u);
  }
};

// The warp's rows of slab k0 of chunk `chunk` into a raw stage by scalar
// loads (m % 16 != 0 or rows not 16-byte aligned), as raw_at places them;
// zero past m and n.
template <typename T, typename Src>
__device__ __forceinline__ void load_wide_scalar(const Src& src, unsigned char* dst, int chunk,
                                                 int m, int k0, int w, int lane) {
  constexpr int VPP = 16 / static_cast<int>(sizeof(T));
  T* d = reinterpret_cast<T*>(dst);
  for (int e = lane; e < UNIT * CK; e += 32) {
    const int r = UNIT * w + e / CK, kk = e % CK;
    bool ok;
    const T* p = src.template row<CR>(chunk, r, ok);
    d[raw_at<T>(r, kk / VPP) * VPP + kk % VPP] = (ok && k0 + kk < m) ? p[k0 + kk] : T(0.f);
  }
}

// Values [8 h, 8 h + 8) of row r of a raw stage as f32, exactly.
__device__ __forceinline__ void raw_half(const float* raw, int r, int h, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(raw + raw_at<float>(r, 2 * h) * 4);
  const float4 b = *reinterpret_cast<const float4*>(raw + raw_at<float>(r, 2 * h + 1) * 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void raw_half(const __nv_bfloat16* raw, int r, int h, float (&v)[8]) {
  upcast8(*reinterpret_cast<const uint4*>(raw + raw_at<__nv_bfloat16>(r, h) * 8), v);
}
__device__ __forceinline__ void raw_half(const int8_t* raw, int r, int h, float (&v)[8]) {
  const uint2 x = *reinterpret_cast<const uint2*>(raw + raw_at<int8_t>(r, 0) * 16 + 8 * h);
  upcast4(x.x, v);
  upcast4(x.y, v + 4);
}

// Rewrite warp w's rows of a raw stage into a k-major f32 slab: lane l
// takes rows 64 w + 4 (l % 16) + 0..3 and values [8 h, 8 h + 8), h = l /
// 16, and stores each value of its four rows as one 16-byte piece (a
// warp's stores fill two 256-byte runs).
template <typename T>
__device__ __forceinline__ void to_kmajor(const unsigned char* raw, float* dst, int w, int lane) {
  const int r0 = UNIT * w + 4 * (lane % 16), h = lane / 16;
  float v[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) raw_half(reinterpret_cast<const T*>(raw), r0 + i, h, v[i]);
#pragma unroll
  for (int k = 0; k < 8; ++k)
    *reinterpret_cast<float4*>(dst + (8 * h + k) * CR + r0) =
        make_float4(v[0][k], v[1][k], v[2][k], v[3][k]);
}

// The wide tile's query panel [kb, kb + kp) of queries [q0, q0 + CQ),
// stored k-major (value kk of query q at kk CQ + q), each value multiplied
// by srow[kb + kk] when a scale row is given (one rounding, as the dense
// index folds its scale); zero past B and past m. A thread takes four
// consecutive values of one query at a time (one 16-byte load where Q's
// rows allow), a warp 32 queries, so its stores fill panel rows; four such
// reads in flight per thread.
__device__ __forceinline__ void load_query_panel_k(const float* __restrict__ Q, float* Qs, int B,
                                                   int m, int q0, int kb, int kp, int tid,
                                                   const float* srow) {
  const int total = CQ * kp / 4;
  const bool vec = m % 4 == 0 && reinterpret_cast<uintptr_t>(Q) % 16 == 0;
  for (int e0 = tid; e0 < total; e0 += 4 * CT) {
    float v[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * CT, q = e % CQ, kk = kb + 4 * (e / CQ);
      const bool live = e < total && q0 + q < B;
      const float* row = Q + static_cast<int64_t>(live ? q0 + q : 0) * m;
      if (live && vec && kk < m) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(row + kk));
        v[u][0] = x.x; v[u][1] = x.y; v[u][2] = x.z; v[u][3] = x.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) v[u][c] = live && kk + c < m ? row[kk + c] : 0.f;
      }
      if (srow != nullptr) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (live && kk + c < m) v[u][c] = __fmul_rn(v[u][c], __ldg(srow + kk + c));
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * CT;
      if (e < total) {
#pragma unroll
        for (int c = 0; c < 4; ++c) Qs[(4 * (e / CQ) + c) * CQ + e % CQ] = v[u][c];
      }
    }
  }
}

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
}

// acc[i][j] += Q[16 (i / 4) + 4 qg + i % 4] . D[64 w + 32 (j / 4) + 4 rg + j
// % 4] over one CK-deep slab, k ascending, both operands k-major: per k,
// two 16-byte pieces of panel row k (4 distinct in a warp) and two of slab
// row k (8 distinct, 128 contiguous bytes) for 64 FMAs. SCALED and `fold`:
// each query value is first multiplied by srow[k] (one rounding, as the
// dense index folds its scale into the query), srow being the scale row of
// the warp's page and k0 the slab's first m-position.
template <bool SCALED, bool VEC>
__device__ __forceinline__ void slab_fma(const float* Qp, const float* Fp, float (&acc)[8][8],
                                         int w, int qg, int rg, bool fold, const float* srow,
                                         int k0, int m) {
  const float* qb = Qp + 4 * qg;
  const float* db = Fp + w * 64 + 4 * rg;
#pragma unroll
  for (int k4 = 0; k4 < CK; k4 += 4) {
    float4 s = make_float4(1.f, 1.f, 1.f, 1.f);
    if (SCALED && fold) s = load_scale4<VEC>(srow, k0 + k4, m);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = k4 + kk;
      const float4 q0 = *reinterpret_cast<const float4*>(qb + k * CQ);
      const float4 q1 = *reinterpret_cast<const float4*>(qb + k * CQ + 16);
      const float4 d0 = *reinterpret_cast<const float4*>(db + k * CR);
      const float4 d1 = *reinterpret_cast<const float4*>(db + k * CR + 32);
      float qv[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
      const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
      if (SCALED && fold) {
        const float sk = comp(s, kk);
#pragma unroll
        for (int i = 0; i < 8; ++i) qv[i] = __fmul_rn(qv[i], sk);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(qv[i], dv[j], acc[i][j]);
    }
  }
}

// Stage the tile's scores, from acc, into Ss (CQ rows of CR): each
// thread's four rows of a query as one 16-byte piece, a warp's into its own
// 64 columns.
__device__ __forceinline__ void stage_scores(const float (&acc)[8][8], float* Ss, int warp,
                                             int qg, int rg) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const float* v = &acc[i][4 * g];
      *reinterpret_cast<float4*>(Ss + (16 * (i / 4) + 4 * qg + i % 4) * CR + warp * 64 +
                                 32 * g + 4 * rg) = make_float4(v[0], v[1], v[2], v[3]);
    }
}

// One query's chunk top k (k <= SMALL_K) from its CR scores srow, the lane
// holding rows lane + 32 t (ids, ok), into the chunk's candidate list dst,
// against a running threshold: rs holds, lane j, the j-th best key this CTA
// listed for the query, and a key below lane k - 1's cannot reach the final
// top k (k keys above it are already listed), so it is listed as a pad. The
// final result does not change; a chunk's select shrinks to the keys that
// still matter.
__device__ __forceinline__ void slot_keys(const float* srow, const int (&ids)[CR / 32],
                                          const bool (&ok)[CR / 32], uint64_t& rs,
                                          uint64_t* dst, int k, int lane) {
  const uint64_t th = __shfl_sync(FULL, rs, k - 1);
  // a score below the threshold's cannot make a key at or above it
  const float ths = th > PAD_KEY ? key_score(th) : __int_as_float(0xff800000);
  uint64_t keys[CR / 32];
#pragma unroll
  for (int t = 0; t < CR / 32; ++t) {
    const float sc = srow[lane + 32 * t];
    uint64_t key = PAD_KEY;
    if (ok[t] && !(sc < ths)) {
      key = encode_key(sc, ids[t]);
      if (key < th) key = PAD_KEY;
    }
    keys[t] = key;
  }
  // each listed key enters the running list at its rank
  warp_extract<CR / 32>(keys, k, [&](int j, uint64_t key) { dst[j] = key; },
                        [&](uint64_t best) {
                          const int pos = __popc(__ballot_sync(FULL, rs > best));
                          const uint64_t prev = __shfl_up_sync(FULL, rs, 1);
                          rs = lane < pos ? rs : (lane == pos ? best : prev);
                        });
}

// The chunk's top k per query (k <= SMALL_K), from the scores in acc; then
// acc is zeroed. Scores go through shared memory (Ss: the f32 slab just
// multiplied, and the room after it); warp w takes queries 16h + 2w + {0,
// 1}, h = 0, 1, so it keeps the same four queries across chunks, each with
// its running threshold run[s] (slot_keys).
template <typename Src>
__device__ __forceinline__ void chunk_keys(float (&acc)[8][8], float* Ss, uint64_t (&run)[4],
                                           const Src& src, int B, int q0, int k, int chunk,
                                           int64_t ldq, uint64_t* __restrict__ cand, int tid) {
  const int warp = tid / 32, lane = tid % 32, qg = lane / 8, rg = lane % 8;
  // lane holds rows lane + 32 t of the chunk
  int ids[CR / 32];
  bool ok[CR / 32];
#pragma unroll
  for (int t = 0; t < CR / 32; ++t) src.template id<CR>(chunk, lane + 32 * t, ids[t], ok[t]);
  __syncwarp();                        // a warp's scores go to the columns only it read
  stage_scores(acc, Ss, warp, qg, rg);
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int q = HQ * h + 2 * warp + u;
      if (q0 + q >= B) break;
      slot_keys(Ss + q * CR, ids, ok, run[2 * h + u],
                cand + static_cast<int64_t>(q0 + q) * ldq + static_cast<int64_t>(chunk) * k, k,
                lane);
    }
  }
  __syncthreads();                     // Ss is read before its slab is rewritten
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// List mode (k > SMALL_K). tau starts at the least high word of a real key
// (-FLT_MAX's): keys at or below PAD_KEY (masked rows, -inf scores) are
// written as pads whatever their rank, so they need not be listed, and the
// select's empty slots are pads alike.
constexpr unsigned REAL_HI = 0x00800000u;

// Per query slot s of the warp (queries 16 (s / 2) + 2 w + s % 2), kept in
// registers across the CTA's chunks: tau[s], the high word at or above
// which a key is listed, and cnt[s], the keys listed in the CTA's segment.
// In shared memory, lanes[(s LANE_J + i) 32 + lane] of the warp's block:
// each lane's LANE_J largest top halves (high word >> 16) among rows it
// listed (rows lane + 32 t of each chunk), descending; a lane's j-th of
// them, shifted back, has j of its listed keys at or above it.
struct ListRun {
  unsigned tau[4];
  int cnt[4];
  unsigned short* lanes;
};

// The largest t with at least k of the warp's hi words >= t: the k-th
// largest of them, one bit at a time from the top.
__device__ __forceinline__ unsigned kth_hi(const unsigned (&hi)[CR / 32], int k) {
  unsigned t = 0;
#pragma unroll 1
  for (int b = 31; b >= 0; --b) {
    const unsigned c = t | (1u << b);
    int n = 0;
#pragma unroll
    for (int i = 0; i < CR / 32; ++i) n += hi[i] >= c;
    if (static_cast<int>(__reduce_add_sync(FULL, static_cast<unsigned>(n))) >= k) t = c;
  }
  return t;
}

// Insert x into the lane's descending list b (stride 32), dropping its least.
__device__ __forceinline__ void lane_insert(unsigned short* b, unsigned x) {
  unsigned v[LANE_J];
#pragma unroll
  for (int i = 0; i < LANE_J; ++i) v[i] = b[32 * i];
#pragma unroll
  for (int i = LANE_J - 1; i > 0; --i) v[i] = max(v[i], min(x, v[i - 1]));
  v[0] = max(v[0], x);
#pragma unroll
  for (int i = 0; i < LANE_J; ++i) b[32 * i] = static_cast<unsigned short>(v[i]);
}

// Without lane lists (k > 32 LANE_J), lists above this many keys a warp
// take the chunk's rows in (t, lane) order, one ballot a row group, so the
// warp's stores coalesce; else each lane walks its own listed rows (after
// the lists of k <= 32 LANE_J, about k a chunk and fewer later) and fills
// its lane list.
constexpr int DENSE_LIST = 4 * 32;

// One query's keys of the chunk at or above its threshold tau, from its CR
// scores srow (the lane's rows lane + 32 t; okm: those that may list),
// listed compacted at dst (its segment, after the cnt keys listed before),
// cnt and tau updated; b is the lane's list (stride 32). A score is tested
// against tau as a float (!(score < hi_score(tau)) is key_hi(score) >= tau;
// a NaN lists), and only the listed rows build keys. tau rises
//   - before listing, to the chunk's k-th largest high word (k <= CR),
//     searched only when more than k of its keys pass tau (the first
//     chunks);
//   - after listing, for the next chunks, to min over lanes of the j-th
//     best in the lane's list, shifted back (j = ceil(k / 32), k <= 32
//     LANE_J): every lane listed j real keys at or above it, so 32 j >= k
//     in all. A list may hold any subset of its lane's listed keys (a key
//     below tau cannot raise a lane's j-th above tau, so only listed keys
//     enter), and a top half keeps the bound a lower one.
// For k > CR neither applies and every real key is listed: no threshold
// as cheap as these was found for it.
// Invariant: this CTA scored at least k real keys (equal copies counted,
// pads and masked rows not) whose high word is at or above tau, and listed
// every one of them (tau only rises, and a key is listed against a tau no
// higher than any later one). A key below tau has k listed keys above it,
// so it cannot reach the final top k; keys equal to tau in the high word
// are listed. Listing more than that is harmless: the select keeps the
// top k of whatever is listed.
template <typename Src>
__device__ __forceinline__ void slot_list(const float* srow, const Src& src, int chunk,
                                          const int (&ids)[CR / 32], unsigned okm,
                                          unsigned& tau_io, int& cnt,
                                          unsigned short* b, uint64_t* dst, int k, int lane,
                                          unsigned below) {
  const int j = (k + 31) / 32;
  unsigned tau = tau_io;
  const float tf = hi_score(tau);
  unsigned tm = 0;                     // the lane's rows to list
#pragma unroll
  for (int t = 0; t < CR / 32; ++t)
    tm |= static_cast<unsigned>(((okm >> t) & 1u) && !(srow[lane + 32 * t] < tf)) << t;
  int total = __reduce_add_sync(FULL, __popc(tm));
  if (total == 0) return;
  if (k <= CR && total > k) {
    // k of the chunk's keys at or above tau: its k-th is, and the
    // rows below it need not list
    unsigned hi[CR / 32];
#pragma unroll
    for (int t = 0; t < CR / 32; ++t)
      hi[t] = (tm >> t) & 1u ? key_hi(srow[lane + 32 * t]) : 0u;
    tau = max(tau, kth_hi(hi, k));
#pragma unroll
    for (int t = 0; t < CR / 32; ++t)
      if (hi[t] < tau) tm &= ~(1u << t);
    total = __reduce_add_sync(FULL, __popc(tm));
  }
  const bool lanes = j <= LANE_J;
  if (!lanes && total > DENSE_LIST) {
    int c = 0;
#pragma unroll
    for (int t = 0; t < CR / 32; ++t) {
      const bool take = (tm >> t) & 1u;
      const unsigned mask = __ballot_sync(FULL, take);
      if (take)
        dst[c + __popc(mask & below)] = make_key(key_hi(srow[lane + 32 * t]), ids[t]);
      c += __popc(mask);
    }
  } else {
    // each lane its own rows, after the rows of the lanes below it
    const int nt = __popc(tm);
    int pos = nt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(FULL, pos, off);
      if (lane >= off) pos += v;
    }
    pos -= nt;
    for (unsigned m = tm; m; m &= m - 1) {
      const int r = lane + 32 * (__ffs(m) - 1);
      int id;
      bool o;
      src.template id<CR>(chunk, r, id, o);
      const unsigned x = key_hi(srow[r]);
      dst[pos++] = make_key(x, id);
      if (lanes && (x >> 16) > b[32 * (LANE_J - 1)]) lane_insert(b, x >> 16);
    }
  }
  cnt += total;
  if (lanes)                           // for the next chunks
    tau = max(tau, __reduce_min_sync(FULL, static_cast<unsigned>(b[32 * (j - 1)])) << 16);
  tau_io = tau;
}

// The ids of a chunk's rows a lane holds (lane + 32 t), and which may list.
template <typename Src>
__device__ __forceinline__ unsigned chunk_ids(const Src& src, int chunk, int lane,
                                              int (&ids)[CR / 32]) {
  unsigned okm = 0;
#pragma unroll
  for (int t = 0; t < CR / 32; ++t) {
    bool o;
    src.template id<CR>(chunk, lane + 32 * t, ids[t], o);
    okm |= static_cast<unsigned>(o) << t;
  }
  return okm;
}

// List mode (k > SMALL_K): the chunk's keys per query at or above the
// slot's threshold, listed in the CTA's segment of the query's row (seg0
// keys in, lr.cnt[s] filled) by slot_list; then acc is zeroed. Scores go
// through shared memory as in chunk_keys.
template <typename Src>
__device__ __forceinline__ void chunk_list(float (&acc)[8][8], float* Ss, ListRun& lr,
                                           const Src& src, int B, int q0, int k, int chunk,
                                           int64_t ldq, int64_t seg0,
                                           uint64_t* __restrict__ cand, int tid) {
  const int warp = tid / 32, lane = tid % 32, qg = lane / 8, rg = lane % 8;
  const unsigned below = lanemask_lt();
  int ids[CR / 32];                    // the lane's rows lane + 32 t
  const unsigned okm = chunk_ids(src, chunk, lane, ids);
  __syncwarp();                        // a warp's scores go to the columns only it read
  stage_scores(acc, Ss, warp, qg, rg);
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int s = 2 * h + u;
      const int q = HQ * h + 2 * warp + u;
      if (q0 + q >= B) break;
      slot_list(Ss + q * CR, src, chunk, ids, okm, lr.tau[s], lr.cnt[s],
                lr.lanes + s * LANE_J * 32 + lane,
                cand + static_cast<int64_t>(q0 + q) * ldq + seg0 + lr.cnt[s], k, lane, below);
    }
  }
  __syncthreads();                     // Ss is read before its slab is rewritten
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) acc[i][jj] = 0.f;
}

// Persistent: the call's S x tiles items (x, tile) are spread over the
// gridDim.x CTAs, CTA g taking items i = g, g + gridDim.x, ... with x = i /
// tiles and tile = i % tiles, so the items that run at once share x and
// read the same chunks (from L2 after the first). Item (x, tile) walks
// chunks x, x + S, ... of the 32-query tile, reading rows through the row
// source, up to the source's live chunks, with the ring and the query tile
// (with a paged source's fold) reloaded; its running lists or thresholds
// start afresh where the CTA's last item was of another tile (with
// gridDim.x a multiple of the tiles, a CTA keeps one tile). For k <= SMALL_K its chunks past the live ones (a paged
// range read on the device that ends before the capacity the call was
// planned for) get pads in place of their lists, so the merge reads what a
// walk planned for that range would have left. In list mode the item owns
// one segment of each query's row of keys, room for every row of the
// chunks it was planned for: segment x holds (x qn + min(x, rn)) CR keys
// before it, qn and rn the quotient and remainder of nchunks / S; it lists
// there and writes counts[query][x], so chunks past the live ones write
// nothing. The plan (kernels/topk_score.py::chunk_plan) picks S and the
// grid so that no CTA walks many more chunks than the even share of the
// SMs; one CTA an item (gridDim.x = S x tiles) is the walk of one CTA a
// segment and query tile.
//
// What bounds it on an H100: an f32 index is about even between bytes (n m
// 4 over 3.35 TB/s) and fp32 FMAs (2 B n m over 67 TFLOP/s); int8 moves a
// quarter of the bytes and is bound by the FMAs. Reaching either needs the
// query tile kept on chip, loads in flight during the FMAs, and few
// shared-memory wavefronts per FMA.
//
// This design loads the 32 x m query tile into shared memory once per item
// (in panels of 384 values when m is larger, reloaded per chunk) and
// streams D through a 128 KB ring of raw stages in the storage dtype (f32
// 4, bf16 8, int8 16), 16-byte cp.async pieces whose row addresses are
// found once a chunk. Each raw slab is rewritten once, upcast (int8 by a
// byte permute and an exact add, not the conversion pipe), into the f32
// slab, with later raw slabs in flight, also across a chunk's select. The
// select keeps a running top k per query (list mode: a running threshold),
// so after the first chunks it lists few keys.
// A warp owns 32 queries x 64 rows, a thread 8 queries x 8 rows with lanes
// 4 (queries) x 8 (rows), as outer products over m: the query panel and the
// f32 slab are stored k-major, so per m-value a warp reads two 16-byte
// pieces of 4 distinct query pieces (64 contiguous bytes) and two of 8
// distinct row pieces (128 contiguous bytes) for 64 FMAs, and a thread holds
// 16 operand values a step, not the 64 of 4-deep pieces read along m. The
// rewrite costs f32 a pass through shared memory (a raw slab read and a
// k-major slab written, 16-byte pieces both), which the product's reads
// repay (benchmarks/slab_product.py times each layout alone); int8 and bf16
// were upcast through shared memory anyway.
// Each warp also loads and rewrites its own 64 rows, so a slab needs no
// block barrier: the warps drift apart within a chunk, one's wait for its
// pieces or its rewrite filled by the others' FMAs, and meet at the chunk's
// select (four barriers) and where the query panel is reloaded (two). One
// CTA fills an SM.
//
// A paged source adds one read of its unit per row a chunk (L1-hot). With
// scale rows the resident tile holds the query folded with the scale row
// the chunk's pages share, reloaded from Q (in L2) only where that row
// changes along the item's walk; a chunk whose pages have differing rows
// folds at read time instead (8 multiplies per 64 FMAs and a 16-byte scale
// read per 4-deep step; the warp's 64 rows are one unit of one page).
//
// Invariant: every score is one fp32 fmaf chain over m in ascending order
// from 0.f (slabs past m add exact zeros), with the query scale-folded by
// the caller (dense) or at read time with the page's scale row (paged, one
// rounding per value, as the dense fold). The dense and the paged search
// are bitwise equal on the same contents because of it, and so is every
// layout of the operands.
template <typename T, bool VEC, bool LIST, typename Src>
__device__ __forceinline__ void chunk_walk(const Src& src_arg, const float* __restrict__ Q,
                                           int m, int B, int k, int nchunks, int S, int64_t ldq,
                                           uint64_t* __restrict__ cand,
                                           int* __restrict__ counts) {
  using C = Chunk<T>;
  const Src src = src_arg.bound();
  extern __shared__ __align__(16) unsigned char smem[];
  const int kp = panel_width(m);
  float* Qs = reinterpret_cast<float*>(smem);                       // [kp][CQ]
  float* Fs = Qs + kp * CQ;           // [CK][CR]; at a chunk's end [CQ][CR] staged scores
  unsigned char* ring = reinterpret_cast<unsigned char*>(Fs + CQ * CR);   // [STAGES][STAGE_BYTES]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qg = lane / 8, rg = lane % 8;     // slab_fma's queries and rows
  const int nslab = (m + CK - 1) / CK;
  const int ppanel = kp / CK;                 // slabs per query panel
  uint64_t run[4];                    // chunk_keys' thresholds
  ListRun lr;                         // chunk_list's
  if constexpr (LIST)
    lr.lanes = reinterpret_cast<unsigned short*>(ring + RING) + warp * 4 * LANE_J * 32;
  // an item's place is derived anew from `item` and the arguments, so only
  // `item` is carried across the mainloop
  for (int item = blockIdx.x; item < (B + CQ - 1) / CQ * S; item += gridDim.x) {
    const int tiles = (B + CQ - 1) / CQ;
    if (item != static_cast<int>(blockIdx.x)) __syncthreads();   // the last item's smem is read
    const int bx = item / tiles, q0 = (item % tiles) * CQ;
    const int live = src.live_chunks(nchunks);
    const int mine = bx < live ? (live - 1 - bx) / S + 1 : 0;    // chunks this item walks
    const int total = mine * nslab;             // slabs this item walks
    auto stage = [&](int t) { return ring + (t % C::STAGES) * C::STAGE_BYTES; };
    // the loader's place, kept by counters (no division a slab): raw slab
    // lt, slab lslab of chunk lchunk, whose rows `rows` holds
    int lt = 0, lslab = 0, lchunk = bx;
    SlabRows<T> rows;
    auto load_next = [&]() {
      if (lt < total) {
        if (VEC) {
          if (lslab == 0) rows.find(src, lchunk, warp, lane);
          rows.load(stage(lt), lslab * CK, warp, lane);
        } else {
          load_wide_scalar<T>(src, stage(lt), lchunk, m, lslab * CK, warp, lane);
        }
        if (++lslab == nslab) {
          lslab = 0;
          lchunk += S;
        }
      }
      ++lt;
      cp_async_commit();
    };

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    // an item of another tile starts its running lists afresh; one of the
    // same tile keeps them: the keys they stand for are listed in this
    // CTA's earlier lists or segments of the same queries, which the merge
    // and the select read, so chunk_keys' and chunk_list's invariants hold.
    // A CTA's items share its tile exactly when gridDim.x % tiles == 0.
    if (item == static_cast<int>(blockIdx.x) || gridDim.x % tiles != 0) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        run[s] = 0;
        lr.tau[s] = REAL_HI;
      }
      if constexpr (LIST) {             // each lane's own entries: no barrier
#pragma unroll
        for (int i = 0; i < 4 * LANE_J; ++i) lr.lanes[32 * i + lane] = 0;
      }
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) lr.cnt[s] = 0;
    const int rn = nchunks % S;
    const int64_t seg0 = (static_cast<int64_t>(bx) * (nchunks / S) + (bx < rn ? bx : rn)) * CR;
    const float* srow = nullptr;        // the warp's scale row (paged, SCALED)
    int2 fs = make_int2(-1, Src::SCALED ? 0 : 1);   // the chunk's fold row, and whether Qs
                                                    // holds it (dense: nothing to fold)

    // each warp streams its own 64 rows: raw slabs 0 .. STAGES - 1 in
    // flight, raw slab 0 rewritten into the f32 slab; then at slab t: slab t
    // is multiplied (and at a chunk's end its keys selected), and once raw
    // slab t + 1 is in it is rewritten into the f32 slab. Raw slab t +
    // STAGES loads into raw slab t's stage before slab t's product (int8,
    // bf16), or at even t with raw slab t + STAGES + 1 after the rewrite
    // (f32: a row's two 64-byte halves of a 128-byte line asked for
    // together). A warp reads and writes only its rows' pieces and columns,
    // so it syncs with itself, and with the CTA only where the query panel
    // changes and at a chunk's select.
#pragma unroll 1
    for (int t = 0; t < C::STAGES; ++t) load_next();
    cp_async_wait<C::STAGES - 1>();
    __syncwarp();
    if (total > 0) to_kmajor<T>(stage(0), Fs, warp, lane);
    int slab = 0, pan = 0, chunk = bx;  // slab t's place: in its chunk, in the panel
    for (int t = 0; t < total; ++t) {
      __syncwarp();                      // the warp's part of f32 slab t is written, and
                                         // of raw slab t read
      if (Src::SCALED && slab == 0) {
        fs = src.fold_state(chunk);
        srow = src.scale_row(chunk, warp);
      }
      // the tile is (re)loaded at the item's first slab, at each panel, and
      // where a chunk needs another fold than the item's last chunk
      if (pan == 0 && (t == 0 || nslab > ppanel || (slab == 0 && !fs.y))) {
        if (t > 0) __syncthreads();      // every warp is done with the last panel
        load_query_panel_k(Q, Qs, B, m, q0, slab * CK, kp, tid,
                           Src::SCALED && fs.x >= 0 ? src.slot_scale(fs.x) : nullptr);
        __syncthreads();
      }
      if constexpr (!C::PAIRED) load_next();
      slab_fma<Src::SCALED, VEC>(Qs + pan * CK * CQ, Fs, acc, warp, qg, rg, fs.x < 0, srow,
                                 slab * CK, m);
      if (slab == nslab - 1) {            // the scores staged from the f32 slab's room on
        if constexpr (LIST)
          chunk_list(acc, Fs, lr, src, B, q0, k, chunk, ldq, seg0, cand, tid);
        else
          chunk_keys(acc, Fs, run, src, B, q0, k, chunk, ldq, cand, tid);
      } else {
        __syncwarp();                    // the warp's part of f32 slab t is read
      }
      if (t + 1 < total) {
        if (!C::PAIRED || (t & 1))       // STAGES + t + 1 raw slabs asked for
          cp_async_wait<C::STAGES - 1>();
        else                             // STAGES + t
          cp_async_wait<C::STAGES - 2>();
        __syncwarp();                    // the warp's raw slab t + 1 is in
        to_kmajor<T>(stage(t + 1), Fs, warp, lane);
      }
      if (C::PAIRED && t % 2 == 0) {
        __syncwarp();                    // the warp's raw slab t + 1 is read
        load_next();
        load_next();
      }
      if (++slab == nslab) {
        slab = pan = 0;
        chunk += S;
      } else if (++pan == ppanel) {
        pan = 0;
      }
    }
    cp_async_wait<0>();
    if constexpr (LIST) {
      if (lane == 0)
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int q = HQ * (s / 2) + 2 * warp + s % 2;
          if (q0 + q < B) counts[static_cast<int64_t>(q0 + q) * S + bx] = lr.cnt[s];
        }
    } else {
      for (int c = bx + mine * S; c < nchunks; c += S)
        for (int e = tid; e < CQ * k; e += CT) {
          const int q = e / k;
          if (q0 + q < B)
            cand[static_cast<int64_t>(q0 + q) * ldq + static_cast<int64_t>(c) * k + e % k] =
                PAD_KEY;
        }
    }
  }
}

// ---------------------------------------------------------------------------
// Few queries: the chunk kernel's narrow query tile (QN = 1 or 8, dense rows)
// ---------------------------------------------------------------------------
//
// At B <= 8 the 32-query tile issues 32 queries' FMAs for each row value
// (at B 1, 31 of its 32 query rows are zeros): over retrieval_cand's
// 1,000,448 x 256 f32 rows that is 8.2 G FMA, 0.47 ms at the wide
// mainloop's 52 % of fp32 FMA peak on an H100, against 0.31 ms for the
// bytes. A tile of QN queries issues QN FMAs a value, so at QN 1 and 8 the
// bytes set the pace (int8 at QN 8 is about even: a quarter of the bytes,
// eight FMAs a value).
// The walk is the chunk kernel's: the same items, chunks, segments, lists
// and thresholds, with tiles of QN queries.
//
// The design feeds it as a bandwidth-bound kernel. A slab holds 128 bytes of
// each of the chunk's 512 rows (f32 32 values, bf16 64, int8 128): whole
// 128-byte lines, by 16-byte cp.async pieces a quarter-warp reads
// coalesced, into a ring of three 64 KB stages, two in flight (128 KB an
// SM) while one is multiplied, with one barrier a slab. Thread t owns rows
// t and t + 256 of the chunk and QN chains each; its rows' pieces are read
// in the storage dtype and upcast in registers (each value is used by one
// thread only), piece c of row r stored at slot c ^ (r & 7), so the eight
// rows a quarter-warp reads at once fall on distinct banks. The queries'
// values come from the resident tile as broadcasts. Then, per chunk, the
// scores go through shared memory once and warp w selects or lists for
// query w of the tile (slot_keys, slot_list: the same thresholds and
// invariants as the wide tile); at QN 1 warp 0 does, while the ring keeps
// streaming.
//
// Invariant: each score is the wide tile's fmaf chain, from 0.f over m in
// ascending order with the same query values (zero past m), so the narrow
// and the wide tile give the same bits.
constexpr int NROW = 128;                 // bytes of each row a narrow slab holds
constexpr int NSTAGES = 3;                // narrow ring stages
constexpr int NSTAGE_BYTES = CR * NROW;   // 64 KB
constexpr int NLANE_BYTES = (CT / 32) * LANE_J * 32 * 2;   // a query slot a warp

// Values of a row a narrow slab holds: f32 32, bf16 64, int8 128.
template <typename T>
__host__ __device__ constexpr int narrow_depth() {
  return NROW / static_cast<int>(sizeof(T));
}

// The narrow tile's panel width for m: whole, rounded up to a slab, or
// KP_MAX (a multiple of every slab depth).
__host__ __device__ __forceinline__ int narrow_panel(int m, int kd) {
  const int mp = (m + kd - 1) / kd * kd;
  return mp < KP_MAX ? mp : KP_MAX;
}

// Dynamic shared memory of the narrow tile: the ring, the query tile, a
// chunk's staged scores, then list mode's lane lists.
template <typename T, bool LIST, int QN>
size_t narrow_smem(int m) {
  return static_cast<size_t>(NSTAGES) * NSTAGE_BYTES +
         static_cast<size_t>(QN) * (narrow_panel(m, narrow_depth<T>()) + 4) * 4 +
         static_cast<size_t>(QN) * SLD * 4 + (LIST ? NLANE_BYTES : 0);
}

// Fill a narrow stage with values [k0, k0 + KD) of each row of chunk
// `chunk`, piece c of row r at slot c ^ (r & 7); zero past m and past n.
// VEC: 16-byte cp.async pieces (m % 16 == 0, rows 16-byte aligned); else
// scalar loads.
template <typename T, bool VEC>
__device__ __forceinline__ void load_narrow_slab(const DenseSrc<T>& src, T* dst, int chunk,
                                                 int m, int k0, int tid) {
  constexpr int VPP = 16 / sizeof(T), KD = narrow_depth<T>(), PIECES = NROW / 16;
  if (VEC) {
#pragma unroll
    for (int i = 0; i < CR * PIECES / CT; ++i) {
      const int e = tid + i * CT, r = e / PIECES, c = e % PIECES;
      const int kk = k0 + c * VPP;
      bool ok;
      const T* p = src.template row<CR>(chunk, r, ok);
      ok = ok && kk < m;
      cp_async16(dst + r * KD + ((c ^ (r & 7)) * VPP), p + (ok ? kk : 0), ok);
    }
  } else {
    for (int e = tid; e < CR * KD; e += CT) {
      const int r = e / KD, kk = e % KD;
      bool ok;
      const T* p = src.template row<CR>(chunk, r, ok);
      dst[r * KD + (((kk / VPP) ^ (r & 7)) * VPP) + kk % VPP] =
          (ok && k0 + kk < m) ? p[k0 + kk] : T(0.f);
    }
  }
}

// 16 bytes of a narrow slab as f32, exactly: 4 f32, 8 bf16 or 16 int8.
__device__ __forceinline__ void narrow_piece(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void narrow_piece(const __nv_bfloat16* p, float (&v)[8]) {
  upcast8(*reinterpret_cast<const uint4*>(p), v);
}
__device__ __forceinline__ void narrow_piece(const int8_t* p, float (&v)[16]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  upcast4(x.x, v);
  upcast4(x.y, v + 4);
  upcast4(x.z, v + 8);
  upcast4(x.w, v + 12);
}

// acc[i][j] += Q[i] . D[tid + 256 j] over one narrow slab, k ascending; qp:
// the tile panel at the slab's first value.
template <typename T, int QN>
__device__ __forceinline__ void narrow_fma(const float* qp, int qld, const T* Ds,
                                           float (&acc)[QN][2], int tid) {
  constexpr int VPP = 16 / sizeof(T), KD = narrow_depth<T>();
  const int swz = tid & 7;                // rows tid and tid + CT
#pragma unroll
  for (int c = 0; c < NROW / 16; ++c) {
    float d[2][VPP];
#pragma unroll
    for (int j = 0; j < 2; ++j) narrow_piece(Ds + (tid + j * CT) * KD + (c ^ swz) * VPP, d[j]);
#pragma unroll
    for (int i = 0; i < QN; ++i)
#pragma unroll
      for (int v = 0; v < VPP; v += 4) {
        const float4 q = *reinterpret_cast<const float4*>(qp + i * qld + c * VPP + v);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          acc[i][j] = fmaf(q.x, d[j][v], acc[i][j]);
          acc[i][j] = fmaf(q.y, d[j][v + 1], acc[i][j]);
          acc[i][j] = fmaf(q.z, d[j][v + 2], acc[i][j]);
          acc[i][j] = fmaf(q.w, d[j][v + 3], acc[i][j]);
        }
      }
  }
}

// The chunk kernel's walk with a tile of QN queries (dense rows): items,
// segments, counts and running lists as chunk_walk keeps them, warp w
// holding query slot w.
template <typename T, bool VEC, bool LIST, int QN>
__device__ __forceinline__ void narrow_walk(const DenseSrc<T>& src, const float* __restrict__ Q,
                                            int m, int B, int k, int nchunks, int S,
                                            int64_t ldq, uint64_t* __restrict__ cand,
                                            int* __restrict__ counts) {
  constexpr int KD = narrow_depth<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int kp = narrow_panel(m, KD), qld = kp + 4;
  unsigned char* ring = smem;
  float* Qs = reinterpret_cast<float*>(smem + NSTAGES * NSTAGE_BYTES);   // [QN][qld]
  float* Ss = Qs + QN * qld;                                             // [QN][SLD]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the warp's lane list (list mode), its own entries at stride 32
  unsigned short* lanes = reinterpret_cast<unsigned short*>(Ss + QN * SLD) +
                          warp * LANE_J * 32 + lane;
  const int nslab = (m + KD - 1) / KD, ppanel = kp / KD;
  const int tiles = (B + QN - 1) / QN;
  uint64_t run = 0;                       // slot_keys' threshold
  unsigned tau = REAL_HI;                 // slot_list's
  for (int item = blockIdx.x; item < tiles * S; item += gridDim.x) {
    if (item != static_cast<int>(blockIdx.x)) __syncthreads();   // the last item's smem is read
    const int bx = item / tiles, q0 = (item % tiles) * QN;
    const bool slot = warp < QN && q0 + warp < B;   // the warp selects for query q0 + warp
    const int mine = bx < nchunks ? (nchunks - 1 - bx) / S + 1 : 0;
    const int total = mine * nslab;
    auto stage = [&](int t) {
      return reinterpret_cast<T*>(ring + (t % NSTAGES) * NSTAGE_BYTES);
    };
    auto load = [&](int t) {
      load_narrow_slab<T, VEC>(src, stage(t), bx + (t / nslab) * S, m, (t % nslab) * KD, tid);
    };
    // running lists start afresh where the CTA's last item was of another
    // tile, as in chunk_walk
    if (item == static_cast<int>(blockIdx.x) || gridDim.x % tiles != 0) {
      run = 0;
      tau = REAL_HI;
      if constexpr (LIST) {
#pragma unroll
        for (int i = 0; i < LANE_J; ++i) lanes[32 * i] = 0;
      }
    }
    int cnt = 0;
    const int rn = nchunks % S;
    const int64_t seg0 = (static_cast<int64_t>(bx) * (nchunks / S) + (bx < rn ? bx : rn)) * CR;
    float acc[QN][2];
#pragma unroll
    for (int i = 0; i < QN; ++i) acc[i][0] = acc[i][1] = 0.f;
#pragma unroll
    for (int t = 0; t < NSTAGES - 1; ++t) {
      if (t < total) load(t);
      cp_async_commit();
    }
    for (int t = 0; t < total; ++t) {
      cp_async_wait<NSTAGES - 2>();
      __syncthreads();                    // slab t is in; slab t - 1 is consumed
      if (t + NSTAGES - 1 < total) load(t + NSTAGES - 1);
      cp_async_commit();
      const int slab = t % nslab;
      if (slab % ppanel == 0 && (t == 0 || nslab > ppanel)) {
        load_query_panel<CT, QN>(Q, Qs, B, m, q0, slab * KD, kp, tid, nullptr);
        __syncthreads();
      }
      narrow_fma<T, QN>(Qs + (slab % ppanel) * KD, qld, stage(t), acc, tid);
      if (slab == nslab - 1) {
        // the chunk's scores, each thread its rows; the next chunk's first
        // barrier comes after this chunk's select has read them
#pragma unroll
        for (int i = 0; i < QN; ++i) {
          Ss[i * SLD + tid] = acc[i][0];
          Ss[i * SLD + tid + CT] = acc[i][1];
          acc[i][0] = acc[i][1] = 0.f;
        }
        __syncthreads();
        if (slot) {
          const int chunk = bx + (t / nslab) * S;
          const float* srow = Ss + warp * SLD;
          uint64_t* row = cand + static_cast<int64_t>(q0 + warp) * ldq;
          int ids[CR / 32];
          if constexpr (LIST) {
            const unsigned okm = chunk_ids(src, chunk, lane, ids);
            slot_list(srow, src, chunk, ids, okm, tau, cnt, lanes, row + seg0 + cnt, k, lane,
                      lanemask_lt());
          } else {
            bool ok[CR / 32];
#pragma unroll
            for (int u = 0; u < CR / 32; ++u) src.template id<CR>(chunk, lane + 32 * u, ids[u], ok[u]);
            slot_keys(srow, ids, ok, run, row + static_cast<int64_t>(chunk) * k, k, lane);
          }
        }
      }
    }
    cp_async_wait<0>();
    if constexpr (LIST) {
      if (slot && lane == 0) counts[static_cast<int64_t>(q0 + warp) * S + bx] = cnt;
    }
  }
}

// The chunk kernel: chunk_walk with the 32-query tile (any row source), or
// narrow_walk with a tile of QN = 1 or 8 queries (dense rows), which the
// wrapper's plan picks from B.
template <typename T, bool VEC, bool LIST, typename Src, int QN = CQ>
__global__ void __launch_bounds__(CT, 1)
topk_chunk_kernel(Src src_arg, const float* __restrict__ Q, int m, int B, int k, int nchunks,
                  int S, int64_t ldq, uint64_t* __restrict__ cand, int* __restrict__ counts) {
  if constexpr (QN == CQ) {
    chunk_walk<T, VEC, LIST, Src>(src_arg, Q, m, B, k, nchunks, S, ldq, cand, counts);
  } else {
    static_assert(std::is_same<Src, DenseSrc<T>>::value, "a narrow tile takes dense rows");
    narrow_walk<T, VEC, LIST, QN>(src_arg.bound(), Q, m, B, k, nchunks, S, ldq, cand, counts);
  }
}

// ---------------------------------------------------------------------------
// Few rows: topk_unit_kernel, one 64-row unit a chunk
// ---------------------------------------------------------------------------
//
// Where the 512-row chunks are fewer than the CTAs a query tile may have (a
// shortlist's rescore, a live delta, a small paged pool), the chunk kernel
// leaves most SMs idle: 2,560 rows are five CTAs, each running 6.3M FMAs on
// one SM. The unit kernel takes those calls with chunks of one 64-row unit
// and a CTA of four warps over half the 32-query tile, each warp 4 queries
// by the unit's 64 rows (a lane rows lane and lane + 32): 8 chains a thread,
// a sixteenth of the chunk kernel's work a CTA, and three CTAs to an SM. The
// query tile sits in shared memory as in the chunk kernel (a warp's queries are
// read as broadcasts), copied by cp.async in the prologue beside the first
// slabs where no scale row folds into it; the unit's slabs stream through an
// 8-stage cp.async ring in the storage dtype (f32 as slab_at places them,
// int8 and bf16 packed and upcast as they are read, exactly). A warp then holds,
// for each of its queries, the unit's 64 scores in registers, two a lane:
// for k <= SMALL_K it selects the top k into the unit's candidate list
// (a bitonic sort of its 64 keys), and in list mode it lists every real
// key, compacted, into the CTA's segment. The lists, segments,
// merge and select are the chunk kernel's, with 64 rows a chunk.
// Invariant: every score is the chunk kernel's fmaf chain over m (the same
// query values, folded with the page's scale row when scaled, the same
// order), so both kernels give the same bits.
constexpr int UT = 128;                 // threads of the unit kernel: 4 warps
constexpr int UQ = 4;                   // queries a warp
constexpr int UCQ = UT / 32 * UQ;       // queries a CTA (a divisor of CQ)
constexpr int USTAGES = 8;

template <typename T>
__host__ __device__ constexpr int unit_stage_bytes() {
  return UNIT * CK * static_cast<int>(sizeof(T));
}

template <typename T>
size_t unit_smem(int m) {
  return static_cast<size_t>(UCQ) * (panel_width(m) + 4) * 4 + USTAGES * unit_stage_bytes<T>();
}

// Four consecutive values [k4, k4 + 4) of row r of a unit slab, as f32.
__device__ __forceinline__ float4 row4(const float* s, int r, int k4) {
  return *reinterpret_cast<const float4*>(s + slab_at(r, k4 >> 2));
}
__device__ __forceinline__ float4 row4(const __nv_bfloat16* s, int r, int k4) {
  const uint2 v = *reinterpret_cast<const uint2*>(s + r * CK + k4);
  return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
}
__device__ __forceinline__ float4 row4(const int8_t* s, int r, int k4) {
  const char4 v = *reinterpret_cast<const char4*>(s + r * CK + k4);
  return make_float4(v.x, v.y, v.z, v.w);
}

// acc[i][t] += Q[i] . D[lane + 32 t] over one CK-deep slab, k ascending;
// qb: the warp's first query in the tile panel. Each half slab's operands
// are loaded, then the warp synchronises, then the FMAs run: the chains
// wait for one load latency a half, not one a step (left to itself the
// compiler issues each load just before its FMAs).
template <typename T>
__device__ __forceinline__ void unit_fma(const float* qb, int qld, const T* Ds,
                                         float (&acc)[UQ][2], int lane) {
#pragma unroll
  for (int h = 0; h < CK; h += 8) {
    float4 d[2][2], q[UQ][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      d[0][j] = row4(Ds, lane, h + 4 * j);
      d[1][j] = row4(Ds, lane + 32, h + 4 * j);
#pragma unroll
      for (int i = 0; i < UQ; ++i)
        q[i][j] = *reinterpret_cast<const float4*>(qb + i * qld + h + 4 * j);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < UQ; ++i)
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          acc[i][t] = fmaf(q[i][j].x, d[t][j].x, acc[i][t]);
          acc[i][t] = fmaf(q[i][j].y, d[t][j].y, acc[i][t]);
          acc[i][t] = fmaf(q[i][j].z, d[t][j].z, acc[i][t]);
          acc[i][t] = fmaf(q[i][j].w, d[t][j].w, acc[i][t]);
        }
  }
}

// One step of a bitonic network over a warp's 64 keys (element e = lane +
// 32 t is keys[t] of lane `lane`): v, element e, against element e ^ stride
// (stride < 32, another lane), kept in descending order where e & size is 0.
__device__ __forceinline__ uint64_t bitonic_step(uint64_t v, int e, int stride, int size) {
  const uint64_t o = __shfl_xor_sync(FULL, v, stride);
  const bool keep_max = ((e & size) == 0) == ((e & stride) == 0);
  return keep_max ? (o > v ? o : v) : (o < v ? o : v);
}

// The unit's top k per query of the warp (k <= SMALL_K) into the unit's
// candidate list: the 64 keys of a query (masked rows as PAD_KEY) sorted
// descending by a bitonic network across the warp, the queries' steps
// interleaved, then lane j < k writes the j-th (keys at or below PAD_KEY
// as PAD_KEY, as warp_extract writes them); then acc is zeroed. The list
// holds the unit's top k whatever came before: no running threshold, which
// a CTA that walks one or two units would not use.
constexpr int SORT_Q = UQ;              // queries sorted together
template <typename Src>
__device__ __forceinline__ void unit_keys(float (&acc)[UQ][2], const Src& src, int B, int q0,
                                          int k, int chunk, int64_t ldq,
                                          uint64_t* __restrict__ cand, int warp, int lane) {
  int ids[2];
  bool ok[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) src.template id<UNIT>(chunk, lane + 32 * t, ids[t], ok[t]);
#pragma unroll
  for (int i0 = 0; i0 < UQ; i0 += SORT_Q) {
    uint64_t keys[SORT_Q][2];
#pragma unroll
    for (int i = 0; i < SORT_Q; ++i)
#pragma unroll
      for (int t = 0; t < 2; ++t)
        keys[i][t] = ok[t] ? encode_key(acc[i0 + i][t], ids[t]) : PAD_KEY;
#pragma unroll
    for (int size = 2; size <= 2 * 32; size <<= 1)
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1)
#pragma unroll
        for (int i = 0; i < SORT_Q; ++i) {
          if (stride == 32) {            // size 64: lane-local pairs, descending
            const uint64_t a = keys[i][0], b = keys[i][1];
            keys[i][0] = a > b ? a : b;
            keys[i][1] = a > b ? b : a;
          } else {
            keys[i][0] = bitonic_step(keys[i][0], lane, stride, size);
            keys[i][1] = bitonic_step(keys[i][1], lane + 32, stride, size);
          }
        }
#pragma unroll
    for (int i = 0; i < SORT_Q; ++i) {
      const int q = warp * UQ + i0 + i;
      if (q0 + q < B && lane < k)
        cand[static_cast<int64_t>(q0 + q) * ldq + static_cast<int64_t>(chunk) * k + lane] =
            keys[i][0] > PAD_KEY ? keys[i][0] : PAD_KEY;
    }
  }
#pragma unroll
  for (int i = 0; i < UQ; ++i) acc[i][0] = acc[i][1] = 0.f;
}

// List mode: every real key of the unit per query of the warp (what
// chunk_list lists at its starting threshold), compacted into the CTA's
// segment after cnt[i] keys; then acc is zeroed. A unit is 64 rows, so a
// running threshold would skip little: none is kept.
template <typename Src>
__device__ __forceinline__ void unit_list(float (&acc)[UQ][2], int (&cnt)[UQ], const Src& src,
                                          int B, int q0, int chunk, int64_t ldq, int64_t seg0,
                                          uint64_t* __restrict__ cand, int warp, int lane) {
  const unsigned below = lanemask_lt();
  const float real = hi_score(REAL_HI);
  int ids[2];
  bool ok[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) src.template id<UNIT>(chunk, lane + 32 * t, ids[t], ok[t]);
#pragma unroll
  for (int i = 0; i < UQ; ++i) {
    const int q = warp * UQ + i;
    if (q0 + q >= B) break;
    uint64_t* dst = cand + static_cast<int64_t>(q0 + q) * ldq + seg0 + cnt[i];
    int c = 0;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const float sc = acc[i][t];
      const bool take = ok[t] && !(sc < real);
      const unsigned mask = __ballot_sync(FULL, take);
      if (take) dst[c + __popc(mask & below)] = make_key(key_hi(sc), ids[t]);
      c += __popc(mask);
    }
    cnt[i] += c;
  }
#pragma unroll
  for (int i = 0; i < UQ; ++i) acc[i][0] = acc[i][1] = 0.f;
}

// The query tile panel [0, kp) of queries [q0, q0 + UCQ) by 16-byte cp.async
// pieces (m % 16 == 0 and Q 16-byte aligned; no scale row), zero past B
// and past m, as load_query_panel writes it: in flight with the ring's
// first slabs, landed by their wait.
__device__ __forceinline__ void copy_query_panel(const float* __restrict__ Q, float* Qs, int B,
                                                 int m, int q0, int kp, int tid) {
  const int qld = kp + 4, per = kp / 4;
  for (int e = tid; e < UCQ * per; e += UT) {
    const int q = e / per, c = e % per;
    const bool ok = q0 + q < B && 4 * c < m;
    cp_async16(Qs + q * qld + 4 * c, Q + (ok ? static_cast<int64_t>(q0 + q) * m + 4 * c : 0),
               ok);
  }
}

// Persistent as the chunk kernel: CTA (x, y) walks units x, x + gridDim.x,
// ... of query tile y up to the source's live units; for k <= SMALL_K the
// units past those get pads, in list mode segment x holds (x qn + min(x,
// rn)) 64 keys before it and the CTA writes counts[query][x]. A warp whose
// queries all lie past B runs no FMA. Scaled pages fold the query tile with
// the unit's page scale row (a unit lies in one page), reloaded where the
// row changes along the CTA's walk.
template <typename T, bool VEC, bool LIST, typename Src>
__global__ void __launch_bounds__(UT, 3)
topk_unit_kernel(Src src_arg, const float* __restrict__ Q, int m, int B, int k, int nchunks,
                 int64_t ldq, uint64_t* __restrict__ cand, int* __restrict__ counts) {
  const Src src = src_arg.bound();
  extern __shared__ __align__(16) unsigned char smem[];
  const int kp = panel_width(m), qld = kp + 4;
  float* Qs = reinterpret_cast<float*>(smem);                       // [UCQ][qld]
  unsigned char* ring = reinterpret_cast<unsigned char*>(Qs + UCQ * qld);
  const int q0 = blockIdx.y * UCQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nslab = (m + CK - 1) / CK;
  const int ppanel = kp / CK;
  // the whole tile in one panel, no fold, 16-byte pieces: copied ahead
  const bool early = !Src::SCALED && VEC && nslab <= ppanel &&
                     reinterpret_cast<uintptr_t>(Q) % 16 == 0;
  const int bx = static_cast<int>(blockIdx.x), gx = static_cast<int>(gridDim.x);
  const int live = src.live_chunks(nchunks);
  const int mine = bx < live ? (live - 1 - bx) / gx + 1 : 0;
  const int total = mine * nslab;
  const bool busy = q0 + warp * UQ < B;
  auto stage = [&](int t) {
    return reinterpret_cast<T*>(ring + (t % USTAGES) * unit_stage_bytes<T>());
  };
  // the walk's position, kept by counters (a division a slab would cost
  // more than the slab's FMAs): the next slab to load, and slab t (its
  // slab in the chunk, in the query panel, and its chunk)
  int lslab = 0, lchunk = bx;
  int slab = 0, pan = 0, chunk = bx;
  auto load_next = [&](int t) {
    load_chunk_slab<T, VEC, UNIT, UT>(src, stage(t), lchunk, m, lslab * CK, tid);
    if (++lslab == nslab) {
      lslab = 0;
      lchunk += gx;
    }
  };

  float acc[UQ][2];
  int cnt[UQ];
#pragma unroll
  for (int i = 0; i < UQ; ++i) {
    acc[i][0] = acc[i][1] = 0.f;
    cnt[i] = 0;
  }
  const int qn = nchunks / gx, rn = nchunks % gx;
  const int64_t seg0 = (static_cast<int64_t>(bx) * qn + (bx < rn ? bx : rn)) * UNIT;
  int2 fs = make_int2(-1, Src::SCALED ? 0 : 1);

  if (early && total > 0) copy_query_panel(Q, Qs, B, m, q0, kp, tid);   // in group 0
#pragma unroll
  for (int t = 0; t < USTAGES - 1; ++t) {
    if (t < total) load_next(t);
    cp_async_commit();
  }
  for (int t = 0; t < total; ++t) {
    cp_async_wait<USTAGES - 2>();
    __syncthreads();                   // slab t is in (and an early tile); t - 1 consumed
    if (Src::SCALED && slab == 0) fs = src.fold_state(chunk);
    if (!early && pan == 0 && (t == 0 || nslab > ppanel || (slab == 0 && !fs.y))) {
      load_query_panel<UT, UCQ>(Q, Qs, B, m, q0, slab * CK, kp, tid,
                                Src::SCALED && fs.x >= 0 ? src.slot_scale(fs.x) : nullptr);
      __syncthreads();
    }
    if (t + USTAGES - 1 < total) load_next(t + USTAGES - 1);
    cp_async_commit();
    if (busy) unit_fma(Qs + pan * CK + warp * UQ * qld, qld, stage(t), acc, lane);
    if (slab == nslab - 1) {
      if constexpr (LIST)
        unit_list(acc, cnt, src, B, q0, chunk, ldq, seg0, cand, warp, lane);
      else
        unit_keys(acc, src, B, q0, k, chunk, ldq, cand, warp, lane);
    }
    if (++slab == nslab) {
      slab = pan = 0;
      chunk += gx;
    } else if (++pan == ppanel) {
      pan = 0;
    }
  }
  cp_async_wait<0>();
  if constexpr (LIST) {
    if (lane == 0)
#pragma unroll
      for (int i = 0; i < UQ; ++i) {
        const int q = warp * UQ + i;
        if (q0 + q < B) counts[static_cast<int64_t>(q0 + q) * gx + bx] = cnt[i];
      }
  } else {
    for (int c = bx + mine * gx; c < nchunks; c += gx)
      for (int e = tid; e < UCQ * k; e += UT) {
        const int q = e / k;
        if (q0 + q < B)
          cand[static_cast<int64_t>(q0 + q) * ldq + static_cast<int64_t>(c) * k + e % k] =
              PAD_KEY;
      }
  }
}

// One warp per (group of G lists of k keys, query) keeps the group's top k
// (k <= SMALL_K). With `unfinal` the last level numbers the -inf slots as
// the reference's un-finalized running list does: slot j after c finite
// slots gets id -(j - c + 2), so a carry chained into a later call keeps
// the same ids.
__global__ void __launch_bounds__(MT)
topk_merge_kernel(const uint64_t* __restrict__ cand, int L, int k, int G, int Lout,
                  uint64_t* __restrict__ next, float* __restrict__ out_s,
                  int* __restrict__ out_i, int unfinal) {
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
  uint64_t keys[MERGE_SMALL / 32];
#pragma unroll
  for (int t = 0; t < MERGE_SMALL / 32; ++t) {
    const int idx = lane + 32 * t;
    keys[t] = idx < C ? src[idx] : 0;
  }
  warp_extract<MERGE_SMALL / 32>(keys, k, emit, NoEach{});
  if (next == nullptr && unfinal) {
    __syncwarp();                               // the warp's own stores above
    const float* srow = out_s + static_cast<int64_t>(q) * k;
    int* irow = out_i + static_cast<int64_t>(q) * k;
    const int c = __popc(__ballot_sync(FULL, lane < k && srow[lane] != __int_as_float(0xff800000)));
    if (lane < k && srow[lane] == __int_as_float(0xff800000)) irow[lane] = -(lane - c + 2);
  }
}

// The carry (B, k) enters a query's keys at [off, off + k) of its row of
// ld keys; its -inf slots are pads.
__global__ void carry_keys_kernel(const float* __restrict__ cs,
                                  const int* __restrict__ ci, int B, int k,
                                  int64_t ld, int64_t off, uint64_t* __restrict__ cand) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<int64_t>(B) * k) return;
  const int64_t q = e / k;
  const int j = static_cast<int>(e % k);
  const float s = cs[e];
  cand[q * ld + off + j] = s == __int_as_float(0xff800000) ? PAD_KEY : encode_key(s, ci[e]);
}

// The unit table of a paged walk over slots [lo, hi) in chunks of upc units
// (8, or 1 for the unit kernel): U = ceil(R / 64) units a page. With U <=
// upc a chunk holds ppc = upc / U whole pages (units past ppc U are
// masked); else a page spans cpp = ceil(U / upc) chunks. A
// table entry below pool_pages addresses the pool, one at or above it the
// tail, one in neither masks the page. Rows that may be live: up to
// page_nvalid[slot], or up to R with ids_pool. With lo_dev / hi_dev the
// walk is over [*lo_dev, *hi_dev) clamped to the planned [lo, hi), and
// thread 0 writes the chunks that cover it to *live_out.
template <typename T>
__global__ void paged_units_kernel(const T* __restrict__ pool, const T* __restrict__ tail,
                                   const int* __restrict__ table, const int* __restrict__ nvalid,
                                   const int* __restrict__ offset, int pool_pages,
                                   int tail_pages, int R, int m, int lo, int hi,
                                   const int* __restrict__ lo_dev, const int* __restrict__ hi_dev,
                                   int U, int ppc, int cpp, int upc, int with_ids, int nunits,
                                   Unit* __restrict__ units, int* __restrict__ live_out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= nunits) return;
  const int cap = hi;                          // the planned range's end
  if (lo_dev != nullptr) {
    const int a = *lo_dev, b = *hi_dev;
    const int l = a < lo ? lo : (a > cap ? cap : a);
    hi = b < lo ? lo : (b > cap ? cap : b);
    lo = l;
    if (e == 0) *live_out = hi <= lo ? 0 : (cpp == 1 ? (hi - lo + ppc - 1) / ppc : (hi - lo) * cpp);
  }
  const int c = e / upc, u = e % upc;
  int64_t slot;
  int row0;
  bool live;
  if (cpp == 1) {
    const int p = u / U;
    slot = lo + static_cast<int64_t>(c) * ppc + p;
    row0 = (u % U) * UNIT;
    live = p < ppc;
  } else {
    slot = lo + c / cpp;
    row0 = ((c % cpp) * upc + u) * UNIT;
    live = true;
  }
  live = live && slot < hi && row0 < R;
  // a masked unit's slot stays in the table, for the scale row it names
  Unit out{reinterpret_cast<long long>(pool), 0, 0,
           live ? static_cast<int>(slot) : (lo < cap ? lo : cap - 1), row0};
  if (live) {
    const int phys = table[slot];
    const T* page = nullptr;
    if (phys >= 0 && phys < pool_pages)
      page = pool + static_cast<int64_t>(phys) * R * m;
    else if (phys >= pool_pages && phys - pool_pages < tail_pages)
      page = tail + static_cast<int64_t>(phys - pool_pages) * R * m;
    if (page != nullptr) {
      const int lim = with_ids ? R : min(nvalid[slot], R);
      out.base = reinterpret_cast<long long>(page + static_cast<int64_t>(row0) * m);
      out.rows = max(0, min(UNIT, lim - row0));
      out.id0 = offset[slot] + row0;
    }
  }
  units[e] = out;
}

// Scale rows a and b of the table are bitwise equal (one warp).
__device__ __forceinline__ bool rows_equal(const float* scale, int m, int a, int b) {
  if (a == b) return true;
  const unsigned* ra = reinterpret_cast<const unsigned*>(scale + static_cast<int64_t>(a) * m);
  const unsigned* rb = reinterpret_cast<const unsigned*>(scale + static_cast<int64_t>(b) * m);
  bool eq = true;
  for (int i = threadIdx.x & 31; i < m; i += 32) eq = eq && ra[i] == rb[i];
  return __all_sync(FULL, eq);
}

// The slot whose scale row every live unit of chunk c (upc units) shares
// (the first live one's), -1 when they differ, the chunk's first slot when
// none is live (its rows are all masked, so any fold serves).
__device__ __forceinline__ int chunk_fold(const Unit* units, const float* scale, int m, int c,
                                          int upc) {
  int rep = -1;
  for (int u = 0; u < upc; ++u) {
    const Unit& x = units[c * upc + u];
    if (x.rows == 0) continue;
    if (rep < 0) rep = x.slot;
    else if (!rows_equal(scale, m, rep, x.slot)) return -1;
  }
  return rep < 0 ? units[c * upc].slot : rep;
}

// One warp per chunk: fold[c] = (chunk_fold(c), whether the tile the item
// left after chunk c - S, its last, already holds that fold); only for the
// chunks the chunk kernel walks (*live of them, when live is set).
__global__ void paged_fold_kernel(const Unit* __restrict__ units, const float* __restrict__ scale,
                                  int m, int nchunks, int upc, const int* __restrict__ live,
                                  int S, int2* __restrict__ fold) {
  const int c = static_cast<int>((static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 32);
  if (c >= nchunks || (live != nullptr && c >= *live)) return;   // whole warp
  const int r = chunk_fold(units, scale, m, c, upc);
  int same = 0;
  if (c >= S) {
    const int p = chunk_fold(units, scale, m, c - S, upc);
    same = (r < 0 && p < 0) || (r >= 0 && p >= 0 && rows_equal(scale, m, r, p));
  }
  if ((threadIdx.x & 31) == 0) fold[c] = make_int2(r, same);
}

// ---------------------------------------------------------------------------
// k > SMALL_K: select over each query's listed keys, gather, sort, write
// ---------------------------------------------------------------------------
//
// Replaces the running top-k of topk_score_pallas / topk_score_paged_pallas
// for large k. A query's keys sit in one row of `keys` as segments (Segs):
// one per item of the chunk kernel, each with the count of keys it listed,
// then the carry's k keys; topk_select_keys passes one segment of a row's
// live count. The select walks only the counted keys: T of them for a
// query, and k_eff = min(k, T) is taken on the device, so the host reads
// nothing and a captured CUDA graph replays at any count.
//
// Passes take 11-bit digits from the top (shifts 53, 42, 31, 20, 9, then 9
// bits at 0): a histogram counts, per query, the digit of every key whose
// higher bits equal the prefix found so far; a pick finds the digit holding
// the k-th largest key and what is left to take. A query is done when the
// keys at or above that digit's bin fit the gather's room (then every key at
// or above the bin is taken) or at the last digit (then the k-th key T
// itself: all keys above T, and as many copies of T as are still needed).
// Keys are unique except equal copies (an id repeated in row_ids /
// ids_pool, or pads), so the taken keys are exactly the top k (plus keys of
// the last bin below it), whatever duplicates there are; duplicate copies
// are interchangeable. A sort of the taken keys and a write of the first k
// follow; slots past T are pads.
//
// select_fused_kernel runs first, one CTA per query: where T <= FCAP and
// k_eff <= FN it does all of that in shared memory (a 2,048-bin histogram,
// the gather into FN keys, a bitonic sort of the next power of two above
// the taken keys) and writes the query's result, one launch a batch. Other
// queries it leaves to the multi-CTA path (radix_hist / radix_pick,
// radix_gather into N = 2^ceil(log2(k_eff + SLACK)) keys a query, the
// bitonic kernels and select_write), which the host launches only when
// the planned keys a query (every row listed) could pass FCAP or k could
// pass FN; those kernels skip the queries the fused kernel finished. Bound:
// each digit pass reads the listed keys once (8 bytes each), the gather
// once more; at serving scores two or three passes decide.
constexpr int RBITS = 11;
constexpr int RBINS = 1 << RBITS;
constexpr int RT = 256;          // threads of the histogram and gather kernels
constexpr int SLACK = 2048;      // keys of the last bin taken whole (multi-CTA path)
constexpr int NPASS = 6;
constexpr int SORT_TILE = 8192;  // keys a CTA sorts in shared memory (64 KB)
constexpr int ST = 1024;         // threads of the sort kernels
constexpr int FT = 1024;         // threads of the fused select
constexpr int FN = 8192;         // keys it gathers and sorts in shared memory (64 KB)
constexpr long long FCAP = 1LL << 20;   // listed keys a query above which it leaves the query
constexpr int MAX_SEG = 1024;    // segments of a query's row (the chunk kernel's CTAs, + 1)

__device__ __forceinline__ int pass_shift(int p) { return p < NPASS - 1 ? 53 - 11 * p : 0; }
__device__ __forceinline__ int pass_width(int p) { return p < NPASS - 1 ? 11 : 9; }

// A query's keys in row q of `keys` (ld keys a row): segment s < S starts
// at (s qn + min(s, rn)) unit and holds up to (qn + (s < rn)) unit keys, of
// which cnt[q S + s] (clamped; every slot when cnt is null) are live; then,
// with `extra`, one segment of `extra` keys, all live.
struct Segs {
  const int* cnt;
  int64_t ld, unit;
  int S, qn, rn, extra;
  __host__ __device__ __forceinline__ int nseg() const { return S + (extra > 0 ? 1 : 0); }
  __device__ __forceinline__ int64_t start(int s) const {
    const int x = s < S ? s : S;
    return (static_cast<int64_t>(x) * qn + (x < rn ? x : rn)) * unit;
  }
  __device__ __forceinline__ long long count(int q, int s) const {
    if (s >= S) return extra;
    const long long cap = static_cast<long long>(qn + (s < rn ? 1 : 0)) * unit;
    if (cnt == nullptr) return cap;
    const long long c = cnt[static_cast<int64_t>(q) * S + s];
    return c < 0 ? 0 : (c > cap ? cap : c);
  }
};

// Per query: `prefix` (once done, the threshold T: keys above it are all
// taken), `need` (keys still to take at or below the prefix; once done,
// the copies of T to take), `above` (keys known to be above; once done,
// the keys above T), `done` (1: selected, the gather is next; 2: the
// fused kernel wrote the result).
struct Sel {
  unsigned long long prefix;
  long long need, above;
  int done, pad;
};

// One warp: the digit holding the need-th largest key of the histogram hq
// (RBINS bins), the keys in higher bins and the digit's own count.
__device__ __forceinline__ void pick_digit(const unsigned* hq, long long need, int& digit,
                                           long long& above, long long& count) {
  const int lane = threadIdx.x & 31;
  // lane l sums bins [RBINS - 64 (l + 1), RBINS - 64 l): lane 0 the top
  constexpr int SEG = RBINS / 32;
  const int top = RBINS - SEG * lane;
  long long seg = 0;
  for (int b = top - SEG; b < top; ++b) seg += hq[b];
  long long incl = seg;                        // keys in this and higher segments
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const long long o = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += o;
  }
  const long long excl = incl - seg;
  const unsigned owner = __ballot_sync(FULL, excl < need && need <= incl);
  const int src = owner ? __ffs(owner) - 1 : 0;   // a lane always holds it
  int d = 0;
  long long ab = 0, c = 0;
  if (lane == src) {
    ab = excl;
    for (int b = top - 1; b >= top - SEG; --b) {
      const long long x = hq[b];
      if (ab + x >= need) { d = b; c = x; break; }
      ab += x;
    }
  }
  digit = __shfl_sync(FULL, d, src);
  above = __shfl_sync(FULL, ab, src);
  count = __shfl_sync(FULL, c, src);
}

// The state after a digit of pass `shift`: the prefix gains the digit; done
// at the last digit, or when the keys at or above the bin (room: those the
// gather may take) all fit, then taken whole (T is one below the bin).
__device__ __forceinline__ Sel sel_step(Sel s, int digit, long long above, long long count,
                                        int shift, long long room) {
  s.prefix |= static_cast<unsigned long long>(digit) << shift;
  s.need -= above;
  s.above += above;
  if (shift == 0) {
    s.done = 1;                                // prefix is the k-th key
  } else if (s.above + count <= room && s.prefix != 0) {
    s.done = 1;                                // take the whole bin
    s.above += count;
    s.need = 0;
    s.prefix -= 1;
  }
  return s;
}

// The live keys of query q in segments [s0, s0 + nseg) as work items for a
// team of NT threads (a warp or a block): item (s, x) is slice x of
// nslices of segment s0 + s (segc[s] its count, or read from sg); team
// `team` of nteams takes items team, team + nteams, ... and calls f(key,
// live) for U keys at a time, all U loads issued before any use. Loop
// bounds are uniform across a team, so a warp's lanes stay together.
constexpr int U_KEYS = 4;
template <int NT, typename F>
__device__ __forceinline__ void team_keys(const uint64_t* row, const Segs& sg, int q, int s0,
                                          int nseg, const long long* segc, int team, int nteams,
                                          int nslices, int t, F f) {
  const long long items = static_cast<long long>(nseg) * nslices;
  for (long long it = team; it < items; it += nteams) {
    const int s = static_cast<int>(it / nslices), x = static_cast<int>(it % nslices);
    const long long c = segc != nullptr ? segc[s] : sg.count(q, s0 + s);
    const uint64_t* seg = row + sg.start(s0 + s);
    const long long step = static_cast<long long>(nslices) * NT;
    for (long long i0 = static_cast<long long>(x) * NT; i0 < c; i0 += step * U_KEYS) {
      uint64_t key[U_KEYS];
#pragma unroll
      for (int u = 0; u < U_KEYS; ++u) {
        const long long i = i0 + u * step + t;
        key[u] = i < c ? seg[i] : 0;
      }
#pragma unroll
      for (int u = 0; u < U_KEYS; ++u) f(key[u], i0 + u * step + t < c);
    }
  }
}

// Histogram of the digit at `shift` of the keys whose higher bits equal
// `prefix` (hmask: those bits), into h. Lanes of one digit add once: the
// leading digits of real scores are few.
struct HistKey {
  unsigned* h;
  uint64_t prefix, hmask;
  int shift;
  unsigned dmask;
  __device__ __forceinline__ void operator()(uint64_t key, bool live) const {
    unsigned d = RBINS;                        // no bin
    if (live && (key & hmask) == prefix) d = static_cast<unsigned>(key >> shift) & dmask;
    const unsigned peers = __match_any_sync(FULL, d);
    if (d < RBINS && static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1)
      atomicAdd(&h[d], __popc(peers));
  }
};

// Keys above T to dst[0, ...), and up to `eq` copies of T to dst[above,
// ...), through the slot counters c[0] and c[1] (warp-aggregated).
template <typename Counter>
struct GatherKey {
  uint64_t T;
  long long eq, above;
  uint64_t* dst;
  Counter* c;
  __device__ __forceinline__ void operator()(uint64_t key, bool live) const {
    const bool up = live && key > T;
    const bool tie = live && eq > 0 && key == T;
    const unsigned mu = __ballot_sync(FULL, up), mt = __ballot_sync(FULL, tie);
    const unsigned lt = lanemask_lt();
    Counter bu = 0, bt = 0;
    if ((threadIdx.x & 31) == 0 && mu) bu = atomicAdd(&c[0], static_cast<Counter>(__popc(mu)));
    if ((threadIdx.x & 31) == 0 && mt) bt = atomicAdd(&c[1], static_cast<Counter>(__popc(mt)));
    bu = __shfl_sync(FULL, bu, 0);
    bt = __shfl_sync(FULL, bt, 0);
    if (up) dst[bu + __popc(mu & lt)] = key;
    if (tie) {
      const long long pos = static_cast<long long>(bt) + __popc(mt & lt);
      if (pos < eq) dst[above + pos] = key;
    }
  }
};

// Bitonic compare-exchange of the pair (lo, lo + stride) for a network
// stage of `size`, descending where the global index has bit `size` clear.
__device__ __forceinline__ void bitonic_pair(uint64_t* buf, int64_t gbase, int lo, int stride,
                                             int64_t size) {
  const uint64_t a = buf[lo], b = buf[lo + stride];
  const bool desc = ((gbase + lo) & size) == 0;
  if (desc ? (a < b) : (a > b)) { buf[lo] = b; buf[lo + stride] = a; }
}

// The first k of a query's `n` sorted keys (row, descending) as scores and
// ids, by the CTA: slots past n or holding a pad are (-inf, -1), or with
// `unfinal` slot j after c finite slots gets id -(j - c + 2), as the merge
// writes them.
__device__ __forceinline__ void write_sorted(const uint64_t* row, int64_t n, int k, int unfinal,
                                             float* out_s, int* out_i) {
  const int q = blockIdx.x;
  int c = 0;
  if (unfinal)
    for (int j0 = 0; j0 < k; j0 += blockDim.x) {
      const int j = j0 + threadIdx.x;
      c += __syncthreads_count(j < k && j < n && !key_is_pad(row[j]));
    }
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const uint64_t key = j < n ? row[j] : 0;
    const bool pad = key_is_pad(key);
    out_s[static_cast<int64_t>(q) * k + j] = pad ? __int_as_float(0xff800000) : key_score(key);
    out_i[static_cast<int64_t>(q) * k + j] = pad ? (unfinal ? -(j - c + 2) : -1) : key_id(key);
  }
}

// The warp sums of v, then the block's, to every thread (red: 32 slots).
__device__ __forceinline__ long long block_sum(long long v, long long* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < static_cast<int>(blockDim.x / 32) ? red[lane] : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  v = red[0];
  __syncthreads();
  return v;
}

// One CTA per query: the whole select of a query whose T live keys are at
// most FCAP and k_eff = min(k, T) at most FN, in shared memory, then its
// result; else the query's starting state for the multi-CTA path. A digit
// pass stops once the keys at or above its bin fit `room` (at most FN),
// which bounds the sort. With `part` (two levels, gridDim.y = G groups),
// CTA (q, g) takes query q's segments [g nseg / G, (g + 1) nseg / G) and
// writes their top k_eff keys, sorted, at part[(q G + g) k] and k_eff at
// part_cnt[q G + g]: the host plans it only where each group's keys fit
// FCAP and k fits FN, so every group finishes here.
__global__ void __launch_bounds__(FT)
select_fused_kernel(const uint64_t* __restrict__ keys, Segs sg, int k, int unfinal, int room,
                    Sel* __restrict__ st, float* __restrict__ out_s, int* __restrict__ out_i,
                    uint64_t* __restrict__ part, int* __restrict__ part_cnt) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* buf = reinterpret_cast<uint64_t*>(smem);      // FN keys
  __shared__ unsigned h[RBINS];
  __shared__ long long segc[MAX_SEG];
  __shared__ long long red[32];
  __shared__ Sel sh;
  __shared__ unsigned cnt2[2];
  const int q = blockIdx.x, tid = threadIdx.x;
  const int g = blockIdx.y, groups = gridDim.y;
  const int s0 = static_cast<int>(static_cast<int64_t>(g) * sg.nseg() / groups);
  const int nseg = static_cast<int>(static_cast<int64_t>(g + 1) * sg.nseg() / groups) - s0;
  long long mine = 0;
  for (int s = tid; s < nseg; s += FT) {
    const long long c = sg.count(q, s0 + s);
    segc[s] = c;
    mine += c;
  }
  const long long T = block_sum(mine, red);   // its barriers publish segc
  const long long k_eff = k < T ? k : T;
  if (T > FCAP || k_eff > FN) {
    if (tid == 0 && part == nullptr) st[q] = Sel{0ull, k_eff, 0, 0, 0};
    return;                                   // the whole CTA
  }
  const uint64_t* row = keys + static_cast<int64_t>(q) * sg.ld;
  // a warp a slice of a segment, sliced so that the warps have work when
  // the segments are fewer than they are
  const int nslices = nseg > 0 ? (FT / 32 + nseg - 1) / nseg : 1;
  long long G = 0;                            // keys taken
  if (k_eff > 0) {
    if (tid == 0) sh = Sel{0ull, k_eff, 0, 0, 0};
    for (int p = 0; p < NPASS; ++p) {
      for (int i = tid; i < RBINS; i += FT) h[i] = 0;
      __syncthreads();                        // also publishes sh
      const int shift = pass_shift(p), width = pass_width(p);
      const uint64_t hmask = p == 0 ? 0 : ~0ull << (shift + width);
      team_keys<32>(row, sg, q, s0, nseg, segc, tid / 32, FT / 32, nslices, tid & 31,
                    HistKey{h, sh.prefix, hmask, shift, (1u << width) - 1});
      __syncthreads();
      if (tid < 32) {
        int digit;
        long long above, count;
        pick_digit(h, sh.need, digit, above, count);
        if (tid == 0) sh = sel_step(sh, digit, above, count, shift, room);
      }
      __syncthreads();
      if (sh.done) break;
    }
    if (tid < 2) cnt2[tid] = 0;
    __syncthreads();
    team_keys<32>(row, sg, q, s0, nseg, segc, tid / 32, FT / 32, nslices, tid & 31,
                  GatherKey<unsigned>{sh.prefix, sh.need, sh.above, buf, cnt2});
    G = sh.above + sh.need;
  }
  int Ns = 1;
  while (Ns < G) Ns <<= 1;
  for (int i = static_cast<int>(G) + tid; i < Ns; i += FT) buf[i] = 0;
  __syncthreads();
  for (int size = 2; size <= Ns; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < Ns / 2; i += FT)
        bitonic_pair(buf, 0, (i / stride) * 2 * stride + (i % stride), stride, size);
      __syncthreads();
    }
  if (part != nullptr) {
    const int64_t at = static_cast<int64_t>(q) * groups + g;
    for (int j = tid; j < k_eff; j += FT) part[at * k + j] = buf[j];
    if (tid == 0) part_cnt[at] = static_cast<int>(k_eff);
    return;
  }
  write_sorted(buf, G, k, unfinal, out_s, out_i);
  if (tid == 0) st[q] = Sel{0ull, 0, 0, 2, 0};
}

__global__ void __launch_bounds__(RT)
radix_hist_kernel(const uint64_t* __restrict__ keys, Segs sg, int pass,
                  const Sel* __restrict__ st, unsigned* __restrict__ hist) {
  __shared__ unsigned h[RBINS];
  const int q = blockIdx.y;
  if (st[q].done) return;                      // the whole CTA
  const int shift = pass_shift(pass), width = pass_width(pass);
  const uint64_t prefix = pass == 0 ? 0 : st[q].prefix;
  const uint64_t hmask = pass == 0 ? 0 : ~0ull << (shift + width);
  const unsigned dmask = (1u << width) - 1;
  for (int i = threadIdx.x; i <= static_cast<int>(dmask); i += RT) h[i] = 0;
  __syncthreads();
  // a block a slice of every segment: the segments may be long
  team_keys<RT>(keys + static_cast<int64_t>(q) * sg.ld, sg, q, 0, sg.nseg(), nullptr, blockIdx.x,
                gridDim.x, gridDim.x, threadIdx.x, HistKey{h, prefix, hmask, shift, dmask});
  __syncthreads();
  for (int i = threadIdx.x; i <= static_cast<int>(dmask); i += RT)
    if (h[i]) atomicAdd(&hist[static_cast<int64_t>(q) * RBINS + i], h[i]);
}

// One warp per query: the digit holding the need-th largest key at this
// pass, from the histogram (which it zeroes for the next pass).
__global__ void __launch_bounds__(32)
radix_pick_kernel(Sel* __restrict__ st, unsigned* __restrict__ hist, int pass, long long room) {
  const int q = blockIdx.x, lane = threadIdx.x;
  const Sel s = st[q];
  if (s.done) return;
  unsigned* hq = hist + static_cast<int64_t>(q) * RBINS;
  int digit;
  long long above, count;
  pick_digit(hq, s.need, digit, above, count);
  __syncwarp();
  for (int b = lane; b < RBINS; b += 32) hq[b] = 0;
  if (lane == 0) st[q] = sel_step(s, digit, above, count, pass_shift(pass), room);
}

// Keys above T to the front of the query's row of `out` (N slots), and
// `need` copies of T after them; warp-aggregated slot counters cnt[q][2].
__global__ void __launch_bounds__(RT)
radix_gather_kernel(const uint64_t* __restrict__ keys, Segs sg, const Sel* __restrict__ st,
                    int64_t N, uint64_t* __restrict__ out,
                    unsigned long long* __restrict__ cnt) {
  const int q = blockIdx.y;
  const Sel s = st[q];
  if (s.done == 2) return;
  team_keys<RT>(keys + static_cast<int64_t>(q) * sg.ld, sg, q, 0, sg.nseg(), nullptr, blockIdx.x,
                gridDim.x, gridDim.x, threadIdx.x,
                GatherKey<unsigned long long>{s.prefix, s.need, s.above,
                                              out + static_cast<int64_t>(q) * N, cnt + 2 * q});
}

// Each CTA loads one `tile` of a query's N keys into shared memory and runs
// network stages there: with size 0, every stage of sizes 2..tile; else
// the strides tile / 2 .. 1 of stage `size`.
__global__ void __launch_bounds__(ST)
bitonic_tile_kernel(uint64_t* __restrict__ buf, int64_t N, int tile, int64_t size) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* s = reinterpret_cast<uint64_t*>(smem);
  const int64_t gbase = static_cast<int64_t>(blockIdx.x) * tile;
  uint64_t* row = buf + static_cast<int64_t>(blockIdx.y) * N + gbase;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) s[i] = row[i];
  __syncthreads();
  auto stage = [&](int64_t sz, int stride) {
    for (int i = threadIdx.x; i < tile / 2; i += blockDim.x)
      bitonic_pair(s, gbase, (i / stride) * 2 * stride + (i % stride), stride, sz);
    __syncthreads();
  };
  if (size == 0) {
    for (int sz = 2; sz <= tile; sz <<= 1)
      for (int stride = sz >> 1; stride > 0; stride >>= 1) stage(sz, stride);
  } else {
    for (int stride = tile >> 1; stride > 0; stride >>= 1) stage(size, stride);
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x) row[i] = s[i];
}

// One stage stride >= SORT_TILE of the network, in device memory.
__global__ void bitonic_global_kernel(uint64_t* __restrict__ buf, int B, int64_t N,
                                      int64_t size, int64_t stride) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<int64_t>(B) * (N / 2)) return;
  const int64_t q = e / (N / 2), i = e % (N / 2);
  const int64_t lo = (i / stride) * 2 * stride + (i % stride);
  uint64_t* row = buf + q * N;
  const uint64_t a = row[lo], b = row[lo + stride];
  const bool desc = (lo & size) == 0;
  if (desc ? (a < b) : (a > b)) { row[lo] = b; row[lo + stride] = a; }
}

// The first k of a query's sorted keys as scores and ids (write_sorted),
// for the queries the fused kernel left.
__global__ void __launch_bounds__(RT)
select_write_kernel(const uint64_t* __restrict__ sorted, int64_t N, int k, int unfinal,
                    const Sel* __restrict__ st, float* __restrict__ out_s,
                    int* __restrict__ out_i) {
  const int q = blockIdx.x;
  if (st[q].done == 2) return;                 // the whole CTA
  write_sorted(sorted + static_cast<int64_t>(q) * N, N, k, unfinal, out_s, out_i);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

// A call's plan, from the wrapper (kernels/topk_score.py::chunk_plan): upc
// 64-row units a chunk, UPC for the chunk kernel or 1 for the unit kernel;
// S segments a query (an item, segment x of a query tile, walks chunks x, x
// + S, ...; in list mode it owns segment x of each query's row of keys);
// G, the chunk kernel's persistent CTAs (the unit kernel launches one CTA
// an item and UCQ queries, whatever G says); and QN, the chunk kernel's
// queries a tile (CQ, or 1 or 8 for dense rows).
struct Plan {
  int upc, S, G, qn;
  int rows() const { return UNIT * upc; }
};

// The chunk or unit kernel's launch: S segments a query, G CTAs and QN
// queries a tile (the chunk kernel); in list mode `counts` takes B x S
// listed counts.
struct ChunkLaunch {
  int S, G;
  int64_t ldq;
  uint64_t* cand;
  int* counts;
  int qn;
};

template <typename T, bool VEC, bool LIST, typename Src, int QN = CQ>
cudaError_t launch_chunks(const Src& src, const float* Q, int m, int B, int k, int nchunks,
                          const ChunkLaunch& cl, cudaStream_t stream) {
  auto kern = topk_chunk_kernel<T, VEC, LIST, Src, QN>;
  const size_t smem = QN == CQ ? chunk_smem<T, LIST>(m) : narrow_smem<T, LIST, QN>(m);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<cl.G, CT, smem, stream>>>(src, Q, m, B, k, nchunks, cl.S, cl.ldq, cl.cand, cl.counts);
  return cudaGetLastError();
}

template <typename T, bool VEC, bool LIST, typename Src>
cudaError_t launch_units(const Src& src, const float* Q, int m, int B, int k, int nchunks,
                         const ChunkLaunch& cl, cudaStream_t stream) {
  auto kern = topk_unit_kernel<T, VEC, LIST, Src>;
  const size_t smem = unit_smem<T>(m);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(cl.S, (B + UCQ - 1) / UCQ);
  kern<<<grid, UT, smem, stream>>>(src, Q, m, B, k, nchunks, cl.ldq, cl.cand, cl.counts);
  return cudaGetLastError();
}

// The chunk kernel at the plan's tile width: 1 or 8 queries for dense
// rows, else CQ.
template <typename T, bool VEC, bool LIST, typename Src>
cudaError_t launch_width(const Src& src, const float* Q, int m, int B, int k, int nchunks,
                         const ChunkLaunch& cl, cudaStream_t s) {
  if constexpr (std::is_same<Src, DenseSrc<T>>::value) {
    if (cl.qn == 1) return launch_chunks<T, VEC, LIST, Src, 1>(src, Q, m, B, k, nchunks, cl, s);
    if (cl.qn == 8) return launch_chunks<T, VEC, LIST, Src, 8>(src, Q, m, B, k, nchunks, cl, s);
  }
  if (cl.qn != CQ) return cudaErrorInvalidValue;
  return launch_chunks<T, VEC, LIST, Src>(src, Q, m, B, k, nchunks, cl, s);
}

// The plan's kernel: the chunk kernel (upc == UPC) or the unit kernel.
template <typename T, typename Src>
cudaError_t dispatch_chunks(bool vec, bool list, int upc, const Src& src, const float* Q, int m,
                            int B, int k, int nchunks, const ChunkLaunch& cl, cudaStream_t s) {
  if (upc != UPC) {
    if (vec) return list ? launch_units<T, true, true>(src, Q, m, B, k, nchunks, cl, s)
                         : launch_units<T, true, false>(src, Q, m, B, k, nchunks, cl, s);
    return list ? launch_units<T, false, true>(src, Q, m, B, k, nchunks, cl, s)
                : launch_units<T, false, false>(src, Q, m, B, k, nchunks, cl, s);
  }
  if (vec) return list ? launch_width<T, true, true>(src, Q, m, B, k, nchunks, cl, s)
                       : launch_width<T, true, false>(src, Q, m, B, k, nchunks, cl, s);
  return list ? launch_width<T, false, true>(src, Q, m, B, k, nchunks, cl, s)
              : launch_width<T, false, false>(src, Q, m, B, k, nchunks, cl, s);
}

int merge_group(int k) { return MERGE_SMALL / k; }

// Keys of scratch for the merges of L lists of k keys for B queries.
int64_t merge_words(int64_t L, int k, int B) {
  const int G = merge_group(k);
  return static_cast<int64_t>(B) * L * k + static_cast<int64_t>(B) * ((L + G - 1) / G) * k;
}

// The merge levels after a first kernel left L lists of k keys per query in
// `a`: one launch per level, alternating between a and b, until one list is
// left; the last level writes scores and ids.
int run_merges(int L, int B, int k, uint64_t* a, uint64_t* b, float* os, int* oi,
               int unfinal, cudaStream_t s, int* launched) {
  const int G = merge_group(k);
  uint64_t* src = a;
  uint64_t* dst = b;
  while (true) {
    const int Lout = (L + G - 1) / G;
    const bool last = Lout == 1;
    const dim3 grid((Lout + MT / 32 - 1) / (MT / 32), B);
    topk_merge_kernel<<<grid, MT, 0, s>>>(src, L, k, G, Lout, last ? nullptr : dst, os, oi,
                                          unfinal);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launched;
    if (last) return 0;
    L = Lout;
    uint64_t* t = src;
    src = dst;
    dst = t;
  }
}

// The select's scratch for B queries of at most L keys at k: the sorted
// rows of the multi-CTA path (N keys each, N the power of two at or above
// min(k, L) + SLACK), the histograms, the per-query state and the gather's
// counters; with `groups` (two levels) each group's k keys and its count.
struct SelLayout {
  int64_t N, words;
};
SelLayout sel_layout(int64_t L, int k, int B, int groups = 0) {
  const int64_t k_eff = k < L ? k : L;
  int64_t N = 1;
  while (N < k_eff + SLACK) N <<= 1;
  const int64_t parts = groups > 1 ? static_cast<int64_t>(B) * groups : 0;
  const int64_t words = static_cast<int64_t>(B) * N + static_cast<int64_t>(B) * RBINS / 2 +
                        static_cast<int64_t>(B) * (sizeof(Sel) / 8) + 2 * static_cast<int64_t>(B) +
                        parts * k + (parts + 1) / 2;
  return {N, words};
}

// The two-level select's room: the keys a digit pass may leave to the sort
// (at least k, a power of two, at most FN).
int two_level_room(int k) {
  int room = 1024;
  while (room < 2 * k && room < FN) room <<= 1;
  return room;
}

// Whether `groups` groups of a query's segments suit the two-level select:
// 2 <= groups <= nseg, k <= FN, groups k <= FCAP, and every group's
// segments hold at most FCAP keys (sg's capacities), so each group and the
// second level finish in the fused kernel.
bool two_level_ok(const Segs& sg, int k, int groups) {
  const int nseg = sg.nseg();
  if (groups < 2 || groups > nseg || k > FN || static_cast<int64_t>(groups) * k > FCAP)
    return false;
  for (int g = 0; g < groups; ++g) {
    long long cap = 0;
    for (int s = static_cast<int>(static_cast<int64_t>(g) * nseg / groups);
         s < static_cast<int>(static_cast<int64_t>(g + 1) * nseg / groups); ++s)
      cap += s < sg.S ? static_cast<long long>(sg.qn + (s < sg.rn ? 1 : 0)) * sg.unit : sg.extra;
    if (cap > FCAP) return false;
  }
  return true;
}

// Top k of each query's live keys (keys: B rows of sg.ld keys in segments,
// at most L live a query; descending (score, id) order as encode_key makes
// them) into out_s / out_i; `work` holds sel_layout(L, k, B, groups).words
// keys. The fused kernel takes every query it can; the multi-CTA kernels
// are launched only when some query could be left to them. With `groups`
// (the host's plan where B queries would leave most SMs idle: two_level_ok)
// the select takes two levels of the fused kernel: B x groups CTAs each keep
// the top k of a group of a query's segments, then one CTA a query keeps
// the top k of its groups' G k keys. That is exact: the top k of a union
// are the top k of its groups' top-k sets under the one key order.
int run_select(const uint64_t* keys, const Segs& sg, int B, int64_t L, int k, int unfinal,
               uint64_t* work, float* os, int* oi, cudaStream_t s, int* launched,
               int groups = 0) {
  if (sg.nseg() > MAX_SEG || (groups > 1 && !two_level_ok(sg, k, groups)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool two = groups > 1;
  const SelLayout lay = sel_layout(L, k, B, two ? groups : 0);
  const int64_t N = lay.N;
  uint64_t* sorted = work;
  auto* hist = reinterpret_cast<unsigned*>(sorted + static_cast<int64_t>(B) * N);
  auto* sel = reinterpret_cast<Sel*>(hist + static_cast<int64_t>(B) * RBINS);
  auto* cnt = reinterpret_cast<unsigned long long*>(sel + B);
  auto* part = reinterpret_cast<uint64_t*>(cnt + 2 * static_cast<int64_t>(B));
  auto* part_cnt = reinterpret_cast<int*>(part + (two ? static_cast<int64_t>(B) * groups * k : 0));
  const bool multi = !two && (L > FCAP || (k < L ? k : L) > FN);
  cudaError_t err = multi ? cudaMemsetAsync(work, 0, lay.words * 8, s) : cudaSuccess;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(select_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               FN * static_cast<int>(sizeof(uint64_t)));
  if (err != cudaSuccess) return static_cast<int>(err);
  auto check = [&]() {
    err = cudaGetLastError();
    if (err == cudaSuccess) ++*launched;
    return err == cudaSuccess;
  };
  if (two) {
    const int room = two_level_room(k);
    select_fused_kernel<<<dim3(B, groups), FT, FN * sizeof(uint64_t), s>>>(
        keys, sg, k, unfinal, room, sel, nullptr, nullptr, part, part_cnt);
    if (!check()) return static_cast<int>(err);
    const Segs top{part_cnt, static_cast<int64_t>(groups) * k, k, groups, 1, 0, 0};
    select_fused_kernel<<<B, FT, FN * sizeof(uint64_t), s>>>(part, top, k, unfinal, room, sel,
                                                             os, oi, nullptr, nullptr);
    return check() ? 0 : static_cast<int>(err);
  }
  select_fused_kernel<<<B, FT, FN * sizeof(uint64_t), s>>>(keys, sg, k, unfinal, FN, sel, os, oi,
                                                           nullptr, nullptr);
  if (!check()) return static_cast<int>(err);
  if (!multi) return 0;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t want = (L + RT * 4 - 1) / (RT * 4);
  const int64_t fill = (8LL * sms + B - 1) / B;
  const int bpq = static_cast<int>(want < fill ? (want < 1 ? 1 : want) : fill);
  for (int p = 0; p < NPASS; ++p) {
    radix_hist_kernel<<<dim3(bpq, B), RT, 0, s>>>(keys, sg, p, sel, hist);
    if (!check()) return static_cast<int>(err);
    radix_pick_kernel<<<B, 32, 0, s>>>(sel, hist, p, N);
    if (!check()) return static_cast<int>(err);
  }
  radix_gather_kernel<<<dim3(bpq, B), RT, 0, s>>>(keys, sg, sel, N, sorted, cnt);
  if (!check()) return static_cast<int>(err);
  const int tile = static_cast<int>(N < SORT_TILE ? N : SORT_TILE);
  const int tsmem = tile * static_cast<int>(sizeof(uint64_t));
  err = cudaFuncSetAttribute(bitonic_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             tsmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bitonic_tile_kernel<<<dim3(static_cast<unsigned>(N / tile), B), ST, tsmem, s>>>(sorted, N, tile, 0);
  if (!check()) return static_cast<int>(err);
  for (int64_t size = 2LL * tile; size <= N; size <<= 1) {
    for (int64_t stride = size >> 1; stride >= tile; stride >>= 1) {
      const int64_t pairs = static_cast<int64_t>(B) * (N / 2);
      bitonic_global_kernel<<<static_cast<unsigned>((pairs + 255) / 256), 256, 0, s>>>(
          sorted, B, N, size, stride);
      if (!check()) return static_cast<int>(err);
    }
    bitonic_tile_kernel<<<dim3(static_cast<unsigned>(N / tile), B), ST, tsmem, s>>>(sorted, N, tile, size);
    if (!check()) return static_cast<int>(err);
  }
  select_write_kernel<<<B, RT, 0, s>>>(sorted, N, k, unfinal, sel, os, oi);
  if (!check()) return static_cast<int>(err);
  return 0;
}

// Chunks of upc units of a paged walk over `slots` slots of R rows, and its
// geometry (kernels/topk_score.py::paged_chunks counts the same chunks).
struct PagedGeom {
  int U, ppc, cpp;
  int64_t nchunks;
};
PagedGeom paged_geom(int64_t slots, int R, int upc) {
  PagedGeom g;
  g.U = (R + UNIT - 1) / UNIT;
  if (g.U <= upc) {
    g.ppc = upc / g.U;
    g.cpp = 1;
    g.nchunks = (slots + g.ppc - 1) / g.ppc;
  } else {
    g.ppc = 1;
    g.cpp = (g.U + upc - 1) / upc;
    g.nchunks = slots * g.cpp;
  }
  return g;
}

// Words of the unit table (a Unit is three 8-byte words), the fold states
// (one int2 a chunk) and, for a range read on the device, its live chunks.
int64_t unit_words(int64_t nchunks, int upc, int dev) {
  return nchunks * upc * (sizeof(Unit) / 8) + nchunks + (dev ? 1 : 0);
}

// Words of the list-mode counts: B x nchunks ints (S <= nchunks).
int64_t count_words(int64_t nchunks, int B) { return (static_cast<int64_t>(B) * nchunks + 1) / 2; }

// Words of scratch after the unit table for B queries of nchunks chunks of
// `rows` rows (and a carry): per-chunk candidate lists and merges for k <=
// SMALL_K; else room for every row's key and the carry's, the listed counts
// (one int a CTA, at most one CTA a chunk) and the select (with `groups`,
// two levels).
int64_t key_words(int64_t nchunks, int rows, int carry, int k, int B, int groups = 0) {
  if (k <= SMALL_K) return merge_words(nchunks + carry, k, B);
  const int64_t L = nchunks * rows + (carry ? k : 0);
  return static_cast<int64_t>(B) * L + count_words(nchunks, B) + sel_layout(L, k, B, groups).words;
}

// The list mode's segments (S a query over nchunks chunks of `rows` rows,
// a carry of `extra` keys after them) for the select.
Segs list_segs(const int* counts, int64_t ldq, int nchunks, int rows, int S, int extra) {
  return Segs{counts, ldq, rows, S, S > 0 ? nchunks / S : 0, S > 0 ? nchunks % S : 0, extra};
}

// A plan the kernels take for B queries: upc UPC or 1, 1 <= S <= nchunks (0
// when there is no chunk), and for the chunk kernel a tile of QN in {1, 8,
// CQ} queries (1 and 8: dense calls only) and 1 <= G <= S x tiles.
bool plan_ok(const Plan& p, int64_t nchunks, int B) {
  if (p.qn != CQ && !(p.upc == UPC && (p.qn == 1 || p.qn == 8))) return false;
  const int64_t items = static_cast<int64_t>(p.S) * ((B + p.qn - 1) / p.qn);
  return (p.upc == UPC || p.upc == 1) && p.S >= (nchunks > 0 ? 1 : 0) && p.S <= nchunks &&
         (p.upc != UPC || nchunks == 0 || (p.G >= 1 && p.G <= items));
}

template <typename T>
int dense_call(const void* D, const float* q, const int* ids, int64_t n, int m, int B,
               int64_t n_valid, const int* n_valid_dev, int k, bool vec, const Plan& plan,
               int groups, uint64_t* scratch, float* os, int* oi, cudaStream_t s,
               int* launched) {
  const int rows = plan.rows();
  const int nchunks = static_cast<int>((n + rows - 1) / rows);
  if (!plan_ok(plan, nchunks, B)) return static_cast<int>(cudaErrorInvalidValue);
  const DenseSrc<T> src{static_cast<const T*>(D), ids, n, n_valid, m, n_valid_dev};
  const bool list = k > SMALL_K;
  const int64_t ldq = list ? static_cast<int64_t>(nchunks) * rows
                           : static_cast<int64_t>(nchunks) * k;
  int* counts = reinterpret_cast<int*>(scratch + static_cast<int64_t>(B) * ldq);
  const Segs segs = list_segs(counts, ldq, nchunks, rows, plan.S, 0);
  if (groups != 0 && !(list && two_level_ok(segs, k, groups)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = dispatch_chunks<T>(vec, list, plan.upc, src, q, m, B, k, nchunks,
                                       ChunkLaunch{plan.S, plan.G, ldq, scratch, counts, plan.qn},
                                       s);
  if (err != cudaSuccess) return static_cast<int>(err);
  ++*launched;
  if (list)
    return run_select(scratch, segs, B, ldq, k, 0,
                      scratch + static_cast<int64_t>(B) * ldq + count_words(nchunks, B), os, oi,
                      s, launched, groups);
  return run_merges(nchunks, B, k, scratch, scratch + static_cast<int64_t>(B) * ldq, os, oi, 0,
                    s, launched);
}

template <typename T>
int paged_call(const void* pool, const void* tail, const int* table, const int* nvalid,
               const int* offset, const float* scale, const int* ids_pool, const float* q,
               const float* cs, const int* ci, int pool_pages, int tail_pages, int R, int m,
               int B, int lo, int hi, const int* lo_dev, const int* hi_dev, int k, bool vec,
               int unfinal, const Plan& plan, uint64_t* scratch, float* os, int* oi,
               cudaStream_t s, int* launched) {
  const int64_t slots = hi > lo ? hi - lo : 0;
  const int upc = plan.upc, rows = plan.rows(), S = plan.S;
  const PagedGeom g = paged_geom(slots, R, upc);
  const int nchunks = static_cast<int>(g.nchunks);
  if (!plan_ok(plan, nchunks, B)) return static_cast<int>(cudaErrorInvalidValue);
  const bool carry = cs != nullptr;
  const bool dev = lo_dev != nullptr;
  auto* units = reinterpret_cast<Unit*>(scratch);
  auto* fold = reinterpret_cast<int2*>(units + static_cast<int64_t>(nchunks) * upc);
  int* live = dev ? reinterpret_cast<int*>(fold + nchunks) : nullptr;
  uint64_t* cand = scratch + unit_words(nchunks, upc, dev);
  const bool list = k > SMALL_K;
  const int64_t ldq = list ? static_cast<int64_t>(nchunks) * rows + (carry ? k : 0)
                           : static_cast<int64_t>(nchunks + (carry ? 1 : 0)) * k;
  int* counts = reinterpret_cast<int*>(cand + static_cast<int64_t>(B) * ldq);
  const ChunkLaunch cl{S, plan.G, ldq, cand, counts, CQ};
  cudaError_t err = cudaSuccess;
  if (nchunks > 0) {
    const int nunits = nchunks * upc;
    paged_units_kernel<T><<<(nunits + 255) / 256, 256, 0, s>>>(
        static_cast<const T*>(pool), static_cast<const T*>(tail), table, nvalid, offset,
        pool_pages, tail_pages, R, m, lo, hi, lo_dev, hi_dev, g.U, g.ppc, g.cpp, upc,
        ids_pool != nullptr, nunits, units, live);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launched;
    if (scale != nullptr) {
      const int64_t threads = static_cast<int64_t>(nchunks) * 32;
      paged_fold_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, s>>>(
          units, scale, m, nchunks, upc, live, S, fold);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      ++*launched;
      err = dispatch_chunks<T>(vec, list, upc,
                               PagedSrc<T, true>{units, ids_pool, scale, fold, R, m, live}, q, m,
                               B, k, nchunks, cl, s);
    } else {
      err = dispatch_chunks<T>(vec, list, upc,
                               PagedSrc<T, false>{units, ids_pool, nullptr, nullptr, R, m, live},
                               q, m, B, k, nchunks, cl, s);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launched;
  }
  if (carry) {
    const int64_t total = static_cast<int64_t>(B) * k;
    const int64_t off = list ? static_cast<int64_t>(nchunks) * rows : static_cast<int64_t>(nchunks) * k;
    carry_keys_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(cs, ci, B, k, ldq,
                                                                               off, cand);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launched;
  }
  if (list)
    return run_select(cand, list_segs(counts, ldq, nchunks, rows, S, carry ? k : 0), B, ldq, k,
                      unfinal, cand + static_cast<int64_t>(B) * ldq + count_words(nchunks, B),
                      os, oi, s, launched);
  return run_merges(nchunks + (carry ? 1 : 0), B, k, cand, cand + static_cast<int64_t>(B) * ldq,
                    os, oi, unfinal, s, launched);
}

}  // namespace

// Scratch of a dense call over n rows at k for B queries in chunks of upc
// 64-row units, its select in `groups` groups a query (0: one level; the
// plan's): out[0] = 8-byte words, out[1] = 1 when the call takes the radix
// select (k > 32).
extern "C" int topk_plan(int64_t n, int k, int B, int upc, int groups, int64_t* out) {
  if (n < 1 || k < 1 || B < 1 || (upc != UPC && upc != 1) || groups < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = UNIT * upc;
  out[0] = key_words((n + rows - 1) / rows, rows, 0, k, B, groups);
  out[1] = k > SMALL_K;
  return 0;
}

// D (n, m) in dtype 0 = f32, 1 = bf16, 2 = int8; Q (B, m) f32; row_ids
// (n,) int32 or null. The live count is n_valid_dev[0] (one int32 on the
// device, clamped to [0, n] by the kernel) when that pointer is set, else
// the host value n_valid. scratch holds topk_plan's words. Writes out_s
// (B, k) f32 and out_i (B, k) int32. `vec` asserts m % 16 == 0 and a
// 16-byte aligned D. *launched counts the kernel launches made. upc, segs,
// ctas and qn are the call's plan (kernels/topk_score.py::chunk_plan):
// chunks of upc 64-row units (8: the chunk kernel, 1: the unit kernel),
// segs segments a query, ctas persistent CTAs and qn queries a tile (1, 8
// or 32) of the chunk kernel; groups > 1 takes the two-level select
// (kernels/topk_score.py::select_groups), 0 one level. Returns the first
// cudaError_t.
extern "C" int topk_score_f32(const void* D, const void* Q, const void* row_ids, int64_t n,
                              int m, int B, int64_t n_valid, const void* n_valid_dev, int k,
                              int dtype, int vec, void* scratch, void* out_s, void* out_i,
                              void* stream, int* launched, int upc, int segs, int ctas, int qn,
                              int groups) {
  auto s = static_cast<cudaStream_t>(stream);
  auto q = static_cast<const float*>(Q);
  auto ids = static_cast<const int*>(row_ids);
  auto nvd = static_cast<const int*>(n_valid_dev);
  auto* sc = static_cast<uint64_t*>(scratch);
  auto* os = static_cast<float*>(out_s);
  auto* oi = static_cast<int*>(out_i);
  *launched = 0;
  if (n < 1 || (n + UNIT - 1) / UNIT > 0x7FFFFFFF || k < 1 || B < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan plan{upc, segs, ctas, qn};
#define DENSE(T) \
  dense_call<T>(D, q, ids, n, m, B, n_valid, nvd, k, vec, plan, groups, sc, os, oi, s, launched)
  if (dtype == 0) return DENSE(float);
  if (dtype == 1) return DENSE(__nv_bfloat16);
  if (dtype == 2) return DENSE(int8_t);
#undef DENSE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Scratch of a paged call over `slots` page slots of R rows (plus a carry
// when `carry` is set; with `dev`, a range read on the device within those
// slots) at k for B queries in chunks of upc units (the plan's): out[0] =
// 8-byte words, out[1] = 1 when the call takes the radix select.
extern "C" int topk_paged_plan(int64_t slots, int R, int k, int carry, int dev, int B, int upc,
                               int64_t* out) {
  if (slots < 0 || R < 1 || k < 1 || B < 1 || (upc != UPC && upc != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const PagedGeom g = paged_geom(slots, R, upc);
  if (g.nchunks * upc > 0x7FFFFFFF || (g.nchunks == 0 && !carry))
    return static_cast<int>(cudaErrorInvalidValue);
  out[0] = unit_words(g.nchunks, upc, dev) + key_words(g.nchunks, UNIT * upc, carry, k, B);
  out[1] = k > SMALL_K;
  return 0;
}

// Exact top-k over logical page slots [lo, hi) of a page table; with
// lo_dev and hi_dev (one int32 each on the device, or both null) over
// [*lo_dev, *hi_dev) clamped to [lo, hi), which then plans the call (lo 0
// and hi the table's capacity): the host never reads the range, so a CUDA
// graph captured once replays as the index grows. An empty range gives
// the pads.
// pool (pool_pages, R, m) and tail (tail_pages, R, m, or null) in dtype
// 0 = f32, 1 = bf16, 2 = int8; table, nvalid, offset (>= hi,) int32;
// scale (>= hi, m) f32 or null; ids_pool (>= hi, R) int32 or null; Q (B, m)
// f32; carry_s / carry_i (B, k) or null. scratch holds topk_paged_plan's
// words (dev = 1 with the device range). Writes out_s (B, k) f32 and
// out_i (B, k) int32; -inf slots get id -1 with `finalize`, else their
// rank among pads as -(j - c + 2). `vec` asserts m % 16 == 0 and 16-byte
// aligned pool, tail and scale. *launched counts the kernel launches
// made. upc, segs and ctas are the call's plan, as topk_score_f32's. Returns the
// first cudaError_t.
extern "C" int topk_score_paged_f32(
    const void* pool, const void* tail, const void* table, const void* nvalid,
    const void* offset, const void* scale, const void* ids_pool, const void* Q,
    const void* carry_s, const void* carry_i, int pool_pages, int tail_pages,
    int R, int m, int B, int lo, int hi, const void* lo_dev, const void* hi_dev, int k,
    int dtype, int vec, int finalize, void* scratch, void* out_s, void* out_i, void* stream,
    int* launched, int upc, int segs, int ctas) {
  auto s = static_cast<cudaStream_t>(stream);
  *launched = 0;
  const bool carry = carry_s != nullptr;
  if (k < 1 || B < 1 || B > 65535 || R < 1 || m < 1 || lo < 0 ||
      (hi <= lo && !carry) || (carry && carry_i == nullptr) ||
      ((lo_dev == nullptr) != (hi_dev == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto tb = static_cast<const int*>(table);
  auto nv = static_cast<const int*>(nvalid);
  auto off = static_cast<const int*>(offset);
  auto sc = static_cast<const float*>(scale);
  auto ip = static_cast<const int*>(ids_pool);
  auto q = static_cast<const float*>(Q);
  auto cs = static_cast<const float*>(carry_s);
  auto ci = static_cast<const int*>(carry_i);
  auto lod = static_cast<const int*>(lo_dev);
  auto hid = static_cast<const int*>(hi_dev);
  auto* w = static_cast<uint64_t*>(scratch);
  auto* os = static_cast<float*>(out_s);
  auto* oi = static_cast<int*>(out_i);
  const int unfinal = finalize ? 0 : 1;
  const Plan plan{upc, segs, ctas, CQ};
#define PAGED(T) paged_call<T>(pool, tail, tb, nv, off, sc, ip, q, cs, ci, pool_pages, tail_pages, \
                               R, m, B, lo, hi, lod, hid, k, vec, unfinal, plan, w, os, oi, s, \
                               launched)
  if (dtype == 0) return PAGED(float);
  if (dtype == 1) return PAGED(__nv_bfloat16);
  if (dtype == 2) return PAGED(int8_t);
#undef PAGED
  return static_cast<int>(cudaErrorInvalidValue);
}

// Scratch of topk_select_keys for B rows of L keys at k: out[0] = words.
extern "C" int topk_select_plan(int64_t L, int k, int B, int64_t* out) {
  if (L < 1 || k < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = sel_layout(L, k, B).words;
  return 0;
}

// The top k of each of B rows of L 64-bit keys (encode_key's order: score
// desc, id asc), as the large-k path selects them: scores and ids into
// out_s / out_i (B, k), pads as the merge writes them. With `counts` (B
// int32 on the device, or null) only the first counts[b] keys of row b are
// live (clamped to [0, L]): the rest are not read. scratch holds
// topk_select_plan's words. *launched counts the launches.
extern "C" int topk_select_keys(const void* keys, const void* counts, int B, int64_t L, int k,
                                int finalize, void* scratch, void* out_s, void* out_i,
                                void* stream, int* launched) {
  *launched = 0;
  if (L < 1 || k < 1 || B < 1 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Segs sg{static_cast<const int*>(counts), L, L, 1, 1, 0, 0};
  return run_select(static_cast<const uint64_t*>(keys), sg, B, L, k, finalize ? 0 : 1,
                    static_cast<uint64_t*>(scratch), static_cast<float*>(out_s),
                    static_cast<int*>(out_i), static_cast<cudaStream_t>(stream), launched);
}

namespace {

template <typename T, bool LIST>
int chunk_dyn_smem(int m) { return static_cast<int>(chunk_smem<T, LIST>(m)); }
int sort_tile_smem(int) { return SORT_TILE * static_cast<int>(sizeof(uint64_t)); }
int fused_smem(int) { return FN * static_cast<int>(sizeof(uint64_t)); }

#define CHUNK4(T, TN, S, SN)                                                               \
  {"topk_chunk_kernel<" TN ",vec,keep," SN ">",                                            \
   reinterpret_cast<const void*>(topk_chunk_kernel<T, true, false, S>), CT, chunk_dyn_smem<T, false>}, \
  {"topk_chunk_kernel<" TN ",vec,list," SN ">",                                            \
   reinterpret_cast<const void*>(topk_chunk_kernel<T, true, true, S>), CT, chunk_dyn_smem<T, true>}, \
  {"topk_chunk_kernel<" TN ",scalar,keep," SN ">",                                         \
   reinterpret_cast<const void*>(topk_chunk_kernel<T, false, false, S>), CT, chunk_dyn_smem<T, false>}, \
  {"topk_chunk_kernel<" TN ",scalar,list," SN ">",                                         \
   reinterpret_cast<const void*>(topk_chunk_kernel<T, false, true, S>), CT, chunk_dyn_smem<T, true>}
template <typename T>
using PagedPlain = PagedSrc<T, false>;
template <typename T>
using PagedScaled = PagedSrc<T, true>;
template <typename T, bool LIST, int QN>
int narrow_dyn_smem(int m) { return static_cast<int>(narrow_smem<T, LIST, QN>(m)); }
#define NARROW4(T, TN, QN)                                                                 \
  {"topk_chunk_kernel<" TN ",vec,keep,dense,qn" #QN ">",                                   \
   reinterpret_cast<const void*>(topk_chunk_kernel<T, true, false, DenseSrc<T>, QN>), CT,  \
   narrow_dyn_smem<T, false, QN>},                                                         \
  {"topk_chunk_kernel<" TN ",vec,list,dense,qn" #QN ">",                                   \
   reinterpret_cast<const void*>(topk_chunk_kernel<T, true, true, DenseSrc<T>, QN>), CT,   \
   narrow_dyn_smem<T, true, QN>},                                                          \
  {"topk_chunk_kernel<" TN ",scalar,keep,dense,qn" #QN ">",                                \
   reinterpret_cast<const void*>(topk_chunk_kernel<T, false, false, DenseSrc<T>, QN>), CT, \
   narrow_dyn_smem<T, false, QN>},                                                         \
  {"topk_chunk_kernel<" TN ",scalar,list,dense,qn" #QN ">",                                \
   reinterpret_cast<const void*>(topk_chunk_kernel<T, false, true, DenseSrc<T>, QN>), CT,  \
   narrow_dyn_smem<T, true, QN>}
#define CHUNKS(T, TN)                                                                      \
  CHUNK4(T, TN, DenseSrc<T>, "dense"), CHUNK4(T, TN, PagedPlain<T>, "paged"),             \
      CHUNK4(T, TN, PagedScaled<T>, "paged_scaled"), NARROW4(T, TN, 1), NARROW4(T, TN, 8)
template <typename T, bool LIST>
int unit_dyn_smem(int m) { return static_cast<int>(unit_smem<T>(m)); }
#define UNIT4(T, TN, S, SN)                                                                \
  {"topk_unit_kernel<" TN ",vec,keep," SN ">",                                             \
   reinterpret_cast<const void*>(topk_unit_kernel<T, true, false, S>), UT, unit_dyn_smem<T, false>}, \
  {"topk_unit_kernel<" TN ",vec,list," SN ">",                                             \
   reinterpret_cast<const void*>(topk_unit_kernel<T, true, true, S>), UT, unit_dyn_smem<T, true>}, \
  {"topk_unit_kernel<" TN ",scalar,keep," SN ">",                                          \
   reinterpret_cast<const void*>(topk_unit_kernel<T, false, false, S>), UT, unit_dyn_smem<T, false>}, \
  {"topk_unit_kernel<" TN ",scalar,list," SN ">",                                          \
   reinterpret_cast<const void*>(topk_unit_kernel<T, false, true, S>), UT, unit_dyn_smem<T, true>}
#define UNITS4(T, TN)                                                                      \
  UNIT4(T, TN, DenseSrc<T>, "dense"), UNIT4(T, TN, PagedPlain<T>, "paged"),               \
      UNIT4(T, TN, PagedScaled<T>, "paged_scaled")
#define UNITS(T, TN)                                                                       \
  {"paged_units_kernel<" TN ">", reinterpret_cast<const void*>(paged_units_kernel<T>), 256, \
   nullptr}

const KernelEntry KERNELS[] = {
    CHUNKS(float, "f32"),
    CHUNKS(__nv_bfloat16, "bf16"),
    CHUNKS(int8_t, "int8"),
    UNITS4(float, "f32"),
    UNITS4(__nv_bfloat16, "bf16"),
    UNITS4(int8_t, "int8"),
    {"topk_merge_kernel", reinterpret_cast<const void*>(topk_merge_kernel), MT, nullptr},
    {"carry_keys_kernel", reinterpret_cast<const void*>(carry_keys_kernel), 256, nullptr},
    UNITS(float, "f32"),
    UNITS(__nv_bfloat16, "bf16"),
    UNITS(int8_t, "int8"),
    {"paged_fold_kernel", reinterpret_cast<const void*>(paged_fold_kernel), 256, nullptr},
    {"radix_hist_kernel", reinterpret_cast<const void*>(radix_hist_kernel), RT, nullptr},
    {"radix_pick_kernel", reinterpret_cast<const void*>(radix_pick_kernel), 32, nullptr},
    {"radix_gather_kernel", reinterpret_cast<const void*>(radix_gather_kernel), RT, nullptr},
    {"bitonic_tile_kernel", reinterpret_cast<const void*>(bitonic_tile_kernel), ST,
     sort_tile_smem},
    {"bitonic_global_kernel", reinterpret_cast<const void*>(bitonic_global_kernel), 256,
     nullptr},
    {"select_write_kernel", reinterpret_cast<const void*>(select_write_kernel), RT, nullptr},
    {"select_fused_kernel", reinterpret_cast<const void*>(select_fused_kernel), FT,
     fused_smem},
};
#undef UNITS
#undef UNITS4
#undef UNIT4
#undef CHUNKS
#undef NARROW4
#undef CHUNK4

}  // namespace

// The resource check's view of every kernel in this file (common.cuh's
// kernel_attrs); m is the index width the chunk kernel's tile is sized for.
extern "C" int topk_score_kernel_attrs(int i, int m, const char** name, int* attrs) {
  return kernel_attrs(KERNELS, static_cast<int>(sizeof(KERNELS) / sizeof(KERNELS[0])), i, m,
                      name, attrs);
}
