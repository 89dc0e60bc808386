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
//   1. topk_chunk_kernel: one persistent CTA per SM and 32-query tile
//      walks the chunks. It keeps the query tile in shared memory, streams
//      the chunks through a cp.async ring and scores each with a
//      register-blocked fp32 product. Then, for k <= SMALL_K, each warp
//      selects per query the chunk's top k into that chunk's candidate
//      list, against a running threshold; for larger k it lists every key.
//   2. k <= SMALL_K: topk_merge_kernel, one warp per (group of lists,
//      query) keeps the top k of the group; launched again until one list
//      remains, and the last launch writes scores and ids.
//   3. k > SMALL_K: a radix select over each query's keys (radix_hist /
//      radix_pick, 11-bit digits, most significant first), a gather of the
//      keys at or above the threshold, a bitonic sort of those, and a
//      write of scores and ids. Scratch is one key per row, so any k runs.
// Every candidate is a 64-bit key that orders (score desc, id asc), so the
// result does not depend on the order chunks are visited, merged or
// selected: the lowest-id tie-break, the masks and the (-inf, -1) pads all
// follow from that one order. The TPU kernel's block-skip guard and
// lane-fold select are not carried.
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

// A slot whose score is -inf (a pad, a masked or -inf row) or that holds no
// key (0, below every key): written as (-inf, -1).
__device__ __forceinline__ bool key_is_pad(uint64_t key) {
  return static_cast<unsigned>(key >> 32) <= 0x007FFFFFu;
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

// 16 consecutive bf16 (one slab row) upcast to f32, 16-byte loads.
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

// ---------------------------------------------------------------------------
// Row sources: row r of chunk c, its id, and the scale row of a warp's rows
// ---------------------------------------------------------------------------

// A dense index: chunk c is rows [512 c, 512 c + 512) of D (n, m). Row ids
// are positions masked at n_valid, or row_ids[row] masked when negative.
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
  __device__ __forceinline__ const T* row(int chunk, int r, bool& ok) const {
    const int64_t row = static_cast<int64_t>(chunk) * CR + r;
    ok = row < n;
    return D + (ok ? row : 0) * m;
  }
  __device__ __forceinline__ void id(int chunk, int r, int& id, bool& ok) const {
    const int64_t row = static_cast<int64_t>(chunk) * CR + r;
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

// A paged walk: unit u of chunk c is units[8 c + u], built per call by
// paged_units_kernel. Row rr of a unit reports id0 + rr, or with ids_pool
// ids_pool[slot, row0 + rr] masked when negative. SCALED: fold[c] (from
// paged_fold_kernel) names the slot whose scale row every live unit of
// chunk c shares, or -1 when they differ, and whether the CTA's query tile
// already holds that fold; a chunk of mixed rows multiplies each query
// value by its warp's scale row as it is read (the warp's rows share a
// page).
template <typename T, bool SCALED_>
struct PagedSrc {
  static constexpr bool SCALED = SCALED_;
  const Unit* units;
  const int* ids_pool;
  const float* scale;
  const int2* fold;
  int R, m;
  __device__ __forceinline__ PagedSrc bound() const { return *this; }
  __device__ __forceinline__ const T* row(int chunk, int r, bool& ok) const {
    const Unit* u = units + chunk * UPC + r / UNIT;
    const int rr = r % UNIT;
    ok = rr < __ldg(&u->rows);
    return reinterpret_cast<const T*>(__ldg(&u->base)) + (ok ? rr : 0) * m;
  }
  __device__ __forceinline__ void id(int chunk, int r, int& id, bool& ok) const {
    const Unit* u = units + chunk * UPC + r / UNIT;
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

// Ring geometry of the chunk kernel. A D slab is CR rows x CK values. As
// f32 a row's four 16-byte pieces are stored in the order piece ^ ((row >>
// 1) & 3), so the 8 rows a quarter-warp reads at once fall on distinct
// banks with no padding. int8 and bf16 slabs land raw (CK values a row,
// packed) in a 32 KB ring and are upcast once into one of two f32 slabs.
constexpr int RS = CK;
constexpr int KP_MAX = 384;     // m-values of the query tile resident at once
constexpr int HQ = CQ / 2;      // queries whose scores are staged at once
constexpr int SLD = CR + 8;     // score row stride: a warp's 32 stores hit 32 banks
constexpr int RAW_RING = 32768;

template <typename T>
struct Chunk {
  static constexpr bool RAW = !std::is_same<T, float>::value;
  static constexpr int STAGE_BYTES = RAW ? CR * CK * static_cast<int>(sizeof(T)) : CR * RS * 4;
  static constexpr int STAGES = RAW ? RAW_RING / STAGE_BYTES : 4;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES + (RAW ? 2 * CR * RS * 4 : 0);
};

// Query-tile width for m: whole, rounded up to a slab, or panels of KP_MAX.
__host__ __device__ __forceinline__ int panel_width(int m) {
  const int mp = (m + CK - 1) / CK * CK;
  return mp < KP_MAX ? mp : KP_MAX;
}

// Dynamic shared memory of the chunk kernel: the query tile, half the
// tile's scores and the ring, side by side, so the ring keeps streaming
// while a chunk's keys are selected or listed.
template <typename T>
size_t chunk_smem(int m) {
  return static_cast<size_t>(CQ) * (panel_width(m) + 4) * 4 + HQ * SLD * 4 +
         Chunk<T>::RING_BYTES;
}

// Float offset of 16-byte piece c of row r in an f32 slab.
__device__ __forceinline__ int slab_at(int r, int c) { return r * RS + ((c ^ ((r >> 1) & 3)) << 2); }

// Fill ring stage `dst` with slab k0 of chunk `chunk`, in the storage
// dtype, as the stage stores it (f32: pieces placed by slab_at; raw: CK
// packed values a row). VEC: 16-byte cp.async pieces (m % 16 == 0, rows
// 16-byte aligned); else scalar loads. Out-of-range values are zero.
template <typename T, bool VEC, typename Src>
__device__ __forceinline__ void load_chunk_slab(const Src& src, T* dst, int chunk, int m,
                                                int k0, int tid) {
  constexpr bool F32 = std::is_same<T, float>::value;
  if (VEC) {
    constexpr int PER_ROW = CK * sizeof(T) / 16;
#pragma unroll
    for (int i = 0; i < CR * PER_ROW / CT; ++i) {
      const int e = tid + i * CT;
      const int r = e / PER_ROW, c = e % PER_ROW;
      bool ok;
      const T* p = src.row(chunk, r, ok);
      cp_async16(dst + (F32 ? slab_at(r, c) : r * CK + c * (16 / sizeof(T))),
                 p + k0 + c * (16 / sizeof(T)), ok);
    }
  } else {
    for (int e = tid; e < CR * CK; e += CT) {
      const int r = e / CK, kk = e % CK;
      bool ok;
      const T* p = src.row(chunk, r, ok);
      dst[F32 ? slab_at(r, kk >> 2) + (kk & 3) : r * CK + kk] =
          (ok && k0 + kk < m) ? p[k0 + kk] : T(0.f);
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

// Query tile panel [kb, kb + kp) of queries [q0, q0 + CQ), each value
// multiplied by srow[k] when a scale row is given (one rounding, as the
// dense index folds its scale); zero past B and past m. Eight loads per
// thread in flight.
__device__ __forceinline__ void load_query_panel(const float* __restrict__ Q, float* Qs,
                                                 int B, int m, int q0, int kb, int kp,
                                                 int tid, const float* srow) {
  const int qld = kp + 4, total = CQ * kp;
  for (int e0 = tid; e0 < total; e0 += 8 * CT) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * CT, q = e / kp, kk = e % kp;
      v[u] = 0.f;
      if (e < total && q0 + q < B && kb + kk < m) {
        v[u] = Q[static_cast<int64_t>(q0 + q) * m + kb + kk];
        if (srow != nullptr) v[u] = __fmul_rn(v[u], __ldg(srow + kb + kk));
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * CT;
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

// acc[i][j] += Q[4i + qg] . D[64 w + 8j + rg] over one CK-deep slab, k
// ascending: per 4-deep step, 8 query and 8 row 16-byte pieces for 256 FMAs.
// SCALED and `fold`: each query value is first multiplied by srow[k] (one
// rounding, as the dense index folds its scale into the query), srow being
// the scale row of the warp's page and k0 the slab's first m-position.
template <bool SCALED, bool VEC>
__device__ __forceinline__ void slab_fma(const float* Qs, int qld, const float* Ds,
                                         float (&acc)[8][8], int w, int qg, int rg,
                                         bool fold, const float* srow, int k0, int m) {
  const float* qb = Qs + qg * qld;
  const float* db = Ds + (w * 64 + rg) * RS;
  const int swz = (rg >> 1) & 3;          // slab_at's order for rows 64 w + 8 j + rg
#pragma unroll
  for (int k4 = 0; k4 < CK; k4 += 4) {
    float4 q[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) q[i] = *reinterpret_cast<const float4*>(qb + 4 * i * qld + k4);
    if (SCALED && fold) {
      const float4 s = load_scale4<VEC>(srow, k0 + k4, m);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        q[i].x = __fmul_rn(q[i].x, s.x);
        q[i].y = __fmul_rn(q[i].y, s.y);
        q[i].z = __fmul_rn(q[i].z, s.z);
        q[i].w = __fmul_rn(q[i].w, s.w);
      }
    }
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

// Stage scores of queries [16 h, 16 h + 16) of the tile, from acc, into Ss.
__device__ __forceinline__ void stage_scores(const float (&acc)[8][8], float* Ss, int h,
                                             int warp, int qg, int rg) {
#pragma unroll
  for (int i = 4 * h; i < 4 * h + 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      Ss[(4 * i + qg - HQ * h) * SLD + warp * 64 + 8 * j + rg] = acc[i][j];
}

// The chunk's keys per query, from the scores in acc; then acc is zeroed.
// Scores go through shared memory half a tile at a time; warp w takes
// queries 16h + 2w + {0, 1} of half h, so it keeps the same four queries
// across chunks. LIST: every row's key (masked rows as PAD_KEY) goes to
// the query's row of keys at chunk * CR. Else (k <= SMALL_K) the chunk's
// top k goes to its candidate list, against a running threshold: run[s]
// holds, lane j, the j-th best key this CTA listed for query slot s, and a
// key below lane k - 1's cannot reach the final top k (k keys above it are
// already listed), so it is listed as a pad. The final result does not
// change; a chunk's select shrinks to the keys that still matter.
template <bool LIST, typename Src>
__device__ __forceinline__ void chunk_keys(float (&acc)[8][8], float* Ss, uint64_t (&run)[4],
                                           const Src& src, int B, int q0, int k, int chunk,
                                           int64_t ldq, uint64_t* __restrict__ cand, int tid) {
  const int warp = tid / 32, lane = tid % 32, qg = lane / 8, rg = lane % 8;
  // lane holds rows lane + 32 t of the chunk
  int ids[CR / 32];
  bool ok[CR / 32];
#pragma unroll
  for (int t = 0; t < CR / 32; ++t) src.id(chunk, lane + 32 * t, ids[t], ok[t]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (h) __syncthreads();            // half 0's scores are read
    stage_scores(acc, Ss, h, warp, qg, rg);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int q = HQ * h + 2 * warp + u;
      if (q0 + q >= B) break;
      const float* srow = Ss + (2 * warp + u) * SLD;
      if constexpr (LIST) {
        uint64_t* dst = cand + static_cast<int64_t>(q0 + q) * ldq + static_cast<int64_t>(chunk) * CR;
#pragma unroll
        for (int t = 0; t < CR / 32; ++t)
          dst[lane + 32 * t] = ok[t] ? encode_key(srow[lane + 32 * t], ids[t]) : PAD_KEY;
      } else {
        uint64_t& rs = run[2 * h + u];
        uint64_t* dst = cand + static_cast<int64_t>(q0 + q) * ldq + static_cast<int64_t>(chunk) * k;
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
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// Persistent: CTA (x, y) walks chunks x, x + gridDim.x, ... of the
// 32-query tile y, reading rows through the row source.
//
// What bounds it on an H100: an f32 index is about even between bytes (n m
// 4 over 3.35 TB/s) and fp32 FMAs (2 B n m over 67 TFLOP/s); int8 moves a
// quarter of the bytes and is bound by the FMAs. Reaching either needs the
// query tile kept on chip, loads in flight during the FMAs, and few
// shared-memory wavefronts per FMA.
//
// This design loads the 32 x m query tile into shared memory once per CTA
// (in panels of 384 values when m is larger, reloaded per chunk) and
// streams D through a ring: 4 f32 stages, or raw int8 / bf16 stages upcast
// once per element into one of two f32 slabs (int8 by a byte permute and
// an exact add, not the conversion pipe), with one barrier per slab and
// later slabs in flight, also across a chunk's select. The select keeps a
// running top k per query, so after the first chunks it lists few keys.
// Rows land as they lie in memory. A warp owns 32 queries x 64 rows, a
// thread 8 queries x 8 rows with lanes 4 x 8, reading both operands along
// m in 16-byte pieces: a quarter-warp reads one query piece (2 wavefronts
// per warp-wide load) or 8 row pieces on distinct banks (4), so 48
// wavefronts per 256 FMAs. One CTA fills an SM. What is left between this
// and the bound is shared memory: those wavefronts, and for int8 the
// upcast's f32 stores, keep it busy for most of the FMA time, and one CTA
// per SM hides little of it.
//
// A paged source adds per load one read of its unit (8 a chunk, L1-hot).
// With scale rows the resident tile holds the query folded with the scale
// row the chunk's pages share, reloaded from Q (in L2) only where that row
// changes along the CTA's walk; a chunk whose pages have differing rows
// folds at read time instead (32 multiplies per 256 FMAs and a 16-byte
// scale read per 4-deep step; the warp's 64 rows are one unit of one page).
//
// Invariant: every score is one fp32 fmaf chain over m in ascending order
// from 0.f (slabs past m add exact zeros), with the query scale-folded by
// the caller (dense) or at read time with the page's scale row (paged, one
// rounding per value, as the dense fold). The dense and the paged search
// are bitwise equal on the same contents because of it.
template <typename T, bool VEC, bool LIST, typename Src>
__global__ void __launch_bounds__(CT, 1)
topk_chunk_kernel(Src src_arg, const float* __restrict__ Q, int m, int B, int k, int nchunks,
                  int64_t ldq, uint64_t* __restrict__ cand) {
  using C = Chunk<T>;
  const Src src = src_arg.bound();
  extern __shared__ __align__(16) unsigned char smem[];
  const int kp = panel_width(m), qld = kp + 4;
  float* Qs = reinterpret_cast<float*>(smem);                       // [CQ][qld]
  float* Ss = Qs + CQ * qld;                                        // [HQ][SLD]
  unsigned char* ring = reinterpret_cast<unsigned char*>(Ss + HQ * SLD);
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
    load_chunk_slab<T, VEC>(src, stage(t), chunk_of(t), m, (t % nslab) * CK, tid);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  uint64_t run[4] = {0, 0, 0, 0};     // chunk_keys' thresholds
  const float* srow = nullptr;        // the warp's scale row (paged, SCALED)
  int2 fs = make_int2(-1, Src::SCALED ? 0 : 1);   // the chunk's fold row, and whether Qs
                                                // holds it (dense: nothing to fold)

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
    if (Src::SCALED && slab == 0) {
      fs = src.fold_state(chunk_of(t));
      srow = src.scale_row(chunk_of(t), warp);
    }
    // the tile is (re)loaded at the first slab, at each panel, and where a
    // chunk needs another fold than the CTA's last chunk
    if (slab % ppanel == 0 && (t == 0 || nslab > ppanel || (slab == 0 && !fs.y))) {
      load_query_panel(Q, Qs, B, m, q0, slab * CK, kp, tid,
                       Src::SCALED && fs.x >= 0 ? src.slot_scale(fs.x) : nullptr);
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
    slab_fma<Src::SCALED, VEC>(Qs + (slab % ppanel) * CK, qld, Ds, acc, warp, qg, rg,
                               fs.x < 0, srow, slab * CK, m);
    if (slab == nslab - 1)
      chunk_keys<LIST>(acc, Ss, run, src, B, q0, k, chunk_of(t), ldq, cand, tid);
  }
  cp_async_wait<0>();
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

// The unit table of a paged walk over slots [lo, hi): U = ceil(R / 64)
// units a page. With U <= 8 a chunk holds ppc = 8 / U whole pages (units
// past ppc U are masked); else a page spans cpp = ceil(U / 8) chunks. A
// table entry below pool_pages addresses the pool, one at or above it the
// tail, one in neither masks the page. Rows that may be live: up to
// page_nvalid[slot], or up to R with ids_pool.
template <typename T>
__global__ void paged_units_kernel(const T* __restrict__ pool, const T* __restrict__ tail,
                                   const int* __restrict__ table, const int* __restrict__ nvalid,
                                   const int* __restrict__ offset, int pool_pages,
                                   int tail_pages, int R, int m, int lo, int hi, int U, int ppc,
                                   int cpp, int with_ids, int nunits, Unit* __restrict__ units) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= nunits) return;
  const int c = e / UPC, u = e % UPC;
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
    row0 = ((c % cpp) * UPC + u) * UNIT;
    live = true;
  }
  live = live && slot < hi && row0 < R;
  Unit out{reinterpret_cast<long long>(pool), 0, 0, live ? static_cast<int>(slot) : lo, row0};
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

// The slot whose scale row every live unit of chunk c shares (the first
// live one's), -1 when they differ, the chunk's first slot when none is
// live (its rows are all masked, so any fold serves).
__device__ __forceinline__ int chunk_fold(const Unit* units, const float* scale, int m, int c) {
  int rep = -1;
  for (int u = 0; u < UPC; ++u) {
    const Unit& x = units[c * UPC + u];
    if (x.rows == 0) continue;
    if (rep < 0) rep = x.slot;
    else if (!rows_equal(scale, m, rep, x.slot)) return -1;
  }
  return rep < 0 ? units[c * UPC].slot : rep;
}

// One warp per chunk: fold[c] = (chunk_fold(c), whether the tile the CTA
// left after chunk c - gx, its last, already holds that fold).
__global__ void paged_fold_kernel(const Unit* __restrict__ units, const float* __restrict__ scale,
                                  int m, int nchunks, int gx, int2* __restrict__ fold) {
  const int c = static_cast<int>((static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 32);
  if (c >= nchunks) return;                    // whole warp
  const int r = chunk_fold(units, scale, m, c);
  int same = 0;
  if (c >= gx) {
    const int p = chunk_fold(units, scale, m, c - gx);
    same = (r < 0 && p < 0) || (r >= 0 && p >= 0 && rows_equal(scale, m, r, p));
  }
  if ((threadIdx.x & 31) == 0) fold[c] = make_int2(r, same);
}

// ---------------------------------------------------------------------------
// k > SMALL_K: radix select over every key of a query, gather, sort, write
// ---------------------------------------------------------------------------
//
// Replaces the running top-k of topk_score_pallas / topk_score_paged_pallas
// for large k. A query's L keys (one per row, the carry's k after them) sit
// in one row of `keys`. Passes take 11-bit digits from the top (shifts 53,
// 42, 31, 20, 9, then 9 bits at 0): radix_hist counts, per query, the
// digit of every key whose higher bits equal the prefix found so far;
// radix_pick finds the digit holding the k-th largest key and what is left
// to take. A query is done when that digit's bin holds at most SLACK keys
// (then every key at or above the bin is taken: at most k + SLACK) or at
// the last digit (then the k-th key T itself: all keys above T, and as
// many copies of T as are still needed). Keys are unique except equal
// copies (PAD_KEY for masked rows, or an id repeated in row_ids /
// ids_pool), so the taken keys are exactly the top k (plus at most SLACK
// below it), whatever duplicates there are; duplicate copies are
// interchangeable. Passes after a query is done return at once. Bound:
// each pass reads the keys once (8 bytes a row), the gather once more; at
// serving scores two or three passes decide (the top 22-33 bits).
constexpr int RBITS = 11;
constexpr int RBINS = 1 << RBITS;
constexpr int RT = 256;          // threads of the histogram and gather kernels
constexpr int SLACK = 2048;      // keys of the last bin taken whole
constexpr int NPASS = 6;
constexpr int PASS_SHIFT[NPASS] = {53, 42, 31, 20, 9, 0};
constexpr int PASS_WIDTH[NPASS] = {11, 11, 11, 11, 11, 9};
constexpr int SORT_TILE = 8192;  // keys a CTA sorts in shared memory (64 KB)
constexpr int ST = 1024;         // threads of the sort kernels

// Per query: `prefix` (once done, the threshold T: keys above it are all
// taken), `need` (keys still to take at or below the prefix; once done,
// the copies of T to take), `above` (keys known to be above; once done,
// the keys above T), `done`.
struct Sel {
  unsigned long long prefix;
  long long need, above;
  int done, pad;
};

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__global__ void __launch_bounds__(RT)
radix_hist_kernel(const uint64_t* __restrict__ keys, int64_t L, int shift, int width,
                  const Sel* __restrict__ st, unsigned* __restrict__ hist) {
  __shared__ unsigned h[RBINS];
  const int q = blockIdx.y;
  const bool first = shift + width == 64;
  uint64_t prefix = 0, hmask = 0;
  if (!first) {
    if (st[q].done) return;                    // the whole CTA
    prefix = st[q].prefix;
    hmask = ~0ull << (shift + width);
  }
  const unsigned dmask = (1u << width) - 1;
  for (int i = threadIdx.x; i <= static_cast<int>(dmask); i += RT) h[i] = 0;
  __syncthreads();
  const uint64_t* row = keys + static_cast<int64_t>(q) * L;
  const int lane = threadIdx.x & 31;
  for (int64_t i0 = static_cast<int64_t>(blockIdx.x) * RT; i0 < L;
       i0 += static_cast<int64_t>(gridDim.x) * RT) {
    const int64_t i = i0 + threadIdx.x;
    unsigned d = RBINS;                        // no bin
    if (i < L) {
      const uint64_t key = row[i];
      if ((key & hmask) == prefix) d = static_cast<unsigned>(key >> shift) & dmask;
    }
    // lanes of one digit add once: the leading digits of real scores are few
    const unsigned peers = __match_any_sync(FULL, d);
    if (d < RBINS && lane == __ffs(peers) - 1) atomicAdd(&h[d], __popc(peers));
  }
  __syncthreads();
  for (int i = threadIdx.x; i <= static_cast<int>(dmask); i += RT)
    if (h[i]) atomicAdd(&hist[static_cast<int64_t>(q) * RBINS + i], h[i]);
}

// One warp per query: the digit holding the need-th largest key at this
// pass, from the histogram (which it zeroes for the next pass).
__global__ void __launch_bounds__(32)
radix_pick_kernel(Sel* __restrict__ st, unsigned* __restrict__ hist, int shift, int first,
                  long long k_eff) {
  const int q = blockIdx.x, lane = threadIdx.x;
  Sel s = first ? Sel{0ull, k_eff, 0, 0, 0} : st[q];
  if (s.done) return;
  unsigned* hq = hist + static_cast<int64_t>(q) * RBINS;
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
  const unsigned owner = __ballot_sync(FULL, excl < s.need && s.need <= incl);
  const int src = owner ? __ffs(owner) - 1 : 0;   // a lane always holds it
  int digit = 0;
  long long above = 0, count = 0;
  if (lane == src) {
    above = excl;
    for (int b = top - 1; b >= top - SEG; --b) {
      const long long c = hq[b];
      if (above + c >= s.need) { digit = b; count = c; break; }
      above += c;
    }
  }
  digit = __shfl_sync(FULL, digit, src);
  above = __shfl_sync(FULL, above, src);
  count = __shfl_sync(FULL, count, src);
  __syncwarp();
  for (int b = lane; b < RBINS; b += 32) hq[b] = 0;
  if (lane == 0) {
    s.prefix |= static_cast<unsigned long long>(digit) << shift;
    s.need -= above;
    s.above += above;
    if (shift == 0) {
      s.done = 1;                              // prefix is the k-th key
    } else if (count <= SLACK && s.prefix != 0) {
      s.done = 1;                              // take the whole bin
      s.above += count;
      s.need = 0;
      s.prefix -= 1;
    }
    st[q] = s;
  }
}

// Keys above T to the front of the query's row of `out` (N slots), and
// `need` copies of T after them; warp-aggregated slot counters cnt[q][2].
__global__ void __launch_bounds__(RT)
radix_gather_kernel(const uint64_t* __restrict__ keys, int64_t L, const Sel* __restrict__ st,
                    int64_t N, uint64_t* __restrict__ out,
                    unsigned long long* __restrict__ cnt) {
  const int q = blockIdx.y, lane = threadIdx.x & 31;
  const uint64_t T = st[q].prefix;
  const long long eq = st[q].need, above = st[q].above;
  const uint64_t* row = keys + static_cast<int64_t>(q) * L;
  uint64_t* dst = out + static_cast<int64_t>(q) * N;
  for (int64_t i0 = static_cast<int64_t>(blockIdx.x) * RT; i0 < L;
       i0 += static_cast<int64_t>(gridDim.x) * RT) {
    const int64_t i = i0 + threadIdx.x;
    const uint64_t key = i < L ? row[i] : 0;
    const bool up = i < L && key > T;
    const bool tie = i < L && eq > 0 && key == T;
    const unsigned mu = __ballot_sync(FULL, up), mt = __ballot_sync(FULL, tie);
    unsigned long long bu = 0, bt = 0;
    if (lane == 0 && mu) bu = atomicAdd(&cnt[2 * q], static_cast<unsigned long long>(__popc(mu)));
    if (lane == 0 && mt) bt = atomicAdd(&cnt[2 * q + 1], static_cast<unsigned long long>(__popc(mt)));
    bu = __shfl_sync(FULL, bu, 0);
    bt = __shfl_sync(FULL, bt, 0);
    if (up) dst[bu + __popc(mu & lanemask_lt())] = key;
    if (tie) {
      const long long pos = static_cast<long long>(bt) + __popc(mt & lanemask_lt());
      if (pos < eq) dst[above + pos] = key;
    }
  }
}

// Bitonic compare-exchange of the pair (lo, lo + stride) for a network
// stage of `size`, descending where the global index has bit `size` clear.
__device__ __forceinline__ void bitonic_pair(uint64_t* buf, int64_t gbase, int lo, int stride,
                                             int64_t size) {
  const uint64_t a = buf[lo], b = buf[lo + stride];
  const bool desc = ((gbase + lo) & size) == 0;
  if (desc ? (a < b) : (a > b)) { buf[lo] = b; buf[lo + stride] = a; }
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

// The first k of a query's sorted keys as scores and ids; slots past N or
// holding a pad are (-inf, -1), or with `unfinal` slot j after c finite
// slots gets id -(j - c + 2), as the merge writes them.
__global__ void __launch_bounds__(RT)
select_write_kernel(const uint64_t* __restrict__ sorted, int64_t N, int k, int unfinal,
                    float* __restrict__ out_s, int* __restrict__ out_i) {
  const int q = blockIdx.x;
  const uint64_t* row = sorted + static_cast<int64_t>(q) * N;
  int c = 0;
  if (unfinal)
    for (int j0 = 0; j0 < k; j0 += RT) {
      const int j = j0 + threadIdx.x;
      c += __syncthreads_count(j < k && j < N && !key_is_pad(row[j]));
    }
  for (int j = threadIdx.x; j < k; j += RT) {
    const uint64_t key = j < N ? row[j] : 0;
    const bool pad = key_is_pad(key);
    out_s[static_cast<int64_t>(q) * k + j] = pad ? __int_as_float(0xff800000) : key_score(key);
    out_i[static_cast<int64_t>(q) * k + j] = pad ? (unfinal ? -(j - c + 2) : -1) : key_id(key);
  }
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

// CTAs per query tile of the chunk kernel: one per SM, the SMs shared
// among the query tiles, at most one per chunk.
int chunk_grid_x(int nchunks, int B, int sms) {
  const int tiles = (B + CQ - 1) / CQ;
  const int per_tile = (sms + tiles - 1) / tiles;
  return nchunks < per_tile ? nchunks : per_tile;
}

template <typename T, bool VEC, bool LIST, typename Src>
cudaError_t launch_chunks(const Src& src, const float* Q, int m, int B, int k, int nchunks,
                          int64_t ldq, uint64_t* cand, cudaStream_t stream) {
  auto kern = topk_chunk_kernel<T, VEC, LIST, Src>;
  const size_t smem = chunk_smem<T>(m);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  int sms = 0;
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const dim3 grid(chunk_grid_x(nchunks, B, sms), (B + CQ - 1) / CQ);
  kern<<<grid, CT, smem, stream>>>(src, Q, m, B, k, nchunks, ldq, cand);
  return cudaGetLastError();
}

template <typename T, typename Src>
cudaError_t dispatch_chunks(bool vec, bool list, const Src& src, const float* Q, int m, int B,
                            int k, int nchunks, int64_t ldq, uint64_t* cand, cudaStream_t s) {
  if (vec) return list ? launch_chunks<T, true, true>(src, Q, m, B, k, nchunks, ldq, cand, s)
                       : launch_chunks<T, true, false>(src, Q, m, B, k, nchunks, ldq, cand, s);
  return list ? launch_chunks<T, false, true>(src, Q, m, B, k, nchunks, ldq, cand, s)
              : launch_chunks<T, false, false>(src, Q, m, B, k, nchunks, ldq, cand, s);
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

// The select's scratch for B queries of L keys at k: the sorted rows (N
// keys each, N the power of two at or above min(k, L) + SLACK), the
// histograms, the per-query state and the gather's counters.
struct SelLayout {
  int64_t N, words;
};
SelLayout sel_layout(int64_t L, int k, int B) {
  const int64_t k_eff = k < L ? k : L;
  int64_t N = 1;
  while (N < k_eff + SLACK) N <<= 1;
  const int64_t words = static_cast<int64_t>(B) * N + static_cast<int64_t>(B) * RBINS / 2 +
                        static_cast<int64_t>(B) * (sizeof(Sel) / 8) + 2 * static_cast<int64_t>(B);
  return {N, words};
}

// Top k of each query's row of L keys (keys: B x L, descending (score, id)
// order as encode_key makes them) into out_s / out_i; `work` holds
// sel_layout(L, k, B).words keys.
int run_select(const uint64_t* keys, int B, int64_t L, int k, int unfinal, uint64_t* work,
               float* os, int* oi, cudaStream_t s, int* launched) {
  const SelLayout lay = sel_layout(L, k, B);
  const int64_t N = lay.N;
  uint64_t* sorted = work;
  auto* hist = reinterpret_cast<unsigned*>(sorted + static_cast<int64_t>(B) * N);
  auto* sel = reinterpret_cast<Sel*>(hist + static_cast<int64_t>(B) * RBINS);
  auto* cnt = reinterpret_cast<unsigned long long*>(sel + B);
  cudaError_t err = cudaMemsetAsync(work, 0, lay.words * 8, s);
  int sms = 0;
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t want = (L + RT * 4 - 1) / (RT * 4);
  const int64_t fill = (8LL * sms + B - 1) / B;
  const int bpq = static_cast<int>(want < fill ? (want < 1 ? 1 : want) : fill);
  const long long k_eff = k < L ? k : L;
  auto check = [&]() {
    err = cudaGetLastError();
    if (err == cudaSuccess) ++*launched;
    return err == cudaSuccess;
  };
  for (int p = 0; p < NPASS; ++p) {
    radix_hist_kernel<<<dim3(bpq, B), RT, 0, s>>>(keys, L, PASS_SHIFT[p], PASS_WIDTH[p], sel,
                                                  hist);
    if (!check()) return static_cast<int>(err);
    radix_pick_kernel<<<B, 32, 0, s>>>(sel, hist, PASS_SHIFT[p], p == 0, k_eff);
    if (!check()) return static_cast<int>(err);
  }
  radix_gather_kernel<<<dim3(bpq, B), RT, 0, s>>>(keys, L, sel, N, sorted, cnt);
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
  select_write_kernel<<<B, RT, 0, s>>>(sorted, N, k, unfinal, os, oi);
  if (!check()) return static_cast<int>(err);
  return 0;
}

// Chunks of a paged walk over `slots` slots of R rows, and its geometry.
struct PagedGeom {
  int U, ppc, cpp;
  int64_t nchunks;
};
PagedGeom paged_geom(int64_t slots, int R) {
  PagedGeom g;
  g.U = (R + UNIT - 1) / UNIT;
  if (g.U <= UPC) {
    g.ppc = UPC / g.U;
    g.cpp = 1;
    g.nchunks = (slots + g.ppc - 1) / g.ppc;
  } else {
    g.ppc = 1;
    g.cpp = (g.U + UPC - 1) / UPC;
    g.nchunks = slots * g.cpp;
  }
  return g;
}

// Words of the unit table (a Unit is three 8-byte words) and the fold
// states (one int2 a chunk).
int64_t unit_words(int64_t nchunks) { return nchunks * UPC * (sizeof(Unit) / 8) + nchunks; }

// Words of scratch after the unit table for B queries, `lists` chunk
// lists and `extra` carry keys: per-chunk candidate lists and merges for
// k <= SMALL_K, else one key per row and the select.
int64_t key_words(int64_t nchunks, int carry, int k, int B) {
  if (k <= SMALL_K) return merge_words(nchunks + carry, k, B);
  const int64_t L = nchunks * CR + (carry ? k : 0);
  return static_cast<int64_t>(B) * L + sel_layout(L, k, B).words;
}

template <typename T>
int dense_call(const void* D, const float* q, const int* ids, int64_t n, int m, int B,
               int64_t n_valid, const int* n_valid_dev, int k, bool vec, uint64_t* scratch,
               float* os, int* oi, cudaStream_t s, int* launched) {
  const int nchunks = static_cast<int>((n + CR - 1) / CR);
  const DenseSrc<T> src{static_cast<const T*>(D), ids, n, n_valid, m, n_valid_dev};
  const bool list = k > SMALL_K;
  const int64_t ldq = list ? static_cast<int64_t>(nchunks) * CR : static_cast<int64_t>(nchunks) * k;
  cudaError_t err = dispatch_chunks<T>(vec, list, src, q, m, B, k, nchunks, ldq, scratch, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  ++*launched;
  if (list)
    return run_select(scratch, B, ldq, k, 0, scratch + static_cast<int64_t>(B) * ldq, os, oi,
                      s, launched);
  return run_merges(nchunks, B, k, scratch, scratch + static_cast<int64_t>(B) * ldq, os, oi, 0,
                    s, launched);
}

template <typename T>
int paged_call(const void* pool, const void* tail, const int* table, const int* nvalid,
               const int* offset, const float* scale, const int* ids_pool, const float* q,
               const float* cs, const int* ci, int pool_pages, int tail_pages, int R, int m,
               int B, int lo, int hi, int k, bool vec, int unfinal, uint64_t* scratch,
               float* os, int* oi, cudaStream_t s, int* launched) {
  const int64_t slots = hi > lo ? hi - lo : 0;
  const PagedGeom g = paged_geom(slots, R);
  const int nchunks = static_cast<int>(g.nchunks);
  const bool carry = cs != nullptr;
  auto* units = reinterpret_cast<Unit*>(scratch);
  auto* fold = reinterpret_cast<int2*>(units + static_cast<int64_t>(nchunks) * UPC);
  uint64_t* cand = scratch + unit_words(nchunks);
  const bool list = k > SMALL_K;
  const int64_t ldq = list ? static_cast<int64_t>(nchunks) * CR + (carry ? k : 0)
                           : static_cast<int64_t>(nchunks + (carry ? 1 : 0)) * k;
  cudaError_t err;
  if (nchunks > 0) {
    const int nunits = nchunks * UPC;
    paged_units_kernel<T><<<(nunits + 255) / 256, 256, 0, s>>>(
        static_cast<const T*>(pool), static_cast<const T*>(tail), table, nvalid, offset,
        pool_pages, tail_pages, R, m, lo, hi, g.U, g.ppc, g.cpp, ids_pool != nullptr, nunits,
        units);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launched;
    if (scale != nullptr) {
      int sms = 0;
      err = sm_count(&sms);
      if (err != cudaSuccess) return static_cast<int>(err);
      const int64_t threads = static_cast<int64_t>(nchunks) * 32;
      paged_fold_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, s>>>(
          units, scale, m, nchunks, chunk_grid_x(nchunks, B, sms), fold);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      ++*launched;
      err = dispatch_chunks<T>(vec, list, PagedSrc<T, true>{units, ids_pool, scale, fold, R, m},
                               q, m, B, k, nchunks, ldq, cand, s);
    } else {
      err = dispatch_chunks<T>(vec, list,
                               PagedSrc<T, false>{units, ids_pool, nullptr, nullptr, R, m}, q, m,
                               B, k, nchunks, ldq, cand, s);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launched;
  }
  if (carry) {
    const int64_t total = static_cast<int64_t>(B) * k;
    const int64_t off = list ? static_cast<int64_t>(nchunks) * CR : static_cast<int64_t>(nchunks) * k;
    carry_keys_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(cs, ci, B, k, ldq,
                                                                               off, cand);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launched;
  }
  if (list)
    return run_select(cand, B, ldq, k, unfinal, cand + static_cast<int64_t>(B) * ldq, os, oi, s,
                      launched);
  return run_merges(nchunks + (carry ? 1 : 0), B, k, cand, cand + static_cast<int64_t>(B) * ldq,
                    os, oi, unfinal, s, launched);
}

}  // namespace

// Scratch of a dense call over n rows at k for B queries: out[0] = 8-byte
// words, out[1] = 1 when the call takes the radix select (k > 32).
extern "C" int topk_plan(int64_t n, int k, int B, int64_t* out) {
  if (n < 1 || k < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = key_words((n + CR - 1) / CR, 0, k, B);
  out[1] = k > SMALL_K;
  return 0;
}

// D (n, m) in dtype 0 = f32, 1 = bf16, 2 = int8; Q (B, m) f32; row_ids
// (n,) int32 or null. The live count is n_valid_dev[0] (one int32 on the
// device, clamped to [0, n] by the kernel) when that pointer is set, else
// the host value n_valid. scratch holds topk_plan's words. Writes out_s
// (B, k) f32 and out_i (B, k) int32. `vec` asserts m % 16 == 0 and a
// 16-byte aligned D. *launched counts the kernel launches made. Returns the
// first cudaError_t.
extern "C" int topk_score_f32(const void* D, const void* Q, const void* row_ids, int64_t n,
                              int m, int B, int64_t n_valid, const void* n_valid_dev, int k,
                              int dtype, int vec, void* scratch, void* out_s, void* out_i,
                              void* stream, int* launched) {
  auto s = static_cast<cudaStream_t>(stream);
  auto q = static_cast<const float*>(Q);
  auto ids = static_cast<const int*>(row_ids);
  auto nvd = static_cast<const int*>(n_valid_dev);
  auto* sc = static_cast<uint64_t*>(scratch);
  auto* os = static_cast<float*>(out_s);
  auto* oi = static_cast<int*>(out_i);
  *launched = 0;
  if (n < 1 || (n + CR - 1) / CR > 0x7FFFFFFF || k < 1 || B < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
#define DENSE(T) dense_call<T>(D, q, ids, n, m, B, n_valid, nvd, k, vec, sc, os, oi, s, launched)
  if (dtype == 0) return DENSE(float);
  if (dtype == 1) return DENSE(__nv_bfloat16);
  if (dtype == 2) return DENSE(int8_t);
#undef DENSE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Scratch of a paged call over `slots` page slots of R rows (plus a carry
// when `carry` is set) at k for B queries: out[0] = 8-byte words, out[1] =
// 1 when the call takes the radix select.
extern "C" int topk_paged_plan(int64_t slots, int R, int k, int carry, int B, int64_t* out) {
  if (slots < 0 || R < 1 || k < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const PagedGeom g = paged_geom(slots, R);
  if (g.nchunks * UPC > 0x7FFFFFFF || (g.nchunks == 0 && !carry))
    return static_cast<int>(cudaErrorInvalidValue);
  out[0] = unit_words(g.nchunks) + key_words(g.nchunks, carry, k, B);
  out[1] = k > SMALL_K;
  return 0;
}

// Exact top-k over logical page slots [lo, hi) of a page table.
// pool (pool_pages, R, m) and tail (tail_pages, R, m, or null) in dtype
// 0 = f32, 1 = bf16, 2 = int8; table, nvalid, offset (>= hi,) int32;
// scale (>= hi, m) f32 or null; ids_pool (>= hi, R) int32 or null; Q (B, m)
// f32; carry_s / carry_i (B, k) or null. scratch holds topk_paged_plan's
// words. Writes out_s (B, k) f32 and out_i (B, k) int32; -inf slots get id
// -1 with `finalize`, else their rank among pads as -(j - c + 2). `vec`
// asserts m % 16 == 0 and 16-byte aligned pool, tail and scale.
// *launched counts the kernel launches made. Returns the first cudaError_t.
extern "C" int topk_score_paged_f32(
    const void* pool, const void* tail, const void* table, const void* nvalid,
    const void* offset, const void* scale, const void* ids_pool, const void* Q,
    const void* carry_s, const void* carry_i, int pool_pages, int tail_pages,
    int R, int m, int B, int lo, int hi, int k, int dtype, int vec, int finalize,
    void* scratch, void* out_s, void* out_i, void* stream, int* launched) {
  auto s = static_cast<cudaStream_t>(stream);
  *launched = 0;
  const bool carry = carry_s != nullptr;
  if (k < 1 || B < 1 || B > 65535 || R < 1 || m < 1 || lo < 0 ||
      (hi <= lo && !carry) || (carry && carry_i == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto tb = static_cast<const int*>(table);
  auto nv = static_cast<const int*>(nvalid);
  auto off = static_cast<const int*>(offset);
  auto sc = static_cast<const float*>(scale);
  auto ip = static_cast<const int*>(ids_pool);
  auto q = static_cast<const float*>(Q);
  auto cs = static_cast<const float*>(carry_s);
  auto ci = static_cast<const int*>(carry_i);
  auto* w = static_cast<uint64_t*>(scratch);
  auto* os = static_cast<float*>(out_s);
  auto* oi = static_cast<int*>(out_i);
  const int unfinal = finalize ? 0 : 1;
#define PAGED(T) paged_call<T>(pool, tail, tb, nv, off, sc, ip, q, cs, ci, pool_pages, tail_pages, \
                               R, m, B, lo, hi, k, vec, unfinal, w, os, oi, s, launched)
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
// out_s / out_i (B, k), pads as the merge writes them. scratch holds
// topk_select_plan's words. *launched counts the launches.
extern "C" int topk_select_keys(const void* keys, int B, int64_t L, int k, int finalize,
                                void* scratch, void* out_s, void* out_i, void* stream,
                                int* launched) {
  *launched = 0;
  if (L < 1 || k < 1 || B < 1 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  return run_select(static_cast<const uint64_t*>(keys), B, L, k, finalize ? 0 : 1,
                    static_cast<uint64_t*>(scratch), static_cast<float*>(out_s),
                    static_cast<int*>(out_i), static_cast<cudaStream_t>(stream), launched);
}

namespace {

template <typename T>
int chunk_dyn_smem(int m) { return static_cast<int>(chunk_smem<T>(m)); }
int sort_tile_smem(int) { return SORT_TILE * static_cast<int>(sizeof(uint64_t)); }

#define CHUNK4(T, TN, S, SN)                                                               \
  {"topk_chunk_kernel<" TN ",vec,keep," SN ">",                                            \
   reinterpret_cast<const void*>(topk_chunk_kernel<T, true, false, S>), CT, chunk_dyn_smem<T>}, \
  {"topk_chunk_kernel<" TN ",vec,list," SN ">",                                            \
   reinterpret_cast<const void*>(topk_chunk_kernel<T, true, true, S>), CT, chunk_dyn_smem<T>}, \
  {"topk_chunk_kernel<" TN ",scalar,keep," SN ">",                                         \
   reinterpret_cast<const void*>(topk_chunk_kernel<T, false, false, S>), CT, chunk_dyn_smem<T>}, \
  {"topk_chunk_kernel<" TN ",scalar,list," SN ">",                                         \
   reinterpret_cast<const void*>(topk_chunk_kernel<T, false, true, S>), CT, chunk_dyn_smem<T>}
template <typename T>
using PagedPlain = PagedSrc<T, false>;
template <typename T>
using PagedScaled = PagedSrc<T, true>;
#define CHUNKS(T, TN)                                                                      \
  CHUNK4(T, TN, DenseSrc<T>, "dense"), CHUNK4(T, TN, PagedPlain<T>, "paged"),             \
      CHUNK4(T, TN, PagedScaled<T>, "paged_scaled")
#define UNITS(T, TN)                                                                       \
  {"paged_units_kernel<" TN ">", reinterpret_cast<const void*>(paged_units_kernel<T>), 256, \
   nullptr}

const KernelEntry KERNELS[] = {
    CHUNKS(float, "f32"),
    CHUNKS(__nv_bfloat16, "bf16"),
    CHUNKS(int8_t, "int8"),
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
};
#undef UNITS
#undef CHUNKS
#undef CHUNK4

}  // namespace

// The resource check's view of every kernel in this file (common.cuh's
// kernel_attrs); m is the index width the chunk kernel's tile is sized for.
extern "C" int topk_score_kernel_attrs(int i, int m, const char** name, int* attrs) {
  return kernel_attrs(KERNELS, static_cast<int>(sizeof(KERNELS) / sizeof(KERNELS[0])), i, m,
                      name, attrs);
}
