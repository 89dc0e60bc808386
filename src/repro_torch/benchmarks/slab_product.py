"""Time the chunk kernel's slab product alone on the card: the 32-query x
512-row tile over 16-deep slabs held in shared memory, with no global
loads, no ring and no select, for several operand layouts and lane maps.

    python src/repro_torch/benchmarks/slab_product.py [--reps R]

Each variant is one CTA of 256 threads an SM (8 x 8 chains a thread), a
384-wide query panel and two slabs resident, walked ``R`` times over 24
slabs with a barrier every two slabs (as the f32 walk has), the chains
summed and zeroed every 24 slabs. The FMAs a second over the card's fp32
FMA peak (33.5 T FMA/s, an H100 SXM's 67 TFLOP/s) is the ceiling the
variant's reads and registers leave the mainloop:

- ``parent``: the query tile stored query-major, each slab row-major
  (16-byte pieces swizzled), a thread 8 queries x 8 rows with lanes 4 x 8
  reading both along m in 16-byte pieces (the chunk kernel before its
  k-major redesign);
- ``qk``: the query panel stored k-major (32 queries a row of the panel),
  the slab as in ``parent``: rows read along m, queries a 16-byte piece of
  4 queries at one m;
- ``kk``: both k-major, a thread 4 + 4 queries and 4 + 4 rows per m, lanes
  8 (rows) fastest; ``kk_db`` the same with the next m's operands loaded
  before this m's FMAs; ``kk_swap`` lanes 4 (queries) fastest;
- ``kk_tr``: ``kk_db`` plus the transposing pass an f32 slab would need
  (a row-major slab, swizzled, rewritten k-major, one barrier a slab),
  4-byte stores; ``kk_tr4`` the same with 16-byte stores (four rows at one
  m a thread, the raw lines swizzled for it);
- ``pm_parent``, ``pm_qk``: ``parent`` and ``qk`` with a piece-major slab
  (piece c of row r at 512 c + r, so a warp's row reads are contiguous);
- ``kk_sync1``: ``kk`` with a barrier every slab;
- ``parent_up8``, ``kk_up8``, ``kk_up8x2``: an int8 slab upcast each slab
  (one barrier a slab) into the parent's layout, k-major with 4-byte
  stores, and k-major with 8-byte stores of two rows.

Prints one JSON line a variant (registers and spills from ``ptxas -v``,
ms, FMA share) after a line with the card's name and power limit; also
written to ``build/benchmarks/slab_product.jsonl``.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
OUT = ROOT / "build" / "benchmarks"
PEAK_FMA = 33.5e12
VARIANTS = ("parent", "qk", "kk", "kk_db", "kk_swap", "kk_tr", "pm_parent", "pm_qk",
            "kk_sync1", "kk_tr4", "kk_up8", "parent_up8", "kk_up8x2")

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
constexpr int CQ = 32, CR = 512, CK = 16, CT = 256, KP = 384;
constexpr int QLD = KP + 4;          // parent: query-major row stride
constexpr int SLAB = CR * CK;        // floats a slab

__device__ __forceinline__ int slab_at(int r, int c) { return r * CK + ((c ^ ((r >> 1) & 3)) << 2); }

// parent: acc[i][j] += Q[4i + qg] . D[64 w + 8j + rg], both read along m
__device__ __forceinline__ void fma_parent(const float* Qs, const float* Ds, float (&acc)[8][8],
                                           int w, int qg, int rg) {
  const float* qb = Qs + qg * QLD;
  const float* db = Ds + (w * 64 + rg) * CK;
  const int swz = (rg >> 1) & 3;
#pragma unroll
  for (int k4 = 0; k4 < CK; k4 += 4) {
    float4 q[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) q[i] = *reinterpret_cast<const float4*>(qb + 4 * i * QLD + k4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 dv = *reinterpret_cast<const float4*>(db + 8 * j * CK + (((k4 >> 2) ^ swz) << 2));
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

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
}

// qk: queries k-major (Qs[k][32]), rows along m: queries 4lq + a and 16 +
// 4lq + a, rows 64 w + 8 j + lr
__device__ __forceinline__ void fma_qk(const float* Qs, const float* Ds, float (&acc)[8][8],
                                       int w, int lq, int lr) {
  const float* db = Ds + (w * 64 + lr) * CK;
  const int swz = (lr >> 1) & 3;
#pragma unroll
  for (int k4 = 0; k4 < CK; k4 += 4) {
    float4 d[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      d[j] = *reinterpret_cast<const float4*>(db + 8 * j * CK + (((k4 >> 2) ^ swz) << 2));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 q0 = *reinterpret_cast<const float4*>(Qs + (k4 + kk) * CQ + 4 * lq);
      const float4 q1 = *reinterpret_cast<const float4*>(Qs + (k4 + kk) * CQ + 16 + 4 * lq);
      const float qv[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(qv[i], comp(d[j], kk), acc[i][j]);
    }
  }
}

// kk: both k-major (Qs[k][32], Ds[k][512]): queries 4lq + a, 16 + 4lq + a;
// rows 64 w + 4lr + b, 64 w + 32 + 4lr + b
template <bool DB>
__device__ __forceinline__ void fma_kk(const float* Qs, const float* Ds, float (&acc)[8][8],
                                       int w, int lq, int lr) {
  const float* qb = Qs + 4 * lq;
  const float* db = Ds + w * 64 + 4 * lr;
  float4 f[2][4];
  auto load = [&](int k, float4 (&g)[4]) {
    g[0] = *reinterpret_cast<const float4*>(qb + k * CQ);
    g[1] = *reinterpret_cast<const float4*>(qb + k * CQ + 16);
    g[2] = *reinterpret_cast<const float4*>(db + k * CR);
    g[3] = *reinterpret_cast<const float4*>(db + k * CR + 32);
  };
  if (DB) load(0, f[0]);
#pragma unroll
  for (int k = 0; k < CK; ++k) {
    if (DB) {
      if (k + 1 < CK) load(k + 1, f[(k + 1) & 1]);
    } else {
      load(k, f[k & 1]);
    }
    const float4* g = f[k & 1];
    const float qv[8] = {g[0].x, g[0].y, g[0].z, g[0].w, g[1].x, g[1].y, g[1].z, g[1].w};
    const float dv[8] = {g[2].x, g[2].y, g[2].z, g[2].w, g[3].x, g[3].y, g[3].z, g[3].w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(qv[i], dv[j], acc[i][j]);
  }
}

// Rewrite a row-major slab (slab_at's pieces) k-major: rows tid, tid + 256.
__device__ __forceinline__ void transpose_slab(const float* raw, float* dst, int tid) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = tid + h * CT;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 v = *reinterpret_cast<const float4*>(raw + slab_at(r, c));
      dst[(4 * c) * CR + r] = v.x;
      dst[(4 * c + 1) * CR + r] = v.y;
      dst[(4 * c + 2) * CR + r] = v.z;
      dst[(4 * c + 3) * CR + r] = v.w;
    }
  }
}

// piece-major slab: 16-byte piece c of row r at (c * CR + r) * 4 floats
__device__ __forceinline__ int pm_at(int r, int c) { return (c * CR + r) << 2; }

// parent's reads with a piece-major slab: rows 64 w + 8 j + rg contiguous
template <bool QK>
__device__ __forceinline__ void fma_pm(const float* Qs, const float* Ds, float (&acc)[8][8],
                                       int w, int lq, int lr) {
#pragma unroll
  for (int k4 = 0; k4 < CK; k4 += 4) {
    float4 d[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      d[j] = *reinterpret_cast<const float4*>(Ds + pm_at(w * 64 + 8 * j + lr, k4 >> 2));
    if (QK) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 q0 = *reinterpret_cast<const float4*>(Qs + (k4 + kk) * CQ + 4 * lq);
        const float4 q1 = *reinterpret_cast<const float4*>(Qs + (k4 + kk) * CQ + 16 + 4 * lq);
        const float qv[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(qv[i], comp(d[j], kk), acc[i][j]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 q = *reinterpret_cast<const float4*>(Qs + (4 * i + lq) * QLD + k4);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = fmaf(q.x, d[j].x, acc[i][j]);
          acc[i][j] = fmaf(q.y, d[j].y, acc[i][j]);
          acc[i][j] = fmaf(q.z, d[j].z, acc[i][j]);
          acc[i][j] = fmaf(q.w, d[j].w, acc[i][j]);
        }
      }
    }
  }
}

// k-major rewrite with 16-byte stores: thread t rows 4 (t % 128) + 0..3,
// values [8 h, 8 h + 8), h = t / 128; the raw slab's 128-byte lines (two
// rows) hold their eight pieces at slot ^ ((line >> 1) & 7)
__device__ __forceinline__ int line_at(int r, int c) {
  const int line = r >> 1, slot = (((r & 1) << 2) | c) ^ ((line >> 1) & 7);
  return (line * 8 + slot) << 2;
}
__device__ __forceinline__ void transpose4(const float* raw, float* dst, int tid) {
  const int r0 = 4 * (tid % 128), h = tid / 128;
  float v[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float4 x = *reinterpret_cast<const float4*>(raw + line_at(r0 + i, 2 * h + c));
      v[i][4 * c] = x.x; v[i][4 * c + 1] = x.y; v[i][4 * c + 2] = x.z; v[i][4 * c + 3] = x.w;
    }
#pragma unroll
  for (int k = 0; k < 8; ++k)
    *reinterpret_cast<float4*>(dst + (8 * h + k) * CR + r0) =
        make_float4(v[0][k], v[1][k], v[2][k], v[3][k]);
}

// int8 as f32 (exact, no conversion pipe)
__device__ __forceinline__ void up16(const int8_t* p, float (&v)[16]) {
  const int4 x = *reinterpret_cast<const int4*>(p);
  const unsigned w[4] = {static_cast<unsigned>(x.x) ^ 0x80808080u,
                         static_cast<unsigned>(x.y) ^ 0x80808080u,
                         static_cast<unsigned>(x.z) ^ 0x80808080u,
                         static_cast<unsigned>(x.w) ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    v[i] = __uint_as_float(__byte_perm(w[i / 4], 0x4Bu, 0x4550u | (i % 4))) - 8388736.0f;
}
// parent's upcast: rows tid, tid + 256 into slab_at's pieces
__device__ __forceinline__ void up_parent(const int8_t* raw, float* dst, int tid) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = tid + h * CT;
    float v[16];
    up16(raw + r * CK, v);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(dst + slab_at(r, c)) =
          make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
  }
}
// k-major upcast, a row a thread at a time (4-byte stores)
__device__ __forceinline__ void up_k1(const int8_t* raw, float* dst, int tid) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = tid + h * CT;
    float v[16];
    up16(raw + r * CK, v);
#pragma unroll
    for (int k = 0; k < 16; ++k) dst[k * CR + r] = v[k];
  }
}
// k-major upcast, rows 2 l, 2 l + 1 (8-byte stores); raw rows of a
// 128-byte line (8 rows) at slot (r & 7) ^ ((r >> 5) & 1)
__device__ __forceinline__ int row8_at(int r) { return ((r >> 3) * 8 + ((r & 7) ^ ((r >> 5) & 1))) * 16; }
__device__ __forceinline__ void up_k2(const int8_t* raw, float* dst, int tid) {
  const int r0 = 2 * tid;
  float v[2][16];
#pragma unroll
  for (int j = 0; j < 2; ++j) up16(raw + row8_at(r0 + j), v[j]);
#pragma unroll
  for (int k = 0; k < 16; ++k)
    *reinterpret_cast<float2*>(dst + k * CR + r0) = make_float2(v[0][k], v[1][k]);
}

template <int V>
__global__ void __launch_bounds__(CT, 1) slab_product(float* out, int reps, int nslab) {
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;                        // parent [32][QLD], else [KP][32]
  float* Ds = Qs + CQ * QLD;             // two slabs
  float* Rs = Ds + 2 * SLAB;             // kk_tr: two row-major slabs
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int e = tid; e < CQ * QLD + 4 * SLAB; e += CT) sm[e] = 1.0f / (1 + (e % 97));
  __syncthreads();
  const int hi = V == 4 ? lane / 4 : lane / 8, lo = V == 4 ? lane % 4 : lane % 8;
  const int lq = V == 4 ? lo : hi, lr = V == 4 ? hi : lo;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float sink = 0.f;
  for (int r = 0; r < reps; ++r) {
    for (int s = 0; s < nslab; ++s) {
      const int nx = (s + 1) & 1;
      const int8_t* R8 = reinterpret_cast<const int8_t*>(Rs + nx * SLAB);
      if (V == 5 || V >= 8) __syncthreads();
      else if (s % 2 == 0) __syncthreads();
      if (V == 5) transpose_slab(Rs + nx * SLAB, Ds + nx * SLAB, tid);
      if (V == 9) transpose4(Rs + nx * SLAB, Ds + nx * SLAB, tid);
      if (V == 10) up_k1(R8, Ds + nx * SLAB, tid);
      if (V == 11) up_parent(R8, Ds + nx * SLAB, tid);
      if (V == 12) up_k2(R8, Ds + nx * SLAB, tid);
      const float* D = Ds + (s & 1) * SLAB;
      const bool qmajor = V == 0 || V == 6 || V == 11;
      const float* Q = Qs + (qmajor ? s * CK : s * CK * CQ);
      if (V == 0 || V == 11) fma_parent(Q, D, acc, warp, lq, lr);
      else if (V == 1) fma_qk(Q, D, acc, warp, lq, lr);
      else if (V == 6) fma_pm<false>(Q, D, acc, warp, lq, lr);
      else if (V == 7) fma_pm<true>(Q, D, acc, warp, lq, lr);
      else if (V == 2 || V == 4 || V == 8) fma_kk<false>(Q, D, acc, warp, lq, lr);
      else fma_kk<true>(Q, D, acc, warp, lq, lr);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sink += acc[i][j];
        acc[i][j] = 0.f;
      }
  }
  out[blockIdx.x * CT + tid] = sink;
}

template <int V>
int run(float* out, int grid, int reps, int nslab, cudaStream_t s) {
  const int smem = (CQ * QLD + 4 * SLAB) * 4;
  cudaError_t e = cudaFuncSetAttribute(slab_product<V>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  slab_product<V><<<grid, CT, smem, s>>>(out, reps, nslab);
  return cudaGetLastError();
}
}  // namespace

extern "C" int slab_product_run(int v, void* out, int grid, int reps, int nslab, void* stream) {
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (v) {
    case 0: return run<0>(o, grid, reps, nslab, s);
    case 1: return run<1>(o, grid, reps, nslab, s);
    case 2: return run<2>(o, grid, reps, nslab, s);
    case 3: return run<3>(o, grid, reps, nslab, s);
    case 4: return run<4>(o, grid, reps, nslab, s);
    case 5: return run<5>(o, grid, reps, nslab, s);
    case 6: return run<6>(o, grid, reps, nslab, s);
    case 7: return run<7>(o, grid, reps, nslab, s);
    case 8: return run<8>(o, grid, reps, nslab, s);
    case 9: return run<9>(o, grid, reps, nslab, s);
    case 10: return run<10>(o, grid, reps, nslab, s);
    case 11: return run<11>(o, grid, reps, nslab, s);
    case 12: return run<12>(o, grid, reps, nslab, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=400)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.benchmarks import turns
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        sys.exit("slab_product: needs a CUDA device")
    out_dir = OUT / "slab_product"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / "slab_product.cu", out_dir / "slab_product.so"
    cu.write_text(SOURCE)
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        sys.exit(f"slab_product: nvcc failed:\n{proc.stdout}{proc.stderr}")
    report = {r["function"]: r for r in _build.ptxas_summary(proc.stdout + proc.stderr)}
    lib = ctypes.CDLL(str(so))
    lib.slab_product_run.restype = ctypes.c_int
    lib.slab_product_run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]
    dev = torch.device("cuda")
    grid, nslab = _build.sm_count(dev), 24
    out = torch.empty(grid * 256, device=dev)
    stream = _build.raw_stream(dev)
    rows = [dict(card=turns.card(), grid=grid, reps=args.reps, nslab=nslab)]
    print(json.dumps(rows[0]), flush=True)
    for v, name in enumerate(VARIANTS):
        def call():
            _build.check(lib.slab_product_run(v, out.data_ptr(), grid, args.reps, nslab, stream),
                         name)
        ms = min(turns.cuda_ms(call, 3) for _ in range(2))
        fmas = grid * args.reps * nslab * 32 * 512 * 16
        ptx = next((r for f, r in report.items() if f"ILi{v}E" in f), {})
        row = dict(variant=name, ms=ms, fma_share=fmas / (ms * 1e-3) / PEAK_FMA,
                   registers=ptx.get("registers"), spill_bytes=ptx.get("spill_store_bytes"))
        rows.append(row)
        print(json.dumps(row), flush=True)
    (OUT / "slab_product.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows))


if __name__ == "__main__":
    main()
