"""The least time a search call could take on one H100, from its shapes.

Published peaks of the NVIDIA H100 SXM (data sheet, 700 W): 3.35 TB/s of
HBM and 67 TFLOP/s of fp32 outside the tensor cores. The search keeps its
scores in fp32 whatever the index stores (an int8 index has its scale
folded into an f32 query), so the compute roof is fp32 for every storage.

One ``search_projected`` call over an (n, m) index for B live queries of
width d, depth k:

- bytes: the index once at its storage width, W_m (d x m f32), the raw
  queries (B x d f32) and the outputs (B x k scores f32 and ids int32);
- FLOPs: the scores, 2 B n m, and the projection, 2 B d m.

Kept with the benchmark (a copy of the port's ``chip_smoke.bound``
arithmetic) so that a later change to the program cannot move it.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
STORE_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}


def search_bytes(*, n: int, m: int, d: int, B: int, k: int, store: str) -> int:
    return n * m * STORE_BYTES[store] + d * m * 4 + B * d * 4 + B * k * 8


def search_flops(*, n: int, m: int, d: int, B: int) -> int:
    return 2 * B * n * m + 2 * B * d * m


def least_seconds(*, n: int, m: int, d: int, B: int, k: int, store: str
                  ) -> tuple[float, str]:
    """(seconds, which roof bounds it: ``"bytes"`` or ``"flops"``)."""
    t_bytes = search_bytes(n=n, m=m, d=d, B=B, k=k, store=store) / HBM_BYTES_PER_S
    t_flops = search_flops(n=n, m=m, d=d, B=B) / FP32_FLOP_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops, "flops")
