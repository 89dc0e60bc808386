"""The least time of a search call at the four cells' shapes, pinned."""
from __future__ import annotations

import pytest

from bench import roofline

N, D, M = 8_841_823, 768, 384


@pytest.mark.parametrize("store, B, k, nbytes, flops, roof", [
    # msmarco-f32.open-k10: full 32-query batches over the f32 rows
    ("float32", 32, 10, 13_581_040_128 + 1_179_648 + 98_304 + 2_560,
     217_296_642_048 + 18_874_368, "bytes"),
    # msmarco-int8.open-k10: the same calls over the int8 rows
    ("int8", 32, 10, 3_395_260_032 + 1_179_648 + 98_304 + 2_560,
     217_296_642_048 + 18_874_368, "flops"),
    # msmarco-f32.open-k1000: 1,000 results a query
    ("float32", 32, 1000, 13_581_040_128 + 1_179_648 + 98_304 + 256_000,
     217_296_642_048 + 18_874_368, "bytes"),
    # the off-peak int8 cell left for a later PR (PERF.md §7): the 8-query bucket
    ("int8", 8, 10, 3_395_260_032 + 1_179_648 + 24_576 + 640,
     54_324_160_512 + 4_718_592, "bytes"),
])
def test_counts_at_the_cells_shapes(store, B, k, nbytes, flops, roof):
    assert roofline.search_bytes(n=N, m=M, d=D, B=B, k=k, store=store) == nbytes
    assert roofline.search_flops(n=N, m=M, d=D, B=B) == flops
    t, which = roofline.least_seconds(n=N, m=M, d=D, B=B, k=k, store=store)
    assert which == roof
    assert t == pytest.approx(max(nbytes / 3.35e12, flops / 67e12))


def test_f32_and_int8_bounds_match_the_records():
    # PERF.md: 4.05 ms (bytes) for f32 and 3.24 ms (FMAs) for int8 at B 32,
    # 1.01 ms (bytes) for int8 at B 8
    f32 = roofline.least_seconds(n=N, m=M, d=D, B=32, k=10, store="float32")[0]
    i8 = roofline.least_seconds(n=N, m=M, d=D, B=32, k=10, store="int8")[0]
    i8_8 = roofline.least_seconds(n=N, m=M, d=D, B=8, k=10, store="int8")[0]
    assert (round(f32 * 1e3, 2), round(i8 * 1e3, 2), round(i8_8 * 1e3, 2)) == (4.05, 3.24, 1.01)
