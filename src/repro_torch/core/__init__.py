"""Core of the port: PCA fit and pruning, the dense, segmented, paged and
cascade indexes, the on-disk artifact store, index maintenance, quantisation
and metrics."""
from repro_torch.core.index import DeltaSegment, SegmentedIndex, merge_segment_topk
from repro_torch.core.cascade import CascadeIndex
from repro_torch.core.store import IndexStore, IndexStoreError, save_index, save_paged_index
from repro_torch.core.maintenance import IndexUpdater

__all__ = ["CascadeIndex", "DeltaSegment", "IndexStore", "IndexStoreError", "IndexUpdater",
           "SegmentedIndex", "merge_segment_topk", "save_index", "save_paged_index"]
