"""Core of the port: PCA fit and pruning, the dense, segmented and paged
indexes, the on-disk artifact store, index maintenance, quantisation and
metrics."""
from repro_torch.core.index import DeltaSegment, SegmentedIndex, merge_segment_topk
from repro_torch.core.store import IndexStore, IndexStoreError, save_index, save_paged_index
from repro_torch.core.maintenance import IndexUpdater

__all__ = ["DeltaSegment", "IndexStore", "IndexStoreError", "IndexUpdater",
           "SegmentedIndex", "merge_segment_topk", "save_index", "save_paged_index"]
