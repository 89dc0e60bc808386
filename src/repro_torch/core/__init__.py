"""Core of the port: PCA fit and pruning, the dense, segmented and paged
indexes, index maintenance, quantisation and metrics."""
from repro_torch.core.index import DeltaSegment, SegmentedIndex, merge_segment_topk
from repro_torch.core.maintenance import IndexUpdater

__all__ = ["DeltaSegment", "IndexUpdater", "SegmentedIndex", "merge_segment_topk"]
