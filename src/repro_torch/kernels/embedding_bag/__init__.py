"""Segment sum / EmbeddingBag: CUDA segmented-reduction kernel + plain versions."""
from .ops import embedding_bag, segment_sum  # noqa: F401
from .ref import embedding_bag_ref, segment_sum_ref  # noqa: F401
