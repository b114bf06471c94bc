"""Data pipeline: synthetic corpus, packing, multicast placement."""

from .pipeline import (DataConfig, DataPipeline, packed_batches,
                       synthetic_documents)

__all__ = ["DataConfig", "DataPipeline", "synthetic_documents",
           "packed_batches"]
