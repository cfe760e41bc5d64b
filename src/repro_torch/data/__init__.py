from repro_torch.data.pipeline import QueryBatcher, TokenBatcher
from repro_torch.data.synthetic import scale_trace, zipf_queries

__all__ = ["QueryBatcher", "TokenBatcher", "scale_trace", "zipf_queries"]
