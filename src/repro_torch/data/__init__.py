from repro_torch.data.synthetic import scale_trace, zipf_queries

__all__ = ["scale_trace", "zipf_queries"]
