from repro_torch.collectives.hierarchical import hierarchical_allreduce, tiered_collective_bytes

__all__ = ["hierarchical_allreduce", "tiered_collective_bytes"]
