"""Batched speculative serving of the port (split rounds; see server.py)."""
from repro_torch.serving.server import BatchedSpecServer

__all__ = ["BatchedSpecServer"]
