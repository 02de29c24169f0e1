"""Batched speculative serving of the port (see server.py) and the cascade's draft bank."""
from repro_torch.serving.draft_bank import DraftBank
from repro_torch.serving.server import BatchedSpecServer

__all__ = ["BatchedSpecServer", "DraftBank"]
