"""Serving on the card: continuous batching over a paged KV cache, and the
consensus bridge that serves a live trainer's mean (the port of
``repro.serve``)."""
from .bridge import ConsensusBridge, ConsensusSnapshot, served_divergence
from .engine import Request, ServeEngine
from .paging import OutOfPages, PageAllocator

__all__ = ["ConsensusBridge", "ConsensusSnapshot", "OutOfPages",
           "PageAllocator", "Request", "ServeEngine", "served_divergence"]
