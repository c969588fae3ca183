"""Serving on the card: continuous batching over a paged KV cache (the
port of ``repro.serve``; its ``ConsensusBridge`` waits for the training
slice)."""
from .engine import Request, ServeEngine
from .paging import OutOfPages, PageAllocator

__all__ = ["OutOfPages", "PageAllocator", "Request", "ServeEngine"]
