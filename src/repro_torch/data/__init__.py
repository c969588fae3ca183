"""Synthetic datasets and the per-learner batch pipeline of the port."""
from .pipeline import ShardedLoader
from .synthetic import SyntheticTokenStream, TemplateImages

__all__ = ["ShardedLoader", "SyntheticTokenStream", "TemplateImages"]
