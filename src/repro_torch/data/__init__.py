"""Synthetic datasets and the per-learner batch pipeline of the port."""
from .pipeline import ShardedLoader, stack_learner_batches
from .synthetic import (GaussianMixtureImages, SyntheticTokenStream,
                        TeacherStudentRegression, TemplateImages,
                        ZipfianTokenStream)

__all__ = ["GaussianMixtureImages", "ShardedLoader", "SyntheticTokenStream",
           "TeacherStudentRegression", "TemplateImages", "ZipfianTokenStream",
           "stack_learner_batches"]
