"""Synthetic datasets standing in for the paper's data — the port of
``repro/data/synthetic.py``:

  * ``GaussianMixtureImages``: a K-class gaussian mixture in pixel space
    (28 x 28 x 1 by default, MNIST-like);
  * ``SyntheticTokenStream``: LM tokens from a random low-rank bigram
    teacher;
  * ``ZipfianTokenStream``: tokens with zipfian marginals, p(c) ~
    1 / (c + 1)^alpha (the ASR label skew the paper calls out);
  * ``TemplateImages``: MNIST-faithful uncentered templates (Fig. 2);
  * ``TeacherStudentRegression``: a linear teacher plus noise.

They follow the reference's distributions, not its draws: the fixed tables
(class means, class templates, the bigram teacher, the regression teacher,
the Zipf law) come from a CPU ``torch.Generator`` seeded with the
dataset's ``seed`` and are moved once to each device that asks; a batch is
drawn from the generator the caller passes, on that generator's device.
"""
from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

import torch


@lru_cache(maxsize=16)
def _templates(seed: int, n_classes: int, dim: int, density: float,
               device: str) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    t = (torch.rand((n_classes, dim), generator=gen) > 1.0 - density)
    return t.to(torch.float32).to(device)


@lru_cache(maxsize=16)
def _means(seed: int, n_classes: int, dim: int, class_sep: float,
           device: str) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    m = torch.randn((n_classes, dim), generator=gen)
    return (class_sep * m / torch.linalg.norm(m, dim=1, keepdim=True)
            ).to(device)


@lru_cache(maxsize=16)
def _zipf(vocab: int, alpha: float, device: str) -> torch.Tensor:
    """p(c) ~ (c + 1)^-alpha over the vocabulary, normalized in float64."""
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64)
    p = torch.exp(-alpha * torch.log(ranks))
    return (p / p.sum()).to(torch.float32).to(device)


@lru_cache(maxsize=16)
def _regression_teacher(seed: int, dim: int, scale: float,
                        device: str) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return (scale * torch.randn((dim, 1), generator=gen)).to(device)


@lru_cache(maxsize=16)
def _teacher(seed: int, vocab: int, rank: int, device: str):
    gen = torch.Generator().manual_seed(seed)
    a = torch.randn((vocab, rank), generator=gen) / math.sqrt(rank)
    b = torch.randn((rank, vocab), generator=gen) / math.sqrt(rank)
    return a.to(device), b.to(device)


@dataclasses.dataclass(frozen=True)
class GaussianMixtureImages:
    """K-class gaussian mixture in pixel space: class means of norm
    ``class_sep``, isotropic noise of standard deviation ``noise``."""
    n_classes: int = 10
    height: int = 28
    width: int = 28
    channels: int = 1
    class_sep: float = 2.0      # each class mean's norm
    noise: float = 1.0
    seed: int = 0

    @property
    def dim(self):
        return self.height * self.width * self.channels

    def means(self, device="cpu") -> torch.Tensor:
        """(n_classes, dim) float32 class means on ``device``."""
        return _means(self.seed, self.n_classes, self.dim, self.class_sep,
                      str(torch.device(device)))

    def sample(self, gen: torch.Generator, batch: int):
        """-> {'image': (B, H, W, C) float32, 'label': (B,) int32}, on
        ``gen.device``."""
        dev = gen.device
        labels = torch.randint(0, self.n_classes, (batch,), generator=gen,
                               device=dev)
        x = self.means(dev)[labels] + self.noise * torch.randn(
            (batch, self.dim), generator=gen, device=dev)
        return {"image": x.reshape(batch, self.height, self.width,
                                   self.channels),
                "label": labels.to(torch.int32)}


@dataclasses.dataclass(frozen=True)
class TemplateImages:
    """MNIST-faithful stand-in: uncentered [0, 1] pixels with sparse class
    templates (the regime where the paper's Fig. 2a separation — SSGD
    fails at a large lr, DPSGD converges — reproduces)."""
    n_classes: int = 10
    dim: int = 784
    template_density: float = 0.2
    base: float = 0.2
    noise: float = 0.2
    signal: float = 0.8
    seed: int = 5

    def sample(self, gen: torch.Generator, batch: int):
        """-> {'image': (B, 28, 28, 1) float32 (or (B, dim)), 'label': (B,)
        int32}, on ``gen.device``."""
        dev = gen.device
        tmpl = _templates(self.seed, self.n_classes, self.dim,
                          self.template_density, str(dev))
        lab = torch.randint(0, self.n_classes, (batch,), generator=gen,
                            device=dev)
        noise = torch.randn((batch, self.dim), generator=gen, device=dev)
        x = torch.clamp(self.base + self.noise * noise
                        + self.signal * tmpl[lab], 0.0, 1.0)
        return {"image": (x.reshape(batch, 28, 28, 1) if self.dim == 784
                          else x),
                "label": lab.to(torch.int32)}


@dataclasses.dataclass(frozen=True)
class SyntheticTokenStream:
    """LM batches from a fixed random low-rank bigram teacher: next-token
    logits are a function of the current token, so the task has learnable
    structure and a non-trivial loss floor."""
    vocab: int = 1024
    rank: int = 64
    temperature: float = 1.0
    seed: int = 0

    def sample(self, gen: torch.Generator, batch: int, seq_len: int):
        """-> {'tokens': (B, S) int32, 'labels': (B, S) int32, 'mask':
        (B, S) float32}; labels[t] = tokens[t + 1].  Each next token is
        drawn by the Gumbel-max rule on the teacher's logits."""
        dev = gen.device
        a, b = _teacher(self.seed, self.vocab, self.rank, str(dev))
        tok = torch.randint(0, self.vocab, (batch,), generator=gen,
                            device=dev)
        toks = [tok]
        for _ in range(seq_len):
            logits = (a[tok] @ b) / self.temperature
            u = torch.rand(logits.shape, generator=gen, device=dev)
            tok = torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
            toks.append(tok)
        toks = torch.stack(toks, dim=1).to(torch.int32)      # (B, S + 1)
        return {"tokens": toks[:, :-1].contiguous(),
                "labels": toks[:, 1:].contiguous(),
                "mask": torch.ones((batch, seq_len), dtype=torch.float32,
                                   device=dev)}


@dataclasses.dataclass(frozen=True)
class ZipfianTokenStream:
    """Highly uneven class marginals (the ASR stress case): every token
    drawn independently with p(c) ~ 1 / (c + 1)^alpha."""
    vocab: int = 32000
    alpha: float = 1.2
    seed: int = 0

    def sample(self, gen: torch.Generator, batch: int, seq_len: int):
        """-> {'tokens': (B, S) int32, 'labels': (B, S) int32, 'mask':
        (B, S) float32}; labels[t] = tokens[t + 1].  One
        ``torch.multinomial`` over the vocabulary draws all B (S + 1)
        tokens (no (B, S + 1, vocab) table of logits)."""
        dev = gen.device
        p = _zipf(self.vocab, self.alpha, str(dev))
        toks = torch.multinomial(p, batch * (seq_len + 1), replacement=True,
                                 generator=gen)
        toks = toks.reshape(batch, seq_len + 1).to(torch.int32)
        return {"tokens": toks[:, :-1].contiguous(),
                "labels": toks[:, 1:].contiguous(),
                "mask": torch.ones((batch, seq_len), dtype=torch.float32,
                                   device=dev)}


@dataclasses.dataclass(frozen=True)
class TeacherStudentRegression:
    """y = x W + noise, x ~ N(0, I): a clean landscape-control task."""
    dim: int = 32
    teacher_scale: float = 1.0
    noise: float = 0.01
    seed: int = 0

    def teacher(self, device="cpu") -> torch.Tensor:
        """The (dim, 1) float32 teacher W on ``device``."""
        return _regression_teacher(self.seed, self.dim, self.teacher_scale,
                                   str(torch.device(device)))

    def sample(self, gen: torch.Generator, batch: int):
        """-> {'x': (B, dim), 'y': (B, 1)} float32, on ``gen.device``."""
        dev = gen.device
        x = torch.randn((batch, self.dim), generator=gen, device=dev)
        y = x @ self.teacher(dev) + self.noise * torch.randn(
            (batch, 1), generator=gen, device=dev)
        return {"x": x, "y": y}
