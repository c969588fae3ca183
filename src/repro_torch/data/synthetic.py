"""Synthetic datasets standing in for the paper's data — the port of
``TemplateImages`` and ``SyntheticTokenStream`` from
``repro/data/synthetic.py``.

They follow the reference's distributions, not its draws: the fixed tables
(class templates, the bigram teacher) come from a CPU ``torch.Generator``
seeded with the dataset's ``seed`` and are moved once to each device that
asks; a batch is drawn from the generator the caller passes, on that
generator's device.
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
def _teacher(seed: int, vocab: int, rank: int, device: str):
    gen = torch.Generator().manual_seed(seed)
    a = torch.randn((vocab, rank), generator=gen) / math.sqrt(rank)
    b = torch.randn((rank, vocab), generator=gen) / math.sqrt(rank)
    return a.to(device), b.to(device)


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
