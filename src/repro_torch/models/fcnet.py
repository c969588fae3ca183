"""The paper's MNIST network (Sec. 2): fully connected, two hidden layers of
50 units — the port of ``repro/models/fcnet.py``.  Parameters are a dict of
tensors with the reference's keys and (d_in, d_out) orientation."""
from __future__ import annotations

import torch

from .layers import cross_entropy, dense_init


def init_params(gen: torch.Generator, in_dim: int = 784, hidden: int = 50,
                n_classes: int = 10):
    """Random weights drawn from ``gen`` on ``gen.device`` (the reference's
    distributions; not its draws)."""
    dev, f32 = gen.device, torch.float32
    return {
        "w1": dense_init(gen, in_dim, hidden, f32),
        "b1": torch.zeros((hidden,), device=dev),
        "w2": dense_init(gen, hidden, hidden, f32),
        "b2": torch.zeros((hidden,), device=dev),
        "w3": dense_init(gen, hidden, n_classes, f32),
        "b3": torch.zeros((n_classes,), device=dev),
    }


def apply(params, images):
    x = images.reshape(images.shape[0], -1)
    x = torch.relu(x @ params["w1"] + params["b1"])
    x = torch.relu(x @ params["w2"] + params["b2"])
    return x @ params["w3"] + params["b3"]


def loss_fn(params, batch):
    logits = apply(params, batch["image"])
    return cross_entropy(logits, batch["label"])


def accuracy(params, batch):
    logits = apply(params, batch["image"])
    return torch.mean((torch.argmax(logits, -1)
                       == batch["label"].long()).float())
