"""Fixtures of the harness's tests: the program on ``sys.path``, and a copy
of portbench/'s data folders with tiny cells added as files alone."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
if str(CHECKOUT / "src") not in sys.path:
    sys.path.insert(0, str(CHECKOUT / "src"))
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

TINY_DENSE = {
    "source": "test", "reduced": [], "family": "dense", "n_layers": 2,
    "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
    "d_ff": 96, "vocab": 256, "rope_theta": 10000.0, "norm_eps": 1e-6,
    "tie_embeddings": False, "dtype": "float32",
    "port": {"attn_chunk": 16}}

TINY_HYBRID = {
    "source": "test", "reduced": [], "model_type": "jamba",
    "hidden_size": 64, "intermediate_size": 96, "num_hidden_layers": 8,
    "num_attention_heads": 4, "num_key_value_heads": 2, "num_experts": 4,
    "num_experts_per_tok": 2, "expert_layer_period": 2,
    "expert_layer_offset": 1, "attn_layer_period": 8,
    "attn_layer_offset": 4, "mamba_d_state": 8, "mamba_d_conv": 4,
    "mamba_expand": 2, "mamba_dt_rank": 4, "vocab_size": 256,
    "rms_norm_eps": 1e-6, "sliding_window": None,
    "tie_word_embeddings": False, "dtype": "float32",
    "port": {"capacity_factor": 2.0}}

TINY_TRAIN = {
    "kind": "train", "learners": 4, "local_batch": 2, "seq": 32,
    "topology": "random_pair", "lr": 0.1, "momentum": 0.9,
    "warmup_steps": 10, "lr_scale": 1.0, "attention": "chunked",
    "check_steps": 3, "pool": 4, "trace_steps": 2}

TINY_SERVE = {
    "kind": "serve_closed", "slots": 4, "page": 8, "max_len": 64,
    "clients": 6, "prompt": {"median": 8, "sigma": 1.0, "min": 2,
                             "max": 24},
    "output": {"median": 6, "sigma": 0.8, "min": 2, "max": 24},
    "sizes": 32, "ramp_steps": 6, "check": {"requests": 4},
    "trace_steps": 3}

TINY_LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e-4, "delta_gap": 1e-4,
               "served_gap_mean": 1e-3}


def _write(root: Path, kind: str, name: str, obj: dict) -> None:
    (root / kind / f"{name}.json").write_text(json.dumps(obj))


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    """portbench/'s folders copied to a temporary root, plus the tiny
    configurations, mixes and cells ``tiny.train`` / ``tiny.serve``, and
    ``spec.ROOT`` pointed at it."""
    from portbench import spec
    root = tmp_path / "portbench"
    for kind in ("configs", "workloads", "traffic", "metrics"):
        shutil.copytree(spec.ROOT / kind, root / kind)
    _write(root, "configs", "tiny-dense", TINY_DENSE)
    _write(root, "configs", "tiny-hybrid", TINY_HYBRID)
    _write(root, "traffic", "tiny_train", TINY_TRAIN)
    _write(root, "traffic", "tiny_serve", TINY_SERVE)
    _write(root, "workloads", "tiny.train", {
        "config": "tiny-dense", "traffic": "tiny_train", "chips": 1,
        "why": "test", "limits": TINY_LIMITS})
    _write(root, "workloads", "tiny.serve", {
        "config": "tiny-hybrid", "traffic": "tiny_serve", "chips": 1,
        "why": "test", "limits": TINY_LIMITS})
    monkeypatch.setattr(spec, "ROOT", root)
    return root


@pytest.fixture
def cuda():
    """Skips a test that needs the card, decided when the test runs."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the chip)")
