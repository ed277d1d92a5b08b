"""Deterministic, stateless calibration data. Port of
``repro/data/pipeline.py``: tokens, for an encoder-decoder config each
sample's encoder input (frame embeddings, the audio frontend's stub), and
for a vision config its patch embeddings (the vision tower's stub).

``step -> batch`` is a pure function of ``(seed, step)``: row ``i`` of
step ``s`` is calibration sample ``(s * global_batch + i) %
n_calibration_samples``, and each sample draws its tokens from a
``torch.Generator`` of its own, seeded from ``(seed, sample)``, its
encoder input from another, seeded from ``(seed, sample, 1)``, and its
patches from a third, seeded from ``(seed, sample, 2)`` (the reference
folds the sample's key with 1 and 2 likewise). So a
sample is the same whatever batch it lands in, and there is no loader
state to checkpoint. The bits are the port's own: the reference's
threefry stream cannot be reproduced, so parity tests pass the
reference's batch in.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.core.rram import make_generator


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # calibration set size: batches cycle over this many distinct samples
    # (paper: 10). 0 -> unlimited fresh stream.
    n_calibration_samples: int = 10
    # encoder-decoder: the frames (and their width) of each sample's encoder
    # input; a vision config: its patches (of the same width)
    enc_src_len: int = 0
    d_model: int = 0
    vision_tokens: int = 0


def sample_tokens(cfg: DataConfig, sample: int) -> torch.Tensor:
    """The ``(seq_len,)`` int64 tokens of calibration sample ``sample``."""
    g = make_generator("cpu", cfg.seed, sample)
    return torch.randint(0, cfg.vocab, (cfg.seq_len,), generator=g)


def sample_enc_embeds(cfg: DataConfig, sample: int) -> torch.Tensor:
    """The ``(enc_src_len, d_model)`` f32 standard normals of sample
    ``sample``'s encoder input."""
    g = make_generator("cpu", cfg.seed, sample, 1)
    return torch.randn((cfg.enc_src_len, cfg.d_model), generator=g)


def sample_patch_embeds(cfg: DataConfig, sample: int) -> torch.Tensor:
    """The ``(vision_tokens, d_model)`` f32 standard normals of sample
    ``sample``'s patches."""
    g = make_generator("cpu", cfg.seed, sample, 2)
    return torch.randn((cfg.vision_tokens, cfg.d_model), generator=g)


def global_batch_at_step(cfg: DataConfig, step: int) -> Dict[str, torch.Tensor]:
    """The whole global batch for ``step``, on the CPU:
    ``{"tokens": (global_batch, seq_len) int64}``; with ``enc_src_len``
    and ``d_model`` set ``"enc_embeds"`` (global_batch, enc_src_len,
    d_model) f32, with ``vision_tokens`` and ``d_model`` set
    ``"patch_embeds"`` (global_batch, vision_tokens, d_model) f32."""
    n = cfg.n_calibration_samples or (1 << 31)
    samples = [r % n for r in range(step * cfg.global_batch, (step + 1) * cfg.global_batch)]
    out = {"tokens": torch.stack([sample_tokens(cfg, i) for i in samples])}
    if cfg.enc_src_len and cfg.d_model:
        out["enc_embeds"] = torch.stack([sample_enc_embeds(cfg, i) for i in samples])
    if cfg.vision_tokens and cfg.d_model:
        out["patch_embeds"] = torch.stack([sample_patch_embeds(cfg, i) for i in samples])
    return out
