"""Deterministic, restartable synthetic data pipeline, the port of
``repro.train.data``.

Every batch is a pure function of (seed, step, host): after a preemption
the pipeline resumes from the checkpointed step with no coordination, on
any number of hosts (each host draws its own shard by host index). The
port cannot draw ``jax.random`` keys, so its numbers are not the JAX
package's: it draws from a CPU ``torch.Generator`` seeded from (seed,
step, host_index) and moves the batch to the device, which gives the
same batch on the CPU and on the card. Shapes, dtypes and the
Markov-like token stream follow the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig


def _generator(seed: int, step: int, host_index: int) -> torch.Generator:
    """A CPU generator whose state depends on (seed, step, host) alone."""
    word = np.random.SeedSequence([seed, step, host_index]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(word))


@dataclasses.dataclass
class SyntheticLM:
    cfg: ModelConfig
    seq_len: int
    global_batch: int
    seed: int = 0
    device: Optional[Union[str, torch.device]] = None  # default: the card

    def batch_at(self, step: int, host_index: int = 0,
                 host_count: int = 1) -> Dict[str, torch.Tensor]:
        """This host's share of the global batch of ``step``."""
        b = self.global_batch // host_count
        vocab = self.cfg.vocab
        g = _generator(self.seed, step, host_index)
        # Markov-ish structured stream: the next token depends on the
        # current one (so the LM has something learnable)
        base = torch.randint(0, vocab, (b, self.seq_len + 1), generator=g)
        drift = torch.randint(1, 17, (b, 1), generator=g)
        pos = torch.arange(1, self.seq_len + 2).expand(b, -1)
        seq = (pos * drift + base // 7) % vocab
        tokens = seq[:, :-1].to(torch.int32)
        labels = seq[:, 1:].to(torch.int32)
        batch = {"tokens": tokens, "labels": labels}
        if self.cfg.frontend == "audio_frames":
            batch = {"embeds": 0.02 * torch.randn(
                (b, self.seq_len, self.cfg.d_model), generator=g),
                "labels": labels}
        elif self.cfg.frontend == "vision_patches":
            ft = self.cfg.frontend_tokens
            batch["embeds"] = 0.02 * torch.randn((b, ft, self.cfg.d_model),
                                                 generator=g)
        dev = resolve_device(self.device)
        return {k: v.to(dev) for k, v in batch.items()}


def batch_specs(cfg: ModelConfig, seq_len: int, global_batch: int,
                kind: str = "train", dtype=torch.bfloat16):
    """Every model input on the ``meta`` device (shapes and dtypes)."""
    b, s = global_batch, seq_len
    i32 = torch.int32

    def spec(shape, dt=i32):
        return torch.empty(shape, dtype=dt, device="meta")

    ft = cfg.frontend_tokens
    if kind == "train":
        out = {"tokens": spec((b, s)), "labels": spec((b, s))}
        if cfg.frontend == "audio_frames":
            out = {"embeds": spec((b, s, cfg.d_model), dtype),
                   "labels": spec((b, s))}
        elif cfg.frontend == "vision_patches":
            out = {"tokens": spec((b, s - ft)), "labels": spec((b, s - ft)),
                   "embeds": spec((b, ft, cfg.d_model), dtype)}
        return out
    if kind == "prefill":
        out = {"tokens": spec((b, s))}
        if cfg.frontend == "audio_frames":
            out = {"embeds": spec((b, s, cfg.d_model), dtype)}
        elif cfg.frontend == "vision_patches":
            out = {"tokens": spec((b, s - ft)),
                   "embeds": spec((b, ft, cfg.d_model), dtype)}
        return out
    if kind == "decode":
        return {"tokens": spec((b, 1))}
    raise ValueError(kind)
