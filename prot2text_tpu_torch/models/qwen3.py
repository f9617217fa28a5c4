"""Qwen3 decoder — per-head q/k RMSNorm on top of the shared decoder core
(counterpart of prot2text_tpu/models/qwen3.py)."""

from __future__ import annotations

import dataclasses

import torch

from .decoder import DecoderConfig, init_decoder_params


@dataclasses.dataclass(frozen=True)
class Qwen3Config:
    vocab_size: int = 151936
    hidden_size: int = 5120
    num_layers: int = 40
    num_heads: int = 40
    num_kv_heads: int = 8
    head_dim: int = 128
    intermediate_size: int = 17408
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    tie_word_embeddings: bool = False
    # Qwen3 chat special ids
    eos_token_id: int = 151645
    pad_token_id: int = 151643

    def core(self) -> DecoderConfig:
        return DecoderConfig(
            vocab_size=self.vocab_size,
            hidden_size=self.hidden_size,
            num_layers=self.num_layers,
            num_heads=self.num_heads,
            num_kv_heads=self.num_kv_heads,
            intermediate_size=self.intermediate_size,
            head_dim=self.head_dim,
            rms_norm_eps=self.rms_norm_eps,
            rope_theta=self.rope_theta,
            tie_word_embeddings=self.tie_word_embeddings,
            qk_norm=True,
        )

    @classmethod
    def qwen3_14b(cls):
        return cls()

    @classmethod
    def qwen3_0_6b(cls):
        """Qwen3-0.6B, the same-tokenizer draft model for Qwen3-14B."""
        return cls(hidden_size=1024, num_layers=28, num_heads=16,
                   num_kv_heads=8, head_dim=128, intermediate_size=3072,
                   tie_word_embeddings=True)

    @classmethod
    def tiny(cls, vocab_size: int = 256):
        return cls(vocab_size=vocab_size, hidden_size=64, num_layers=2,
                   num_heads=4, num_kv_heads=2, head_dim=16,
                   intermediate_size=128, tie_word_embeddings=False)


def init_qwen3_params(cfg: Qwen3Config, *, generator, device,
                      dtype=torch.float32):
    return init_decoder_params(cfg.core(), generator=generator,
                               device=device, dtype=dtype)
