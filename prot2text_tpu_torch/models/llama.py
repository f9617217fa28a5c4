"""Llama-3.x decoder — thin config wrapper over the shared decoder core
(counterpart of prot2text_tpu/models/llama.py)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .decoder import DecoderConfig, init_decoder_params


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 2048
    num_layers: int = 16
    num_heads: int = 32
    num_kv_heads: int = 8
    intermediate_size: int = 8192
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    tie_word_embeddings: bool = True
    rope_scaling: Optional[str] = "llama3"
    rope_scaling_factor: float = 32.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192
    bos_token_id: int = 128000
    eos_token_id: int = 128009
    pad_token_id: int = 128002
    placeholder_id: int = 128003

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

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
            qk_norm=False,
            rope_scaling=self.rope_scaling,
            rope_scaling_factor=self.rope_scaling_factor,
            rope_low_freq_factor=self.rope_low_freq_factor,
            rope_high_freq_factor=self.rope_high_freq_factor,
            rope_original_max_position=self.rope_original_max_position,
        )

    @classmethod
    def llama_3_2_1b(cls):
        """The dataclass defaults: hidden 2048, 16 layers, 32 heads of 64,
        8 kv heads, tied embeddings, llama3 rope scaling 32."""
        return cls()

    @classmethod
    def llama_3_1_8b(cls):
        return cls(hidden_size=4096, num_layers=32, num_heads=32,
                   num_kv_heads=8, intermediate_size=14336,
                   tie_word_embeddings=False, rope_scaling_factor=8.0)

    @classmethod
    def tiny(cls, vocab_size: int = 256):
        """Test-scale config (no rope scaling)."""
        return cls(vocab_size=vocab_size, hidden_size=64, num_layers=2,
                   num_heads=4, num_kv_heads=2, intermediate_size=128,
                   rope_theta=10000.0, tie_word_embeddings=False,
                   rope_scaling=None)


def init_llama_params(cfg: LlamaConfig, *, generator, device,
                      dtype=torch.float32):
    return init_decoder_params(cfg.core(), generator=generator,
                               device=device, dtype=dtype)
