from .adapters import ModalityAdapterConfig, modality_adapter
from .composed import (
    Esm2LlamaConfig, Esm2LlamaForCausalLM, Esm2LlamaInstructConfig,
    Esm2LlamaInstructForCausalLM,
)
from .decoder import DecoderConfig, decoder_forward, decoder_logits
from .esm2 import ESM2Config, esm2_encode
from .llama import LlamaConfig
from .weights import ParamTree, params_from_jax

__all__ = [
    "DecoderConfig", "ESM2Config", "Esm2LlamaConfig", "Esm2LlamaForCausalLM",
    "Esm2LlamaInstructConfig",
    "Esm2LlamaInstructForCausalLM", "LlamaConfig", "ModalityAdapterConfig",
    "ParamTree", "decoder_forward", "decoder_logits", "esm2_encode",
    "modality_adapter", "params_from_jax",
]
