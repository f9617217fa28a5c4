"""Chat-template rendering + a dependency-free byte-level text tokenizer.

The port's own copy of prot2text_tpu/data/chat.py (numpy only, no JAX);
names and behaviour are kept so the two packages collate alike.


The reference calls `tokenizer.apply_chat_template` (HF fast tokenizer,
dataset/dataset.py:376-385, dataloader_light.py:211-219).  Here templates are
rendered to strings by family and then tokenized by whatever text tokenizer
the caller provides (an HF tokenizer when checkpoints are available, or the
built-in ByteTextTokenizer for fully offline runs/tests).

System/user message defaults match the reference exactly
(dataset/dataset.py:181-187).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Protocol, Sequence

import numpy as np

SYSTEM_MESSAGE = (
    "You are a scientific assistant specialized in protein function "
    "predictions. Given the sequence embeddings and other information "
    "of a protein, describe its function clearly and concisely in "
    "professional language. "
)

LLAMA3_PLACEHOLDER_TOKEN = "<|reserved_special_token_1|>"


def llama3_chat_prompt(system: str, user: str) -> str:
    """Llama-3.1 chat template with generation prompt (the exact string HF's
    apply_chat_template(add_generation_prompt=True) renders)."""
    return (
        "<|begin_of_text|>"
        "<|start_header_id|>system<|end_header_id|>\n\n" + system + "<|eot_id|>"
        "<|start_header_id|>user<|end_header_id|>\n\n" + user + "<|eot_id|>"
        "<|start_header_id|>assistant<|end_header_id|>\n\n"
    )


def qwen3_chat_prompt(system: str, user: str,
                      enable_thinking: bool = True) -> str:
    """Qwen3 chat template with generation prompt."""
    s = (
        "<|im_start|>system\n" + system + "<|im_end|>\n"
        "<|im_start|>user\n" + user + "<|im_end|>\n"
        "<|im_start|>assistant\n"
    )
    if not enable_thinking:
        s += "<think>\n\n</think>\n\n"
    return s


def protein_user_message(fullname: str, taxon: str, n_placeholders: int,
                         placeholder_token: str,
                         include_text_fields: bool = True,
                         light_style: bool = False) -> str:
    """User message for both dataset flavours:
      * PyG instruct dataset (dataset.py:369-374): "Protein name: X ; Taxon:
        Y ; Sequence embeddings: " + placeholder×N
      * light collater (dataloader_light.py:185-199): "Protein name: X;
        Taxon: Y; Sequence embeddings: " + placeholder×N
    """
    ph = placeholder_token * n_placeholders
    if not include_text_fields:
        return "Sequence embeddings: " + ph
    if light_style:
        return (f"Protein name: {fullname}; Taxon: {taxon}; "
                "Sequence embeddings: " + ph)
    return ("Protein name: " + fullname + " ; Taxon: " + taxon
            + " ; Sequence embeddings: " + ph)


class TextTokenizer(Protocol):
    """Minimal duck type shared by HF tokenizers and ByteTextTokenizer."""

    pad_token_id: int
    eos_token_id: int
    bos_token_id: int

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]: ...

    def decode(self, ids, skip_special_tokens: bool = True) -> str: ...


@dataclasses.dataclass
class ByteTextTokenizer:
    """Byte-level tokenizer with Llama-style special tokens — makes the whole
    pipeline runnable with zero downloaded assets.  Byte b ↦ id b; special
    tokens occupy ids ≥ 256."""

    bos_token: str = "<|begin_of_text|>"
    eos_token: str = "<|eot_id|>"
    pad_token: str = "<|pad|>"
    placeholder_token: str = LLAMA3_PLACEHOLDER_TOKEN

    def __post_init__(self):
        specials = [
            self.bos_token, self.eos_token, self.pad_token,
            self.placeholder_token,
            "<|start_header_id|>", "<|end_header_id|>",
            "<|im_start|>", "<|im_end|>",
        ]
        self._special2id = {t: 256 + i for i, t in enumerate(specials)}
        self._id2special = {i: t for t, i in self._special2id.items()}
        self.bos_token_id = self._special2id[self.bos_token]
        self.eos_token_id = self._special2id[self.eos_token]
        self.pad_token_id = self._special2id[self.pad_token]
        self.placeholder_id = self._special2id[self.placeholder_token]

    @property
    def vocab_size(self) -> int:
        return 256 + len(self._special2id)

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        ids: List[int] = []
        if add_special_tokens:
            ids.append(self.bos_token_id)
        i = 0
        while i < len(text):
            matched = None
            if text[i] == "<":
                for tok, tid in self._special2id.items():
                    if text.startswith(tok, i):
                        matched = (tok, tid)
                        break
            if matched:
                ids.append(matched[1])
                i += len(matched[0])
            else:
                ids.extend(text[i].encode("utf-8"))
                i += 1
        return ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        out: List[str] = []
        buf: List[int] = []

        def flush():
            if buf:
                out.append(bytes(buf).decode("utf-8", errors="replace"))
                buf.clear()

        for i in np.asarray(ids).reshape(-1).tolist():
            i = int(i)
            if i >= 256:
                flush()
                if not skip_special_tokens and i in self._id2special:
                    out.append(self._id2special[i])
            else:
                buf.append(i)
        flush()
        return "".join(out)

    def batch_decode(self, batch, skip_special_tokens: bool = True):
        return [self.decode(row, skip_special_tokens) for row in batch]
