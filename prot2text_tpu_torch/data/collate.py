"""Batch collators reproducing the reference's three padding layouts.

The port's own copy of prot2text_tpu/data/collate.py (numpy only, no JAX);
names and behaviour are kept so the two packages collate alike.


All three emit numpy arrays with the exact layouts of the reference docstring
diagrams, plus optional LENGTH BUCKETING (pad widths rounded up to a fixed
bucket list) so jitted TPU steps see a small closed set of shapes — the
recompilation-control requirement of SURVEY.md §7 hard part #4, which the
reference does not need on GPUs (dataloader.py:213 pads to the batch max).

  * InstructCollator  — dataset/dataloader.py:84-301:
        train:      ids=[left-pad+prompt ‖ description+eot+right-pad]
                    labels=[-100… ‖ description+eot+-100…]
        inference:  prompt only (left-padded) + descriptions for eval
  * DerivedCollator  — dataset/dataloader_derived.py:97-347: fixed prompt
        sentence wrapped bos+prompt+bos, sequences LEFT-padded, instruct-eos
        rewritten to the base model's eos, decoded descriptions included
  * LightCollator    — dataset/dataloader_light.py:97-280: on-the-fly chat
        composition from CSV rows with name/taxonomy dropout, random crop of
        long sequences, placeholder count from real ESM tokenization
"""

from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Literal, Optional, Sequence

import numpy as np

from .chat import (
    SYSTEM_MESSAGE, TextTokenizer, llama3_chat_prompt, protein_user_message,
    qwen3_chat_prompt,
)
from .tokenization import ProteinTokenizer


def pad_stack(seqs: Sequence[np.ndarray], pad_value, side: str = "right",
              width: Optional[int] = None) -> np.ndarray:
    """Reference `_pad_sequence` (dataloader.py:199-228) + optional fixed
    width for bucketing."""
    maxlen = max(len(s) for s in seqs)
    if width is not None:
        maxlen = max(maxlen, width)
    out = np.full((len(seqs), maxlen), pad_value,
                  dtype=np.asarray(seqs[0]).dtype)
    for i, s in enumerate(seqs):
        if side == "right":
            out[i, :len(s)] = s
        elif side == "left":
            out[i, maxlen - len(s):] = s
        else:
            raise ValueError(side)
    return out


def bucket_width(n: int, buckets: Optional[Sequence[int]]) -> Optional[int]:
    if not buckets:
        return None
    for b in sorted(buckets):
        if n <= b:
            return b
    return max(buckets)


@dataclasses.dataclass
class Buckets:
    """Length buckets per field; None = pad to batch max (reference parity)."""

    protein: Optional[Sequence[int]] = None
    prompt: Optional[Sequence[int]] = None
    description: Optional[Sequence[int]] = None


# ---------------------------------------------------------------------------


@dataclasses.dataclass
class InstructCollator:
    """Collates pre-tokenized records {sequence_input_ids, prompt_input_ids,
    description_input_ids, (graph fields), name}."""

    text_pad_token_id: int
    seq_pad_token_id: int = 1
    mode: Literal["train", "inference"] = "train"
    buckets: Buckets = dataclasses.field(default_factory=Buckets)

    def __call__(self, batch: List[Dict]) -> Dict[str, np.ndarray]:
        seqs = [np.asarray(d["sequence_input_ids"]).reshape(-1) for d in batch]
        prompts = [np.asarray(d["prompt_input_ids"]).reshape(-1) for d in batch]
        descs = [np.asarray(d["description_input_ids"]).reshape(-1)
                 for d in batch]

        pw = bucket_width(max(len(s) for s in seqs), self.buckets.protein)
        seq_ids = pad_stack(seqs, self.seq_pad_token_id, "right", pw)
        seq_mask = pad_stack([np.ones_like(s) for s in seqs], 0, "right", pw)

        ppw = bucket_width(max(len(p) for p in prompts), self.buckets.prompt)
        prompt_ids = pad_stack(prompts, self.text_pad_token_id, "left", ppw)
        prompt_mask = pad_stack([np.ones_like(p) for p in prompts], 0,
                                "left", ppw)

        dw = bucket_width(max(len(d) for d in descs), self.buckets.description)
        desc_ids = pad_stack(descs, self.text_pad_token_id, "right", dw)
        desc_mask = pad_stack([np.ones_like(d) for d in descs], 0, "right", dw)
        desc_labels = pad_stack(descs, -100, "right", dw)

        out = {
            "name": [d.get("name") for d in batch],
            "protein_input_ids": seq_ids,
            "protein_attention_mask": seq_mask,
            "description_input_ids": desc_ids,
            "description_attention_mask": desc_mask,
        }
        if self.mode == "train":
            out.update({
                "input_ids": np.concatenate([prompt_ids, desc_ids], axis=1),
                "attention_mask": np.concatenate(
                    [prompt_mask, desc_mask], axis=1),
                "labels": np.concatenate(
                    [np.full_like(prompt_ids, -100), desc_labels], axis=1),
            })
        elif self.mode == "inference":
            out.update({
                "input_ids": prompt_ids,
                "attention_mask": prompt_mask,
            })
        else:
            raise ValueError(self.mode)
        return out


# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DerivedCollator:
    """Adapts instruct-preprocessed records to the legacy base model
    (dataloader_derived.py).  Fixed prompt = bos+sentence+bos; sequences
    LEFT-padded; instruct eot (128009) rewritten to the base eos."""

    tokenizer: TextTokenizer
    original_eos_token_id: int
    prompt_sentence: str = ("Predict protein description based on the "
                            "amino-acid sequence embeddings.")
    seq_pad_token_id: int = 1
    mode: Literal["train", "inference"] = "train"
    buckets: Buckets = dataclasses.field(default_factory=Buckets)

    def __post_init__(self):
        bos = self.tokenizer.bos_token_id
        body = self.tokenizer.encode(self.prompt_sentence,
                                     add_special_tokens=False)
        self.prompt_input_ids = np.asarray([bos] + body + [bos])

    def __call__(self, batch: List[Dict]) -> Dict[str, np.ndarray]:
        seqs = [np.asarray(d["sequence_input_ids"]).reshape(-1) for d in batch]
        descs = [np.asarray(d["description_input_ids"]).reshape(-1)
                 for d in batch]
        B = len(batch)

        pw = bucket_width(max(len(s) for s in seqs), self.buckets.protein)
        seq_ids = pad_stack(seqs, self.seq_pad_token_id, "left", pw)
        seq_mask = pad_stack([np.ones_like(s) for s in seqs], 0, "left", pw)

        prompt_ids = np.tile(self.prompt_input_ids[None, :], (B, 1))
        prompt_mask = np.ones_like(prompt_ids)

        dw = bucket_width(max(len(d) for d in descs), self.buckets.description)
        desc_ids = pad_stack(descs, self.tokenizer.pad_token_id, "right", dw)
        desc_mask = pad_stack([np.ones_like(d) for d in descs], 0, "right", dw)
        labels = pad_stack(descs, -100, "right", dw)

        # eos rewrite (dataloader_derived.py:174-182)
        new_eos = self.tokenizer.eos_token_id
        desc_ids = np.where(desc_ids == self.original_eos_token_id,
                            new_eos, desc_ids)
        labels = np.where(labels == self.original_eos_token_id,
                          new_eos, labels)

        descriptions = [
            self.tokenizer.decode(d, skip_special_tokens=True) for d in descs]

        out = {
            "name": [d.get("name") for d in batch],
            "protein_input_ids": seq_ids,
            "protein_attention_mask": seq_mask,
            "description_input_ids": desc_ids,
            "description_attention_mask": desc_mask,
        }
        if self.mode == "train":
            out.update({
                "input_ids": np.concatenate([prompt_ids, desc_ids], axis=1),
                "attention_mask": np.concatenate(
                    [prompt_mask, desc_mask], axis=1),
                "labels": np.concatenate(
                    [np.full_like(prompt_ids, -100), labels], axis=1),
                "descriptions": descriptions,
            })
        elif self.mode == "inference":
            out.update({
                "input_ids": prompt_ids,
                "attention_mask": prompt_mask,
            })
        else:
            raise ValueError(self.mode)
        return out


# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LightCollator:
    """On-the-fly collation from raw CSV rows for ESMCQwen
    (dataloader_light.py:97-280)."""

    tokenizer: TextTokenizer
    protein_tokenizer: ProteinTokenizer = dataclasses.field(
        default_factory=ProteinTokenizer)
    mode: Literal["train", "inference"] = "train"
    include_text_fields: bool = True
    name_dropout: float = 0.8
    taxonomy_dropout: float = 0.8
    max_sequence_length: int = 1021
    max_description_length: int = 512
    system_message: str = SYSTEM_MESSAGE
    placeholder_token: str = "<|reserved_special_token_1|>"
    chat_family: Literal["llama3", "qwen3"] = "qwen3"
    enable_thinking: bool = True   # qwen3 template: False injects an empty
                                   # <think/> block like HF enable_thinking
    buckets: Buckets = dataclasses.field(default_factory=Buckets)
    rng: random.Random = dataclasses.field(
        default_factory=lambda: random.Random(0))

    def _chat(self, system: str, user: str) -> str:
        if self.chat_family == "llama3":
            return llama3_chat_prompt(system, user)
        return qwen3_chat_prompt(system, user, self.enable_thinking)

    def __call__(self, batch: List[Dict]) -> Dict:
        accessions = [d.get("AlphaFoldDB") for d in batch]
        fullnames = [
            d.get("Full Name")
            if isinstance(d.get("Full Name"), str)
            and self.rng.random() > self.name_dropout else "unknown"
            for d in batch
        ]
        taxons = [
            d.get("taxon")
            if isinstance(d.get("taxon"), str)
            and self.rng.random() > self.taxonomy_dropout else "unknown"
            for d in batch
        ]
        sequences = []
        for d in batch:
            s = d["sequence"]
            if len(s) > self.max_sequence_length:
                start = self.rng.randint(0, len(s) - self.max_sequence_length)
                s = s[start:start + self.max_sequence_length]
            sequences.append(s)
        descriptions = [d["function"] for d in batch]

        seq_lens = [self.protein_tokenizer.token_length(s) for s in sequences]

        prompts = []
        for fullname, taxon, n in zip(fullnames, taxons, seq_lens):
            user = protein_user_message(
                fullname, taxon, n, self.placeholder_token,
                self.include_text_fields, light_style=True)
            prompts.append(self.tokenizer.encode(
                self._chat(self.system_message, user),
                add_special_tokens=False))
        prompts = [np.asarray(p) for p in prompts]

        ppw = bucket_width(max(len(p) for p in prompts), self.buckets.prompt)
        prompt_ids = pad_stack(prompts, self.tokenizer.pad_token_id,
                               "left", ppw)
        prompt_mask = pad_stack([np.ones_like(p) for p in prompts], 0,
                                "left", ppw)

        descs = []
        for d in descriptions:
            # reference appends eos BEFORE truncation (dataloader_light.py:
            # 222-232): a truncated description loses its eos
            ids = self.tokenizer.encode(d, add_special_tokens=False)
            ids = (ids + [self.tokenizer.eos_token_id])
            ids = ids[:self.max_description_length]
            descs.append(np.asarray(ids))
        dw = bucket_width(max(len(d) for d in descs),
                          self.buckets.description)
        desc_ids = pad_stack(descs, self.tokenizer.pad_token_id, "right", dw)
        desc_mask = pad_stack([np.ones_like(d) for d in descs], 0, "right", dw)
        labels = np.where(desc_mask == 0, -100, desc_ids)

        # pre-tokenized proteins for the jitted step (the reference tokenizes
        # inside model.forward on the hot path — SURVEY.md §3.2 fix)
        pw = bucket_width(max(seq_lens), self.buckets.protein)
        prot_ids, prot_mask = self.protein_tokenizer.batch_encode(
            sequences, pad_to=pw)

        result = {
            "name": accessions,
            "protein_sequences": sequences,
            "protein_input_ids": prot_ids,
            "protein_attention_mask": prot_mask,
            "description_input_ids": desc_ids,
            "description_attention_mask": desc_mask,
        }
        if self.mode == "train":
            result.update({
                "input_ids": np.concatenate([prompt_ids, desc_ids], axis=1),
                "attention_mask": np.concatenate(
                    [prompt_mask, desc_mask], axis=1),
                "labels": np.concatenate(
                    [np.full_like(prompt_ids, -100), labels], axis=1),
            })
        elif self.mode == "inference":
            result.update({
                "input_ids": prompt_ids,
                "attention_mask": prompt_mask,
            })
        else:
            raise ValueError(self.mode)
        return result
