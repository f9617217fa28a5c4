"""Protein sequence tokenizers (ESM2 / ESMC alphabets) — native, host-side.

The port's own copy of prot2text_tpu/data/tokenization.py (numpy only, no JAX);
names and behaviour are kept so the two packages collate alike.


The reference tokenizes proteins with HF `AutoTokenizer` (ESM2) or
`esm.utils.encoding.tokenize_sequence` (ESMC) — both use the same fixed
33-symbol ESM alphabet with cls=0/pad=1/eos=2/unk=3, so we implement it
directly (no checkpoint download needed).  Reference sites:
dataset/dataset.py:388-393 (ESM2 path), esmc_qwen_arc.py:70-78 and
dataset/dataloader_light.py:129-148 (ESMC path).

Batches are right-padded (reference dataloader.py:113-121) and, for TPU,
padded up to a caller-chosen bucket length so jitted shapes stay static.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

ESM_ALPHABET = [
    "<cls>", "<pad>", "<eos>", "<unk>",
    "L", "A", "G", "V", "S", "E", "R", "T", "I", "D", "P", "K", "Q", "N",
    "F", "Y", "M", "H", "W", "C", "X", "B", "U", "Z", "O", ".", "-",
    "<null_1>", "<mask>",
]


@dataclasses.dataclass(frozen=True)
class ProteinTokenizer:
    cls_id: int = 0
    pad_id: int = 1
    eos_id: int = 2
    unk_id: int = 3

    def __post_init__(self):
        object.__setattr__(
            self, "_tok2id", {t: i for i, t in enumerate(ESM_ALPHABET)})

    @property
    def vocab_size(self) -> int:
        return len(ESM_ALPHABET)

    def encode(self, sequence: str, add_special_tokens: bool = True) -> List[int]:
        ids = [self._tok2id.get(aa, self.unk_id) for aa in sequence.upper()]
        if add_special_tokens:
            ids = [self.cls_id] + ids + [self.eos_id]
        return ids

    def token_length(self, sequence: str, add_special_tokens: bool = True) -> int:
        return len(sequence) + (2 if add_special_tokens else 0)

    def batch_encode(
        self,
        sequences: Sequence[str],
        *,
        add_special_tokens: bool = True,
        pad_to: Optional[int] = None,
        max_length: Optional[int] = None,
    ):
        """Right-padded (input_ids, attention_mask) int32 numpy arrays."""
        encoded = []
        for s in sequences:
            if max_length is not None:
                body = max_length - (2 if add_special_tokens else 0)
                s = s[:body]
            encoded.append(self.encode(s, add_special_tokens))
        width = max(len(e) for e in encoded)
        if pad_to is not None:
            width = max(width, pad_to)
        ids = np.full((len(encoded), width), self.pad_id, np.int32)
        mask = np.zeros((len(encoded), width), np.int32)
        for i, e in enumerate(encoded):
            ids[i, :len(e)] = e
            mask[i, :len(e)] = 1
        return ids, mask

    def decode(self, ids: Sequence[int], skip_special: bool = True) -> str:
        out = []
        for i in ids:
            t = ESM_ALPHABET[int(i)]
            if skip_special and t.startswith("<"):
                continue
            out.append(t)
        return "".join(out)


def esm2_tokenizer() -> ProteinTokenizer:
    return ProteinTokenizer()


def esmc_tokenizer() -> ProteinTokenizer:
    """ESMC's EsmSequenceTokenizer shares the alphabet/ids; its embedding
    table is simply padded to 64 rows."""
    return ProteinTokenizer()
