"""Reference-named dataloader classes (counterpart of
prot2text_tpu/data/dataloaders.py).

The reference exports Prot2TextInstructDataLoader /
Prot2TextDerivedDataLoader / Prot2TextLightCollater and their collaters
from dataset/__init__.py:1-4; these classes wire the port's collators into
its sharded DataLoader with the same constructor surface (dataset, mode,
batch_size, shuffle, ...)."""

from __future__ import annotations

from typing import Literal, Optional

from .collate import Buckets, DerivedCollator, InstructCollator, LightCollator
from .sampler import DataLoader, ShardedSampler

# collater aliases matching the reference class names
Prot2TextInstructCollater = InstructCollator
Prot2TextDerivedCollater = DerivedCollator
Prot2TextLightCollater = LightCollator


class Prot2TextInstructDataLoader(DataLoader):
    """reference dataset/dataloader.py:231-301 constructor surface."""

    def __init__(self, dataset, mode: Literal["train", "inference"] = "train",
                 batch_size: int = 1, shuffle: bool = False, seed: int = 42,
                 num_shards: int = 1, shard_index: int = 0,
                 drop_last: bool = True, text_pad_token_id: int = 128002,
                 buckets: Optional[Buckets] = None, num_workers: int = 0,
                 prefetch_factor: int = 2):
        collater = InstructCollator(
            text_pad_token_id=text_pad_token_id,
            seq_pad_token_id=dataset.sequence_tokenizer.pad_id,
            mode=mode, buckets=buckets or Buckets())
        super().__init__(
            dataset=dataset, collate_fn=collater, batch_size=batch_size,
            sampler=ShardedSampler(
                len(dataset), num_shards=num_shards, shard_index=shard_index,
                shuffle=shuffle, seed=seed, drop_last=drop_last),
            drop_last=drop_last, num_workers=num_workers,
            prefetch_factor=prefetch_factor)


class Prot2TextDerivedDataLoader(DataLoader):
    """reference dataset/dataloader_derived.py:259-347 constructor surface."""

    def __init__(self, dataset, tokenizer,
                 mode: Literal["train", "inference"] = "train",
                 original_eos_token_id: int = 128009,
                 prompt_sentence: str = (
                     "Predict protein description based on the amino-acid "
                     "sequence embeddings."),
                 batch_size: int = 1, shuffle: bool = False, seed: int = 42,
                 num_shards: int = 1, shard_index: int = 0,
                 drop_last: bool = True, buckets: Optional[Buckets] = None,
                 num_workers: int = 0, prefetch_factor: int = 2):
        collater = DerivedCollator(
            tokenizer=tokenizer,
            original_eos_token_id=original_eos_token_id,
            prompt_sentence=prompt_sentence,
            seq_pad_token_id=dataset.sequence_tokenizer.pad_id,
            mode=mode, buckets=buckets or Buckets())
        super().__init__(
            dataset=dataset, collate_fn=collater, batch_size=batch_size,
            sampler=ShardedSampler(
                len(dataset), num_shards=num_shards, shard_index=shard_index,
                shuffle=shuffle, seed=seed, drop_last=drop_last),
            drop_last=drop_last, num_workers=num_workers,
            prefetch_factor=prefetch_factor)
