"""Host-side data code of the port: numpy-only copies of the JAX package's
modules the port uses (chat templates and the byte tokenizer, protein
tokenizers, collators, the sharded sampler and loader, the datasets, the
reference-named loader classes)."""

from .chat import SYSTEM_MESSAGE, ByteTextTokenizer
from .collate import (
    Buckets, DerivedCollator, InstructCollator, LightCollator, pad_stack,
)
from .dataloaders import (
    Prot2TextDerivedCollater, Prot2TextDerivedDataLoader,
    Prot2TextInstructCollater, Prot2TextInstructDataLoader,
    Prot2TextLightCollater,
)
from .dataset import Prot2TextInstructDataset, Prot2TextLightDataset
from .sampler import DataLoader, ShardedSampler
from .tokenization import ProteinTokenizer, esm2_tokenizer, esmc_tokenizer
