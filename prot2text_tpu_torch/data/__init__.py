"""Host-side data code of the port: numpy-only copies of the JAX package's
modules the port uses (chat templates and the byte tokenizer, protein
tokenizers, collators, the sharded sampler and loader, the datasets)."""

from .chat import SYSTEM_MESSAGE, ByteTextTokenizer
from .collate import Buckets, InstructCollator, LightCollator, pad_stack
from .dataset import Prot2TextInstructDataset, Prot2TextLightDataset
from .sampler import DataLoader, ShardedSampler
from .tokenization import ProteinTokenizer, esm2_tokenizer, esmc_tokenizer
