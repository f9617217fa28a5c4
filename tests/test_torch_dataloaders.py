"""The port's reference-named loader classes (`prot2text_tpu_torch/data/
dataloaders.py`) against the JAX package's on the same records and seed:
`Prot2TextInstructDataLoader` and `Prot2TextDerivedDataLoader` in train
and inference mode, shuffled over two epochs, give numpy-identical batches;
the collater aliases name the port's collators, and `data` exports them."""

import numpy as np
import pytest

from prot2text_tpu.data import chat as jchat
from prot2text_tpu.data import dataloaders as jdl
from prot2text_tpu.data import tokenization as jtok
from prot2text_tpu_torch import data as tdata
from prot2text_tpu_torch.data import chat as tchat
from prot2text_tpu_torch.data import dataloaders as tdl
from prot2text_tpu_torch.data import tokenization as ttok

AMINO = "ACDEFGHIKLMNPQRSTVWY"


class _Records:
    """An instruct-preprocessed dataset: `sequence_tokenizer` and records
    of protein, prompt and description ids (the description ending in the
    instruct EOT that the derived collator rewrites)."""

    def __init__(self, chat, tok_mod, n=7, seed=3):
        tok = chat.ByteTextTokenizer()
        self.sequence_tokenizer = tok_mod.esm2_tokenizer()
        rng = np.random.default_rng(seed)
        self.items = []
        for i in range(n):
            seq = "".join(rng.choice(list(AMINO), int(rng.integers(5, 40))))
            user = chat.protein_user_message(
                f"Kinase {i}", "Homo sapiens", len(seq) + 2,
                tok.placeholder_token)
            self.items.append({
                "name": f"P{i:05d}",
                "sequence_input_ids": np.asarray(
                    self.sequence_tokenizer.encode(seq), np.int32),
                "prompt_input_ids": np.asarray(tok.encode(
                    chat.llama3_chat_prompt(chat.SYSTEM_MESSAGE, user)),
                    np.int32),
                "description_input_ids": np.asarray(
                    tok.encode(f"Binds ATP; function {i}.") + [128009],
                    np.int32),
            })

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("kind", ["instruct", "derived"])
@pytest.mark.parametrize("mode", ["train", "inference"])
def test_batches_equal_jax(kind, mode):
    def loader(mod, chat, tok_mod):
        ds = _Records(chat, tok_mod)
        kw = dict(mode=mode, batch_size=3, shuffle=True, seed=11,
                  drop_last=False)
        if kind == "instruct":
            return mod.Prot2TextInstructDataLoader(ds, text_pad_token_id=7,
                                                   **kw)
        return mod.Prot2TextDerivedDataLoader(ds, chat.ByteTextTokenizer(),
                                              **kw)

    got_loader = loader(tdl, tchat, ttok)
    want_loader = loader(jdl, jchat, jtok)
    assert len(got_loader) == len(want_loader) == 3
    for epoch in (0, 1):
        got_loader.set_epoch(epoch)
        want_loader.set_epoch(epoch)
        got, want = list(got_loader), list(want_loader)
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            _same(a, b)


def test_aliases_and_exports():
    assert tdl.Prot2TextInstructCollater is tdata.InstructCollator
    assert tdl.Prot2TextDerivedCollater is tdata.DerivedCollator
    assert tdl.Prot2TextLightCollater is tdata.LightCollator
    for name in ("DerivedCollator", "Prot2TextDerivedCollater",
                 "Prot2TextDerivedDataLoader", "Prot2TextInstructCollater",
                 "Prot2TextInstructDataLoader", "Prot2TextLightCollater"):
        assert hasattr(tdata, name), name
