"""The port's own data code (prot2text_tpu_torch/data) against the JAX
package's originals: on the same records, the byte tokenizer, both
collators (with the CLIs' buckets), the sampler and loader order and the
CSV dataset give numpy-identical outputs."""

import numpy as np
import pytest

from prot2text_tpu.data import chat as jchat
from prot2text_tpu.data import collate as jcollate
from prot2text_tpu.data import dataset as jdataset
from prot2text_tpu.data import sampler as jsampler
from prot2text_tpu.data import tokenization as jtok
from prot2text_tpu_torch.cli.serve import BUCKETS as SERVE_BUCKETS
from prot2text_tpu_torch.cli.train_instruct import BUCKETS as TRAIN_BUCKETS
from prot2text_tpu_torch.data import chat as tchat
from prot2text_tpu_torch.data import collate as tcollate
from prot2text_tpu_torch.data import dataset as tdataset
from prot2text_tpu_torch.data import sampler as tsampler
from prot2text_tpu_torch.data import tokenization as ttok

AMINO = "ACDEFGHIKLMNPQRSTVWY"


def _rows(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"AlphaFoldDB": f"P{i:05d}",
             "Full Name": f"Protein kinase {i}" if i % 3 else float("nan"),
             "taxon": "Homo sapiens" if i % 2 else "Mus musculus",
             "sequence": "".join(rng.choice(list(AMINO),
                                            int(rng.integers(5, 40)))),
             "function": f"Binds ATP; function {i}. Ünïcode ✓."}
            for i in range(n)]


def _assert_same(a, b):
    assert type(a) is type(b) or (isinstance(a, np.ndarray)
                                  and isinstance(b, np.ndarray))
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert a == b


def test_byte_tokenizer_encode_decode():
    text = "<|im_start|>user\nProtein ✓ ünï <|reserved_special_token_1|>"
    jt, tt = jchat.ByteTextTokenizer(), tchat.ByteTextTokenizer()
    assert tt.encode(text) == jt.encode(text)
    ids = jt.encode(text) + [jt.eos_token_id, jt.pad_token_id]
    for skip in (False, True):
        assert tt.decode(ids, skip_special_tokens=skip) == jt.decode(
            ids, skip_special_tokens=skip)
    assert tt.vocab_size == jt.vocab_size
    seq = "MKTAYIAKQR"
    assert ttok.esm2_tokenizer().encode(seq) == jtok.esm2_tokenizer().encode(
        seq)
    assert ttok.esmc_tokenizer().encode(seq) == jtok.esmc_tokenizer().encode(
        seq)


@pytest.mark.parametrize("mode,buckets", [("train", TRAIN_BUCKETS),
                                          ("inference", SERVE_BUCKETS)],
                         ids=["train", "inference"])
def test_light_collator_matches(mode, buckets):
    rows = _rows(5)

    def collate(mod, chat):
        tok = chat.ByteTextTokenizer()
        return mod.LightCollator(
            tokenizer=tok, mode=mode, placeholder_token=tok.placeholder_token,
            buckets=mod.Buckets(**buckets))(rows)

    _assert_same(collate(tcollate, tchat), collate(jcollate, jchat))


def test_instruct_collator_matches():
    def records(chat, tok_mod):
        tok, ptok = chat.ByteTextTokenizer(), tok_mod.esm2_tokenizer()
        out = []
        for i, r in enumerate(_rows(4, seed=2)):
            user = chat.protein_user_message(
                r["Full Name"] if isinstance(r["Full Name"], str) else "x",
                r["taxon"], len(r["sequence"]) + 2, tok.placeholder_token)
            out.append({
                "name": r["AlphaFoldDB"],
                "sequence_input_ids": np.asarray(ptok.encode(r["sequence"]),
                                                 np.int32),
                "prompt_input_ids": np.asarray(tok.encode(
                    chat.llama3_chat_prompt(chat.SYSTEM_MESSAGE, user)),
                    np.int32),
                "description_input_ids": np.asarray(
                    tok.encode(r["function"]) + [tok.eos_token_id], np.int32),
            })
        return out

    for mode in ("train", "inference"):
        got = tcollate.InstructCollator(
            text_pad_token_id=7, mode=mode,
            buckets=tcollate.Buckets(**TRAIN_BUCKETS))(
                records(tchat, ttok))
        want = jcollate.InstructCollator(
            text_pad_token_id=7, mode=mode,
            buckets=jcollate.Buckets(**TRAIN_BUCKETS))(
                records(jchat, jtok))
        _assert_same(got, want)


class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": i}


def _stack(batch):
    return np.asarray([b["i"] for b in batch])


@pytest.mark.parametrize("shuffle,drop_last,shards", [
    (True, True, 1), (False, False, 1), (True, False, 3)])
def test_sampler_and_loader_order(shuffle, drop_last, shards):
    for shard in range(shards):
        kw = dict(dataset_size=23, num_shards=shards, shard_index=shard,
                  shuffle=shuffle, seed=7, drop_last=drop_last)
        ts, js = tsampler.ShardedSampler(**kw), jsampler.ShardedSampler(**kw)
        for epoch in (0, 1):
            np.testing.assert_array_equal(ts.epoch_indices(epoch),
                                          js.epoch_indices(epoch))
        got = list(tsampler.DataLoader(dataset=_Items(23), collate_fn=_stack,
                                       batch_size=4, sampler=ts,
                                       drop_last=drop_last))
        want = list(jsampler.DataLoader(dataset=_Items(23), collate_fn=_stack,
                                        batch_size=4, sampler=js,
                                        drop_last=drop_last))
        _assert_same(got, want)


def test_light_dataset_on_csv(tmp_path):
    import pandas as pd

    path = tmp_path / "tiny.csv"
    pd.DataFrame(_rows(6, seed=3)).to_csv(path, index=False)
    td, jd = (tdataset.Prot2TextLightDataset(str(path)),
              jdataset.Prot2TextLightDataset(str(path)))
    assert len(td) == len(jd) == 6
    for i in range(6):
        a, b = td[i], jd[i]
        assert a.keys() == b.keys()
        for k in a:
            assert a[k] == b[k] or (a[k] != a[k] and b[k] != b[k]), k


def test_graph_processing_names_its_roadmap_item(tmp_path):
    ds = tdataset.Prot2TextInstructDataset.__new__(
        tdataset.Prot2TextInstructDataset)
    with pytest.raises(NotImplementedError, match="item 12"):
        ds.process_one("P00001")
