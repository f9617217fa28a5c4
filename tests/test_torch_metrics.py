"""The port's scoring metrics (`prot2text_tpu_torch/eval_metrics/
metrics.py`) against the JAX package's on a seeded corpus with
punctuation, hyphens, digits, HTML entities, newlines, non-ASCII text, an
empty prediction and a pair without a shared n-gram:

  * `compute_metrics` equals JAX's key for key, BLEU and ROUGE to 1e-12,
    JAX's with `sacrebleu` and `rouge_score` imported and the port's with
    both blocked in `sys.modules` (the port carries its own copies and has
    no whitespace fallback: its 13a tokens are sacrebleu's, which differ
    from whitespace splits on this corpus);
  * BERTScore: `bert_score_from_embeddings`, `idf_dict_from_references`
    and `compute_bert_score` over a tiny random HF BERT
    (`make_hf_bert_embed_fn(..., device="cpu")`) equal JAX's, with and
    without idf; without `transformers` the loader raises ImportError."""

import os
import sys

import numpy as np
import pytest

from prot2text_tpu.eval_metrics import metrics as jm
from prot2text_tpu_torch.eval_metrics import metrics as tm

WORDS = ["Binds", "ATP", "ATP-dependent", "kinase", "protein", "3.5",
         "1,000", "pH", "7.4", "(by", "similarity)", "&quot;catalytic&quot;",
         "&amp;", "Ca(2+)", "Ünïcode", "protéine", "β-lactamase", "✓",
         "the", "of", "in", "and", "membrane.", "cell,", "activity;",
         "x-ray", "12-3", "co-factor", "<skipped>", "e.g.", "5'-3'"]


def _corpus(n=24, seed=7):
    """Seeded (predictions, references): random sentences of WORDS, some
    with newlines, plus an empty prediction, a pair without any shared
    n-gram and an exact pair."""
    rng = np.random.default_rng(seed)

    def sentence():
        words = list(rng.choice(WORDS, int(rng.integers(3, 14))))
        if rng.random() < 0.3:
            words.insert(int(rng.integers(1, len(words))), "\n")
        if rng.random() < 0.2:
            words.insert(int(rng.integers(1, len(words))), "-\n")
        return " ".join(words)

    preds = [sentence() for _ in range(n)]
    refs = [sentence() for _ in range(n)]
    preds += ["", "zzz qqq", "Binds ATP &quot;strongly&quot;.\nSecond line."]
    refs += ["Hydrolyzes ATP.", "alpha beta gamma",
             "Binds ATP &quot;strongly&quot;.\nSecond line."]
    return preds, refs


def _close(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _close(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _close(a, b)
    elif isinstance(want, float):
        assert abs(got - want) <= 1e-12, (got, want)
    else:
        assert got == want


def test_compute_metrics_matches_jax_without_the_packages():
    from sacrebleu.tokenizers.tokenizer_13a import Tokenizer13a

    preds, refs = _corpus()
    want = jm.compute_metrics(preds, refs)
    sacre = Tokenizer13a()
    lines = preds + refs
    assert all(tm._tokenize_13a(s) == sacre(s).split() for s in lines)
    assert sum(tm._tokenize_13a(s) != s.split() for s in lines) > 10
    with pytest.MonkeyPatch.context() as mp:
        for name in ("sacrebleu", "rouge_score"):
            for mod in [m for m in sys.modules
                        if m == name or m.startswith(name + ".")]:
                mp.delitem(sys.modules, mod)
            mp.setitem(sys.modules, name, None)
        with pytest.raises(ImportError):
            import rouge_score  # noqa: F401
        got = tm.compute_metrics(preds, refs)
        same = tm.compute_metrics(refs, refs)
    _close(got, want)
    assert 0 < got["bleu2"]["bleu"] < 1 and 0 < got["bleu4"]["bleu"] < 1
    assert all(0 < v < 1 for v in got["rouge"].values())
    assert got["rouge"]["rougeLsum"] != got["rouge"]["rougeL"]
    assert got["exact_match"] == 1 / len(preds)
    assert same["exact_match"] == 1.0
    assert same["bleu2"]["bleu"] == same["bleu4"]["bleu"] == 1.0
    assert all(v == 1.0 for v in same["rouge"].values())


VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
         "the", "protein", "binds", "atp", "with", "high", "affinity",
         "catalyzes", "hydrolysis", "of", "enzyme", "activity", "cell",
         "membrane", "##s", "##ing", "a", "in", "is", "an", "to", "dna"]
PREDS = ["the protein binds atp with high affinity",
         "an enzyme catalyzes hydrolysis of atp",
         "dna binding protein", ""]
REFS = ["the protein binds atp",
        "the enzyme catalyzes atp hydrolysis in the cell",
        "protein binding to dna", "membrane protein"]


@pytest.fixture(scope="module")
def bert_dir(tmp_path_factory):
    """A tiny random HF BERT with a WordPiece tokenizer, saved to disk
    (tests/test_bertscore_parity.py:33-51); `transformers` without
    TensorFlow (`USE_TF=0`), which would add seconds to its import."""
    os.environ.setdefault("USE_TF", "0")
    import torch
    from transformers import BertConfig, BertModel, BertTokenizerFast

    d = str(tmp_path_factory.mktemp("tiny_bert"))
    vocab_path = os.path.join(d, "vocab.txt")
    with open(vocab_path, "w") as f:
        f.write("\n".join(VOCAB) + "\n")
    BertTokenizerFast(vocab_file=vocab_path,
                      do_lower_case=True).save_pretrained(d)
    torch.manual_seed(0)
    BertModel(BertConfig(
        vocab_size=len(VOCAB), hidden_size=32, num_hidden_layers=3,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=64, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)).eval().save_pretrained(d)
    return d


@pytest.mark.parametrize("idf", [False, True], ids=["no_idf", "idf"])
def test_bert_score_matches_jax(bert_dir, idf):
    tok, embed = tm.make_hf_bert_embed_fn(bert_dir, num_layers=2,
                                          device="cpu")
    jtok, jembed = jm.make_hf_bert_embed_fn(bert_dir, num_layers=2)
    pe, pt = embed(PREDS)
    je, jt = jembed(PREDS)
    assert pt == jt
    for a, b in zip(pe, je):
        np.testing.assert_array_equal(a, b)
    _, rt = embed(REFS)
    zero = (tok.cls_token_id, tok.sep_token_id)
    assert tm.idf_dict_from_references(rt, zero) == \
        jm.idf_dict_from_references(rt, zero)
    got = tm.compute_bert_score(PREDS, REFS, embed, tokenizer=tok, idf=idf)
    want = jm.compute_bert_score(PREDS, REFS, jembed, tokenizer=jtok,
                                 idf=idf)
    _close(got, want)
    assert 0 < got["f1"] < 1
    rng = np.random.default_rng(3)
    p = [rng.standard_normal((n, 8)) for n in (4, 0, 3)]
    r = [rng.standard_normal((n, 8)) for n in (5, 2, 3)]
    w = [rng.random(len(x)) for x in p] if idf else None
    v = [rng.random(len(x)) for x in r] if idf else None
    _close(tm.bert_score_from_embeddings(p, r, w, v),
           jm.bert_score_from_embeddings(p, r, w, v))
    metrics = tm.compute_metrics(PREDS, REFS, bert_embed_fns={"tiny": embed},
                                 bert_kwargs={"tokenizer": tok, "idf": idf})
    _close(metrics["bert_score"]["tiny"], want)


def test_bert_loader_raises_without_transformers(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError):
        tm.make_hf_bert_embed_fn("unused", device="cpu")
