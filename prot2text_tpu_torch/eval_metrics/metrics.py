"""Generation-quality metrics: exact match, BLEU-2/4, ROUGE and BERTScore
(counterpart of prot2text_tpu/eval_metrics/metrics.py, the same public
names, arguments and output keys).

The JAX module leans on two packages for BLEU and ROUGE: `sacrebleu` for the
13a pre-tokenizer, with a silent fallback to whitespace tokens when its
import fails (prot2text_tpu/eval_metrics/metrics.py:47-56), and
`rouge_score` for ROUGE, which raises without it (`:112`).  Neither is
installed beside the port on the GPU machine, so the port carries its own
copies of what those packages compute at the settings JAX uses, and has no
fallback:
  * BLEU: sacrebleu 2.6.0's `Tokenizer13a` (`tokenizers/tokenizer_13a.py`)
    and the `TokenizerRegexp` under it (`tokenizers/tokenizer_re.py`),
    rule for rule, then Papineni corpus BLEU without smoothing (the
    algorithm HF `evaluate`'s "bleu" wraps), max_order 2 and 4;
  * ROUGE: `rouge_score`'s `RougeScorer(use_stemmer=False)` — its default
    tokenizer (lowercase, `[^a-z0-9]+` to a space, tokens matching
    `^[a-z0-9]+$`), rouge1/rouge2 from n-gram overlap, rougeL from the LCS
    table, rougeLsum from the summary-level union LCS over newline-split
    sentences with ROUGE-1.5.5's double-count guard — fmeasures averaged
    over the corpus;
  * BERTScore: greedy cosine matching of per-token embeddings in numpy
    (any embedding function), with `idf_dict_from_references` and the
    reference's 495-token round-trip truncation; `make_hf_bert_embed_fn`
    loads a local HF checkpoint through `transformers`, imported inside the
    function (an ImportError where it is not installed).
"""

from __future__ import annotations

import collections
import math
import re
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np


def _normalize_exact(text: str) -> str:
    return re.sub(r"[^\w]", "", text.lower())


def compute_exact_match(predictions: Sequence[str],
                        references: Sequence[str]) -> float:
    hits = sum(
        _normalize_exact(p) == _normalize_exact(r)
        for p, r in zip(predictions, references))
    return hits / len(predictions)


# ---------------------------------------------------------------------------
# BLEU

# sacrebleu 2.6.0 TokenizerRegexp's rules, in order
_13A_RULES = (
    # language-dependent part (assuming Western languages)
    (re.compile(r'([\{-\~\[-\` -\&\(-\+\:-\@\/])'), r' \1 '),
    # period and comma unless preceded by a digit
    (re.compile(r'([^0-9])([\.,])'), r'\1 \2 '),
    # period and comma unless followed by a digit
    (re.compile(r'([\.,])([^0-9])'), r' \1 \2'),
    # dash when preceded by a digit
    (re.compile(r'([0-9])(-)'), r'\1 \2 '),
)


def _tokenize_13a(line: str) -> List[str]:
    """sacrebleu's tokenizer_13a (the default pre-tokenizer of HF
    evaluate's bleu metric), split into tokens."""
    line = line.replace('<skipped>', '')
    line = line.replace('-\n', '')
    line = line.replace('\n', ' ')
    if '&' in line:
        line = line.replace('&quot;', '"')
        line = line.replace('&amp;', '&')
        line = line.replace('&lt;', '<')
        line = line.replace('&gt;', '>')
    line = f' {line} '
    for pattern, repl in _13A_RULES:
        line = pattern.sub(repl, line)
    return line.split()


def _ngrams(tokens: List[str], n: int):
    counts: collections.Counter = collections.Counter()
    for i in range(len(tokens) - n + 1):
        counts[tuple(tokens[i:i + n])] += 1
    return counts


def compute_bleu(predictions: Sequence[str], references: Sequence[str],
                 max_order: int = 4) -> Dict[str, Any]:
    """Corpus BLEU (no smoothing), same output keys as evaluate's bleu."""
    pred_toks = [_tokenize_13a(p) for p in predictions]
    ref_toks = [_tokenize_13a(r) for r in references]

    matches = [0] * max_order
    possible = [0] * max_order
    pred_len = 0
    ref_len = 0
    for p, r in zip(pred_toks, ref_toks):
        pred_len += len(p)
        ref_len += len(r)
        for n in range(1, max_order + 1):
            overlap = sum((_ngrams(p, n) & _ngrams(r, n)).values())
            matches[n - 1] += overlap
            possible[n - 1] += max(len(p) - n + 1, 0)

    precisions = [
        (matches[i] / possible[i]) if possible[i] > 0 else 0.0
        for i in range(max_order)
    ]
    if min(precisions) > 0:
        log_mean = sum(math.log(p) for p in precisions) / max_order
        geo_mean = math.exp(log_mean)
    else:
        geo_mean = 0.0
    ratio = pred_len / ref_len if ref_len > 0 else 0.0
    bp = (1.0 if ratio > 1.0 else
          math.exp(1 - 1 / ratio) if ratio > 0 else 0.0)
    return {
        "bleu": geo_mean * bp,
        "precisions": precisions,
        "brevity_penalty": bp,
        "length_ratio": ratio,
        "translation_length": pred_len,
        "reference_length": ref_len,
    }


# ---------------------------------------------------------------------------
# ROUGE: rouge_score's RougeScorer at use_stemmer=False

ROUGE_KINDS = ("rouge1", "rouge2", "rougeL", "rougeLsum")
_NON_ALPHANUM = re.compile(r"[^a-z0-9]+")
_SPACES = re.compile(r"\s+")
_VALID_TOKEN = re.compile(r"^[a-z0-9]+$")


def _rouge_tokens(text: str) -> List[str]:
    """rouge_score's default tokenizer without a stemmer."""
    tokens = _SPACES.split(_NON_ALPHANUM.sub(" ", text.lower()))
    return [t for t in tokens if _VALID_TOKEN.match(t)]


def _fmeasure(precision: float, recall: float) -> float:
    if precision + recall > 0:
        return 2 * precision * recall / (precision + recall)
    return 0.0


def _score_ngrams(target: List[str], prediction: List[str], n: int) -> float:
    t, p = _ngrams(target, n), _ngrams(prediction, n)
    hits = sum(min(c, p[g]) for g, c in t.items())
    precision = hits / max(sum(p.values()), 1)
    recall = hits / max(sum(t.values()), 1)
    return _fmeasure(precision, recall)


def _lcs_table(ref: List[str], can: List[str]) -> List[List[int]]:
    rows, cols = len(ref), len(can)
    table = [[0] * (cols + 1) for _ in range(rows + 1)]
    for i in range(1, rows + 1):
        for j in range(1, cols + 1):
            if ref[i - 1] == can[j - 1]:
                table[i][j] = table[i - 1][j - 1] + 1
            else:
                table[i][j] = max(table[i - 1][j], table[i][j - 1])
    return table


def _score_lcs(target: List[str], prediction: List[str]) -> float:
    if not target or not prediction:
        return 0.0
    lcs = _lcs_table(target, prediction)[-1][-1]
    return _fmeasure(lcs / len(prediction), lcs / len(target))


def _lcs_indices(ref: List[str], can: List[str]) -> List[int]:
    """One longest common subsequence as indices into `ref` (rouge_score's
    `_backtrack_norec` tie-breaking)."""
    t = _lcs_table(ref, can)
    i, j = len(ref), len(can)
    out: List[int] = []
    while i > 0 and j > 0:
        if ref[i - 1] == can[j - 1]:
            out.insert(0, i - 1)
            i -= 1
            j -= 1
        elif t[i][j - 1] > t[i - 1][j]:
            j -= 1
        else:
            i -= 1
    return out


def _summary_level_lcs(ref_sents: List[List[str]],
                       can_sents: List[List[str]]) -> float:
    """Summary-level LCS (ROUGE paper §3.2) with ROUGE-1.5.5's guard
    against counting a token more often than it occurs."""
    if not ref_sents or not can_sents:
        return 0.0
    m = sum(map(len, ref_sents))
    n = sum(map(len, can_sents))
    if not n or not m:
        return 0.0
    cnt_r: collections.Counter = collections.Counter()
    cnt_c: collections.Counter = collections.Counter()
    for s in ref_sents:
        cnt_r.update(s)
    for s in can_sents:
        cnt_c.update(s)
    hits = 0
    for r in ref_sents:
        union = sorted(set().union(*[_lcs_indices(r, c) for c in can_sents]))
        for t in (r[i] for i in union):
            if cnt_c[t] > 0 and cnt_r[t] > 0:
                hits += 1
                cnt_c[t] -= 1
                cnt_r[t] -= 1
    return _fmeasure(hits / n, hits / m)


def _rouge_scores(target: str, prediction: str) -> Dict[str, float]:
    """The four fmeasures of `RougeScorer.score(target, prediction)`."""
    t, p = _rouge_tokens(target), _rouge_tokens(prediction)

    def sents(text):
        return [_rouge_tokens(s) for s in text.split("\n") if len(s)]

    return {"rouge1": _score_ngrams(t, p, 1), "rouge2": _score_ngrams(t, p, 2),
            "rougeL": _score_lcs(t, p),
            "rougeLsum": _summary_level_lcs(sents(target), sents(prediction))}


def compute_rouge(predictions: Sequence[str],
                  references: Sequence[str]) -> Dict[str, float]:
    """rouge1/rouge2/rougeL/rougeLsum fmeasures averaged over the corpus
    (evaluate's rouge defaults: no stemmer, rougeLsum splits on
    newlines)."""
    sums = {k: 0.0 for k in ROUGE_KINDS}
    for p, r in zip(predictions, references):
        scores = _rouge_scores(r, p)
        for k in ROUGE_KINDS:
            sums[k] += scores[k]
    n = len(predictions)
    return {k: sums[k] / n for k in ROUGE_KINDS}


# ---------------------------------------------------------------------------
# BERTScore (greedy cosine matching; embedding-function agnostic)


def bert_score_from_embeddings(
    pred_embs: Sequence[np.ndarray],
    ref_embs: Sequence[np.ndarray],
    pred_idf: Optional[Sequence[np.ndarray]] = None,
    ref_idf: Optional[Sequence[np.ndarray]] = None,
) -> Dict[str, float]:
    """BERTScore P/R/F1 from per-sentence token embeddings (T_i, H).

    R = mean_j max_i cos(ref_j, pred_i); P = mean_i max_j cos(pred_i, ref_j);
    F1 = 2PR/(P+R), each optionally weighted per token, averaged over the
    corpus."""
    ps, rs, fs = [], [], []
    for bi, (pe, re_) in enumerate(zip(pred_embs, ref_embs)):
        if pe.shape[0] == 0 or re_.shape[0] == 0:
            ps.append(0.0), rs.append(0.0), fs.append(0.0)
            continue
        pe = pe / np.maximum(
            np.linalg.norm(pe, axis=-1, keepdims=True), 1e-12)
        re_ = re_ / np.maximum(
            np.linalg.norm(re_, axis=-1, keepdims=True), 1e-12)
        sim = pe @ re_.T  # (Tp, Tr)
        w_p = (pred_idf[bi] if pred_idf is not None
               else np.ones(pe.shape[0]))
        w_r = (ref_idf[bi] if ref_idf is not None
               else np.ones(re_.shape[0]))
        p = float((sim.max(axis=1) * w_p).sum() / max(w_p.sum(), 1e-12))
        r = float((sim.max(axis=0) * w_r).sum() / max(w_r.sum(), 1e-12))
        f = 2 * p * r / (p + r) if (p + r) > 0 else 0.0
        ps.append(p)
        rs.append(r)
        fs.append(f)
    return {"precision": float(np.mean(ps)), "recall": float(np.mean(rs)),
            "f1": float(np.mean(fs))}


def idf_dict_from_references(
    tokenized_refs: Sequence[Sequence[int]],
    zero_ids: Sequence[int] = (),
) -> Dict[int, float]:
    """`bert_score.utils.get_idf_dict`'s formula: idf(w) = log((N+1)/(df+1))
    over the REFERENCE corpus (df = reference sentences containing w);
    `zero_ids` (CLS/SEP) get 0 — they still take part as match candidates,
    only their weight in the P/R averages is zero.  "__default__" holds
    the weight of a token no reference contains."""
    n = len(tokenized_refs)
    df: Dict[int, int] = {}
    for toks in tokenized_refs:
        for t in set(toks):
            df[t] = df.get(t, 0) + 1
    out: Dict[Any, float] = {t: math.log((n + 1) / (c + 1))
                             for t, c in df.items()}
    for z in zero_ids:
        out[z] = 0.0
    out["__default__"] = math.log((n + 1) / 1.0)
    return out


def truncate_via_tokenizer(texts: Sequence[str], tokenizer,
                           max_tokens: int = 495) -> list:
    """The reference's pre-truncation: tokenize each text with the scorer's
    tokenizer at max_length=495, then batch-decode back to text with
    special tokens skipped, so the scorer never sees more than 495 tokens
    (biobert's max_position_embeddings is 512)."""
    enc = tokenizer(list(texts), truncation=True, max_length=max_tokens)
    return tokenizer.batch_decode(enc["input_ids"],
                                  skip_special_tokens=True)


def compute_bert_score(
    predictions: Sequence[str],
    references: Sequence[str],
    embed_fn: Callable[[Sequence[str]], Sequence[np.ndarray]],
    max_tokens: int = 495,
    *,
    tokenizer=None,
    idf: bool = False,
) -> Dict[str, float]:
    """BERTScore with a caller-provided contextual embedding function.

    With `tokenizer` given: the 495-token round-trip truncation runs here,
    per-token weights are 1 with CLS/SEP (and BOS/EOS) zeroed, or with
    `idf=True` reference-corpus idf weights (`idf_dict_from_references`).
    `embed_fn(texts)` returns per-sentence embeddings, or (embeddings,
    token ids); without ids every weight is 1."""
    predictions = list(predictions)
    references = list(references)
    if tokenizer is not None:
        predictions = truncate_via_tokenizer(predictions, tokenizer,
                                             max_tokens)
        references = truncate_via_tokenizer(references, tokenizer,
                                            max_tokens)
    out = embed_fn(predictions)
    out_r = embed_fn(references)
    if isinstance(out, tuple):
        pe, pt = out
        re_, rt = out_r
    else:
        pe, pt = out, None
        re_, rt = out_r, None
    pw = rw = None
    if tokenizer is not None and pt is not None:
        zero = tuple(t for t in (tokenizer.cls_token_id,
                                 tokenizer.sep_token_id,
                                 getattr(tokenizer, "bos_token_id", None),
                                 getattr(tokenizer, "eos_token_id", None))
                     if t is not None)
        if idf:
            idf_d = idf_dict_from_references(rt, zero_ids=zero)
            default = idf_d["__default__"]

            def w(toks):
                return np.asarray([idf_d.get(t, default) for t in toks],
                                  np.float64)
        else:
            def w(toks):
                return np.asarray([0.0 if t in zero else 1.0 for t in toks],
                                  np.float64)
        pw = [w(t) for t in pt]
        rw = [w(t) for t in rt]
    return bert_score_from_embeddings(pe, re_, pred_idf=pw, ref_idf=rw)


def make_hf_bert_embed_fn(model_dir: str, num_layers: Optional[int] = None,
                          device="cpu"):
    """The bert_score package's embedding convention from a local HF
    checkpoint on `device`: `hidden_states[num_layers]` (the embedding
    output is index 0; None takes the last layer), special tokens included
    (their P/R weight is zeroed downstream).  Returns (tokenizer,
    embed_fn), embed_fn(texts) -> (embeddings, token ids) on the host.
    Needs `transformers`, imported here."""
    import torch
    from transformers import AutoModel, AutoTokenizer

    tok = AutoTokenizer.from_pretrained(model_dir)
    model = AutoModel.from_pretrained(model_dir).to(device).eval()

    def embed(texts):
        embs, toks = [], []
        with torch.no_grad():
            for t in texts:
                enc = tok(t, truncation=True,
                          max_length=min(getattr(tok, "model_max_length",
                                                 512), 512),
                          return_tensors="pt")
                out = model(**{k: v.to(device) for k, v in enc.items()},
                            output_hidden_states=True)
                layer = (num_layers if num_layers is not None
                         else len(out.hidden_states) - 1)
                embs.append(out.hidden_states[layer][0].cpu().numpy())
                toks.append(enc["input_ids"][0].tolist())
        return embs, toks

    return tok, embed


# ---------------------------------------------------------------------------


def compute_metrics(
    predictions: Sequence[str],
    references: Sequence[str],
    *,
    evaluate_exact_match: bool = True,
    evaluate_bleu: bool = True,
    evaluate_rouge: bool = True,
    bert_embed_fns: Optional[Dict[str, Callable]] = None,
    bert_kwargs: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """The reference's compute_metrics flag surface: the metrics asked
    for, under the keys exact_match, bleu2, bleu4, rouge and bert_score
    (one entry per embedding function)."""
    out: Dict[str, Any] = {}
    if evaluate_exact_match:
        out["exact_match"] = compute_exact_match(predictions, references)
    if evaluate_bleu:
        out["bleu2"] = compute_bleu(predictions, references, max_order=2)
        out["bleu4"] = compute_bleu(predictions, references, max_order=4)
    if evaluate_rouge:
        out["rouge"] = compute_rouge(predictions, references)
    if bert_embed_fns:
        out["bert_score"] = {
            name: compute_bert_score(predictions, references, fn,
                                     **(bert_kwargs or {}))
            for name, fn in bert_embed_fns.items()
        }
    return out
