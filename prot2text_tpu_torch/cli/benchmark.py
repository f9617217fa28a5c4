"""Scoring CLI over generation JSONs (counterpart of
prot2text_tpu/cli/benchmark.py, reference scripts/benchmark.py:144-178):
the result files whose names contain --identifier, scored by exact match,
BLEU-2/4, ROUGE and, with a local HF checkpoint, BERTScore
(`eval_metrics/metrics.py`).

Same flags as the JAX CLI, plus --device (default "cuda", the device of the
BERTScore model; a missing GPU is an error, never a silent CPU run).  Exact
match, BLEU and ROUGE are host code; they need neither `sacrebleu` nor
`rouge_score`.  The metrics are printed as JSON and returned.

    python -m prot2text_tpu_torch.cli.benchmark \\
        --results_dir generation_results --identifier serve
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from ..core.device import resolve_device
from ..core.dtypes import str2bool
from ..eval_metrics.metrics import compute_metrics, make_hf_bert_embed_fn


def build_parser():
    p = argparse.ArgumentParser("benchmark")
    p.add_argument("--results_dir", type=str, default="./generation_results")
    p.add_argument("--identifier", type=str, required=True)
    p.add_argument("--evaluate_exact_match", type=str2bool, default=True)
    p.add_argument("--evaluate_bleu", type=str2bool, default=True)
    p.add_argument("--evaluate_rouge", type=str2bool, default=True)
    p.add_argument("--evaluate_bert_score", type=str2bool, default=False)
    p.add_argument("--bert_model_dir", type=str, default=None,
                   help="local HF checkpoint for BERTScore embeddings")
    p.add_argument("--bert_num_layers", type=int, default=None,
                   help="use hidden_states[N] like the bert_score package "
                        "(reference passes 24 for biobert-large; default = "
                        "last layer)")
    p.add_argument("--bert_idf", type=str2bool, default=False,
                   help="reference-corpus idf weighting "
                        "(bert_score idf=True)")
    p.add_argument("--verbose", type=str2bool, default=True)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda[:N]' or 'cpu', the BERTScore model's device; "
                        "a missing GPU raises")
    return p


def load_results(results_dir: str, identifier: str):
    """(predictions, references, paths) from every *.json in results_dir
    whose file name contains `identifier`, in sorted path order."""
    preds, refs = [], []
    paths = sorted(
        p for p in glob.glob(os.path.join(results_dir, "*.json"))
        if identifier in os.path.basename(p))
    if not paths:
        raise FileNotFoundError(
            f"no result JSONs matching '{identifier}' in {results_dir}")
    for p in paths:
        with open(p) as f:
            for item in json.load(f).values():
                preds.append(item["pred"])
                refs.append(item["true"])
    return preds, refs, paths


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    preds, refs, paths = load_results(args.results_dir, args.identifier)
    if args.verbose:
        print(f"{len(preds)} pairs from {len(paths)} files")

    bert_fns = None
    bert_kwargs = {}
    if args.evaluate_bert_score and args.bert_model_dir:
        tok, embed = make_hf_bert_embed_fn(
            args.bert_model_dir, num_layers=args.bert_num_layers,
            device=device)
        bert_fns = {os.path.basename(args.bert_model_dir): embed}
        bert_kwargs = {"tokenizer": tok, "idf": args.bert_idf}

    metrics = compute_metrics(
        preds, refs,
        evaluate_exact_match=args.evaluate_exact_match,
        evaluate_bleu=args.evaluate_bleu,
        evaluate_rouge=args.evaluate_rouge,
        bert_embed_fns=bert_fns, bert_kwargs=bert_kwargs)
    print(json.dumps(metrics, indent=2))
    return metrics


if __name__ == "__main__":
    main()
