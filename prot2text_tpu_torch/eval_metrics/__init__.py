"""Generation-quality metrics (exact match, BLEU-2/4, ROUGE, BERTScore)."""

from .metrics import (
    bert_score_from_embeddings, compute_bleu, compute_exact_match,
    compute_metrics, compute_rouge,
)
