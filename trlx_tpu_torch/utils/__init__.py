"""Host-side utilities (the counterpart of ``trlx_tpu.utils``)."""


def sentiment_score(sentiment_outputs):
    """Positive-class probabilities from an HF sentiment pipeline's outputs
    (the reference's ``sentiment_score``, trlx/utils/__init__.py:109-116).
    Takes either top-1 dicts ({label, score}) or per-class score lists."""
    scores = []
    for out in sentiment_outputs:
        if isinstance(out, list):  # pipeline(..., top_k=2) / return_all_scores=True
            by_label = {str(x["label"]).upper(): float(x["score"]) for x in out}
            pos = by_label.get("POSITIVE", by_label.get("LABEL_1", 0.0))
        else:
            label = str(out.get("label", "")).upper()
            pos = float(out["score"]) if label in ("POSITIVE", "LABEL_1") else 1.0 - float(out["score"])
        scores.append(pos)
    return scores
