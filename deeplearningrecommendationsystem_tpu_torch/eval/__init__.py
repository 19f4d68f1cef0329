"""Evaluation: ``pointwise`` (the reference's thresholded metrics and the rank
AUC), ``ranking`` (top-K list metrics) and ``recommend`` (masked full-catalog
ranking)."""
