"""Evaluation. Only ``recommend`` (masked full-catalog ranking) is ported yet."""
