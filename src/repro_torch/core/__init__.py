"""Lemmas, keys, results and the vectorized cover (paper §2–§6, §10)."""
