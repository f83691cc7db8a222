"""Synthetic data generators of the port (numpy; copies of ``repro.data``'s
recsys, tokenizer, synthetic IR and graph modules)."""
