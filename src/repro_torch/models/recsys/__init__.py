"""Recsys models (``repro.models.recsys``): DLRM, DeepFM and xDeepFM over
one fused embedding table, every lookup through the embedding-bag
kernel."""
