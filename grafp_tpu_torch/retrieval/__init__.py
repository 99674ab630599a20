"""Fingerprint search and sequence-level evaluation (port of
``grafp_tpu.retrieval``): memmap IO, k-means, product quantisation, the
block-scan search engine, the index family and ``eval_faiss``."""
