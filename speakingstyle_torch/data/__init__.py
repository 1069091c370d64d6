"""Training data: preprocessed-feature datasets, bucketed batching, the synthetic corpus."""
