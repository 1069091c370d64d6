"""The acoustic model and the vocoder as torch modules."""
