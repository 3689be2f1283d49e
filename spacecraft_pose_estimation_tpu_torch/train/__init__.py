"""Evaluation-side parts of the JAX package's ``train/``: the validation pass and heatmap ensembles."""
