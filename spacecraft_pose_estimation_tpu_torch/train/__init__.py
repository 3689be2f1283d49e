"""The landmark stage's training (state, step, optimizer, checkpoints, metrics) and validation pass, and heatmap ensembles."""
