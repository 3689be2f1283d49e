"""The pose server's benchmark: ``run.py`` runs one cell once (see ``harness.py``)."""
