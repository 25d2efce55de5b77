"""Optimizers of the training slice (``adamw``)."""
