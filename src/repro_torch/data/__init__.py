"""Synthetic token stream of the training slice (``pipeline``)."""
