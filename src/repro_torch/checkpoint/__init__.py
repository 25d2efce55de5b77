"""Elastic sharded checkpoints in the reference's on-disk format (``store``)."""
