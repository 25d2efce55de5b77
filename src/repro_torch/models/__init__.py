"""Model code of the port: common blocks, attention, the transformer."""
