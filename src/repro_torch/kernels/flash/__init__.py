"""Blockwise attention forward: CUDA kernel (``flash``), plain version
(``ref``), and the front the attention layer calls (``ops``)."""
