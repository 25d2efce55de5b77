"""Grouped matmul: CUDA kernel (``gmm``), plain version (``ref``), and the
expert-FFN front (``ops``)."""
