"""Hand-written CUDA kernels of the port, each beside its plain version.

``gmm`` (grouped matmul) and ``flash`` (blockwise attention forward) replace
the JAX package's two Pallas TPU kernels. Their CUDA C++ sources live in
``csrc/`` and are built at first use by ``_build``.
"""
