"""PyTorch/CUDA port of the ``repro`` package for one NVIDIA H100.

The JAX package ``repro`` stays the reference; this package mirrors its
module layout and names and imports nothing of it (nor of JAX). Kernels
that ``repro`` wrote in Pallas for the TPU are CUDA C++ for ``sm_90a`` here
(``repro_torch.kernels``), each beside a plain PyTorch version of the same
function that runs for CPU tensors.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
