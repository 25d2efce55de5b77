"""The port's checkpoint store on CUDA tensors (marker ``cuda``; skips
without a card, imports no JAX, so it runs on the card's machine):

    timeout -s KILL 150 env PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_checkpoint_cuda.py

A sharded save of CUDA fp32 and bf16 pieces (``block=False``, the host
copies taken before it returns: the tensors are changed in place at once)
and a restore onto the card, bit for bit; bf16 goes through ``V2`` records;
the restored pieces hash to the saved digests. Then a blocking save, which
copies box by box from the card, with an all-zero box (stored deflated).
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import store

pytestmark = pytest.mark.cuda


def test_sharded_roundtrip_of_cuda_tensors(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    w = torch.randn(64, 96, generator=g, device="cuda")
    b = torch.randn(64, 96, generator=g, device="cuda").bfloat16()
    tree = {"w": store.ShardedLeaf((64, 96), torch.float32, (
        (((0, 32), (0, 96)), w[:32]), (((32, 64), (0, 96)), w[32:]))), "b": b}
    d, w0 = str(tmp_path), w.clone()
    pending = store.save_sharded(d, 1, tree, block=False)
    w.add_(1.0)                  # the host copies were taken before save_sharded returned
    pending.wait()
    with np.load(os.path.join(d, "ckpt_00000001", "shards_00000.npz")) as z:
        assert z["b##0"].dtype == np.dtype("V2")
    got = store.restore_sharded(d, 1, {"w": torch.empty(64, 96, device="meta"),
                                       "b": torch.empty(64, 96, dtype=torch.bfloat16,
                                                        device="meta")},
                                verify=True, device="cuda")
    assert got["w"].is_cuda and torch.equal(got["w"], w0)
    assert got["b"].dtype == torch.bfloat16 and torch.equal(got["b"], b)
    assert store.check_digests(d, 1, {"w": tree["w"]._replace(pieces=(
        (((0, 32), (0, 96)), w0[:32]), (((32, 64), (0, 96)), w0[32:]))), "b": b}) == (3, [])
    # A blocking save streams each box from the card as it writes it; an
    # all-zero box is deflated.
    tree["z"] = torch.zeros(128, 64, device="cuda")
    stats = {}
    store.save_sharded(d, 2, tree, stats=stats)
    assert stats["bytes"] == 64 * 96 * 6 + 128 * 64 * 4 > stats["file_bytes"]
    got = store.restore_sharded(d, 2, {k: torch.empty(s, dtype=t, device="meta") for k, s, t in
                                       (("w", (64, 96), torch.float32),
                                        ("b", (64, 96), torch.bfloat16),
                                        ("z", (128, 64), torch.float32))},
                                verify=True, device="cuda")
    assert torch.equal(got["w"], w) and torch.equal(got["b"], b)
    assert torch.equal(got["z"], tree["z"])
