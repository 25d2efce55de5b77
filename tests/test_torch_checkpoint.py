"""The port's checkpoint store against the JAX package's, on the CPU.

One format, two packages: a tree of fp32, bf16, int32 and scalar leaves
written by one package is read back by the other bit for bit (the elastic
sharded format, also with ``block=False``, and the legacy one), with
several shard boxes a leaf on both sides. On a corrupted step
(``flip_npz_byte``, ``truncate_file``: the reference's chaos primitives)
``verify_checkpoint`` lists the same problems on both sides and a restore
raises the same ``ValueError`` text; quarantine, ``latest_step(verified=
True)`` falling back, a torn save that is never resumed and ``gc_steps``
never deleting a quarantined step read the same from either side. All
exact: no tolerance.

The port stores an all-zero member (``mu`` here, a fresh optimizer's
moments) deflated and after the others; the JAX package reads it.
``tests/test_torch_checkpoint_cuda.py`` holds the same for CUDA tensors.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.checkpoint import store as jstore
from repro.resilience.faults import flip_npz_byte, truncate_file
from repro_torch.checkpoint import store

SHAPES = {"w": ((8, 4), "float32"), "emb": ((8, 6), "bfloat16"), "ids": ((6,), "int32"),
          "opt/.step": ((), "int32"), "scale": ((), "float32"), "mu": ((5, 4), "float32")}
WRITERS = ("jax", "port")


def _numpy_tree():
    """The tree's leaves as numpy (bf16 as its uint16 bits)."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((8, 4)).astype(np.float32)
    emb = torch.from_numpy(rng.standard_normal((8, 6)).astype(np.float32)).bfloat16()
    return {"w": w, "emb": emb.view(torch.int16).numpy().view(np.uint16),
            "ids": np.arange(6, dtype=np.int32) * 7, "opt/.step": np.int32(5),
            "scale": np.float32(0.25), "mu": np.zeros((5, 4), np.float32)}


def _torch_tree():
    out = {}
    for k, v in _numpy_tree().items():
        t = torch.from_numpy(np.array(v))
        out[k] = t.view(torch.int16).view(torch.bfloat16) if SHAPES[k][1] == "bfloat16" else t
    return out


def _jax_tree():
    """JAX arrays, ``w`` cut 2 × 4 and ``emb`` cut over rows on 8 devices."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("x", "y"))
    spec = {"w": P("x", "y"), "emb": P("y", None), "ids": P(), "opt/.step": P(), "scale": P(),
            "mu": P()}
    out = {}
    for k, v in _numpy_tree().items():
        a = jnp.asarray(np.asarray(v).view(jnp.bfloat16) if SHAPES[k][1] == "bfloat16" else v)
        out[k] = jax.device_put(a, NamedSharding(mesh, spec[k]))
    return out


def _port_sharded():
    """The port's tree: ``w`` in four row boxes, ``emb`` in two column boxes."""
    t = _torch_tree()
    return dict(t, w=store.ShardedLeaf((8, 4), torch.float32, tuple(
        (((2 * i, 2 * i + 2), (0, 4)), t["w"][2 * i:2 * i + 2]) for i in range(4))),
        emb=store.ShardedLeaf((8, 6), torch.bfloat16, (
            (((0, 8), (0, 3)), t["emb"][:, :3]), (((0, 8), (3, 6)), t["emb"][:, 3:]))))


def _save(writer, fmt, directory, step):
    if fmt == "legacy":
        if writer == "jax":
            jstore.save(directory, step, _jax_tree())
        else:
            store.save(directory, step, _torch_tree())
        return
    block = fmt == "sharded"
    if writer == "jax":
        out = jstore.save_sharded(directory, step, _jax_tree(), block=block)
    else:
        out = store.save_sharded(directory, step, _port_sharded(), block=block)
    if not block:
        assert out.wait() == os.path.join(directory, f"ckpt_{step:08d}")


def _jax_like():
    return {k: jax.ShapeDtypeStruct(s, jnp.dtype(d)) for k, (s, d) in SHAPES.items()}


def _read_jax(fmt, directory, step):
    """What JAX restores, as numpy bits; the sharded restore onto another
    cut (``w`` over 8 rows, ``emb`` over 2 columns)."""
    if fmt == "legacy":
        got = jstore.restore(directory, step, _jax_like())
    else:
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("z",))
        spec = {"w": P("z", None), "emb": P(None, "z"), "ids": P(), "opt/.step": P(),
                "scale": P(), "mu": P()}
        mesh2 = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("z",))
        sh = {k: NamedSharding(mesh2 if k == "emb" else mesh, spec[k]) for k in SHAPES}
        got = jstore.restore_sharded(directory, step, _jax_like(), sh, verify=True)
    out = {}
    for k, v in got.items():
        a = np.asarray(v)
        assert str(a.dtype) == SHAPES[k][1], (k, a.dtype)
        out[k] = a.view(np.uint16) if SHAPES[k][1] == "bfloat16" else a
    return out


def _read_port(fmt, directory, step):
    """What the port restores, as numpy bits; the sharded restore as whole
    leaves and, for ``w``, as three odd boxes stitched back."""
    like = {k: torch.empty(s, dtype=store._DTYPES[d], device="meta")
            for k, (s, d) in SHAPES.items()}
    if fmt == "legacy":
        got = store.restore(directory, step, like, device="cpu")
    else:
        boxes = (((0, 3), (0, 4)), ((3, 8), (0, 1)), ((3, 8), (1, 4)))
        like["w"] = store.ShardedLeaf((8, 4), torch.float32,
                                      tuple((b, None) for b in boxes))
        got = store.restore_sharded(directory, step, like, verify=True, device="cpu")
        w = torch.empty(8, 4)
        for ((r0, r1), (c0, c1)), t in got["w"].pieces:
            w[r0:r1, c0:c1] = t
        got["w"] = w
    out = {}
    for k, t in got.items():
        assert t.dtype == store._DTYPES[SHAPES[k][1]] and tuple(t.shape) == SHAPES[k][0], k
        out[k] = (t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16
                  else t.numpy())
    return out


@pytest.mark.parametrize("fmt", ["sharded", "sharded-async", "legacy"])
@pytest.mark.parametrize("writer", WRITERS)
def test_tree_written_by_one_package_reads_bitwise_in_the_other(tmp_path, writer, fmt):
    d = str(tmp_path)
    _save(writer, fmt, d, 3)
    want = _numpy_tree()
    for got in (_read_jax(fmt, d, 3), _read_port(fmt, d, 3)):
        for k in SHAPES:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert jstore.verify_checkpoint(d, 3) == store.verify_checkpoint(d, 3) == []
    assert jstore.latest_step(d, verified=True) == store.latest_step(d, verified=True) == 3
    if fmt != "legacy":            # the same file names, boxes and digests
        jm, pm = jstore.read_manifest(d, 3), store.read_manifest(d, 3)
        assert jm["format"] == pm["format"] == store.FORMAT and jm == pm


def test_bf16_is_written_as_v2_records_and_zeros_deflated_last(tmp_path):
    import zipfile
    store.save_sharded(str(tmp_path), 1, _torch_tree())
    path = tmp_path / "ckpt_00000001" / "shards_00000.npz"
    with np.load(path) as z:
        assert z["emb##0"].dtype == np.dtype("V2")
    assert store.read_manifest(str(tmp_path), 1)["leaves"]["emb"]["dtype"] == "bfloat16"
    members = zipfile.ZipFile(path).infolist()
    deflated = [m.filename for m in members if m.compress_type == zipfile.ZIP_DEFLATED]
    assert deflated == ["mu##0.npy"] and members[-1].filename == "mu##0.npy"


def _corrupt(kind, directory, step, fmt):
    path = (os.path.join(directory, f"ckpt_{step:08d}", "shards_00000.npz")
            if fmt == "sharded" else os.path.join(directory, f"ckpt_{step:08d}.npz"))
    if kind == "flip":
        flip_npz_byte(path)
    else:
        truncate_file(path, frac=0.3)


def _error(fn):
    with pytest.raises(ValueError) as ei:
        fn()
    return str(ei.value)


@pytest.mark.parametrize("fmt", ["sharded", "legacy"])
@pytest.mark.parametrize("kind", ["flip", "truncate"])
@pytest.mark.parametrize("writer", WRITERS)
def test_corruption_reads_the_same_on_both_sides(tmp_path, writer, kind, fmt):
    d = str(tmp_path)
    for step in (1, 2):
        _save(writer, fmt, d, step)
    _corrupt(kind, d, 2, fmt)
    problems = jstore.verify_checkpoint(d, 2)
    assert problems and store.verify_checkpoint(d, 2) == problems
    like_j = _jax_like()
    like_p = {k: torch.empty(s, dtype=store._DTYPES[t], device="meta")
              for k, (s, t) in SHAPES.items()}
    if fmt == "legacy":
        msg = _error(lambda: jstore.restore(d, 2, like_j))
        assert _error(lambda: store.restore(d, 2, like_p)) == msg
    else:
        sh = {k: jax.sharding.SingleDeviceSharding(jax.devices()[0]) for k in SHAPES}
        if kind == "truncate":   # unreadable without verify too
            msg = _error(lambda: jstore.restore_sharded(d, 2, like_j, sh))
            assert _error(lambda: store.restore_sharded(d, 2, like_p)) == msg
        msg = _error(lambda: jstore.restore_sharded(d, 2, like_j, sh, verify=True))
        assert _error(lambda: store.restore_sharded(d, 2, like_p, verify=True)) == msg
        assert "suggested fallback: step 1" in msg and "step 2" in msg
    assert "corrupt or truncated" in msg
    # The verified walk falls back to step 1 on either side, quarantining step 2.
    for latest in (store.latest_step, jstore.latest_step):
        assert latest(d) in (1, 2)
        assert latest(d, verified=True) == 1
    assert store.is_quarantined(d, 2) and jstore.is_quarantined(d, 2)
    assert store.available_steps(d) == jstore.available_steps(d) == [1]


@pytest.mark.parametrize("writer", WRITERS)
def test_torn_save_is_never_resumed(tmp_path, writer):
    d = str(tmp_path)
    for step in (1, 2):
        _save(writer, "sharded", d, step)
    truncate_file(os.path.join(d, "ckpt_00000002", "shards_00000.npz"), frac=0.4)
    os.remove(os.path.join(d, "ckpt_00000002.done"))
    for latest in (store.latest_step, jstore.latest_step):
        assert latest(d) == 1 and latest(d, verified=True) == 1
    assert not store.is_quarantined(d, 2)       # invisible, not quarantined
    got = _read_port("sharded", d, 1)
    np.testing.assert_array_equal(got["w"], _numpy_tree()["w"])


@pytest.mark.parametrize("collector", WRITERS)
def test_gc_never_deletes_a_quarantined_step(tmp_path, collector):
    d = str(tmp_path)
    other = jstore if collector == "port" else store
    mine = store if collector == "port" else jstore
    for step in (1, 2, 3, 4):
        _save("port" if collector == "jax" else "jax", "sharded", d, step)
    other.quarantine(d, 2, "synthetic evidence")
    assert mine.gc_steps(d, keep=2) == [1]
    for s in (store, jstore):
        assert s.available_steps(d) == [3, 4]
        assert s.available_steps(d, include_quarantined=True) == [2, 3, 4]
        assert s.is_quarantined(d, 2)
    assert mine.gc_steps(d, keep=0) == [3]      # keep floors at 1
    assert other.available_steps(d) == [4]


def test_restore_names_missing_keys_and_dtype_mismatch(tmp_path):
    d = str(tmp_path)
    _save("jax", "sharded", d, 1)
    like = {k: torch.empty(s, dtype=store._DTYPES[t], device="meta")
            for k, (s, t) in SHAPES.items()}
    like_j = _jax_like()
    sh = {k: jax.sharding.SingleDeviceSharding(jax.devices()[0]) for k in SHAPES}

    def both(port_like, jax_like):
        msg = _error(lambda: jstore.restore_sharded(d, 1, jax_like, sh))
        assert _error(lambda: store.restore_sharded(d, 1, port_like)) == msg
        return msg
    assert "missing from checkpoint: ['extra']" in both(
        dict(like, extra=like["w"]), dict(like_j, extra=like_j["w"]))
    assert "no implicit cast" in both(
        dict(like, w=like["w"].to(torch.bfloat16)),
        dict(like_j, w=jax.ShapeDtypeStruct((8, 4), jnp.bfloat16)))
