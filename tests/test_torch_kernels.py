"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; they are
held against the Pallas kernels in interpret mode (and the jnp blockwise
core) on the same numpy inputs. The CUDA kernels themselves are held
against the plain versions in ``test_torch_kernels_cuda.py`` on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash.flash import flash_attention as jax_flash
from repro.kernels.gmm.gmm import gmm as jax_gmm
from repro.kernels.gmm.ops import expert_ffn_gmm as jax_expert_ffn_gmm
from repro.models.attn_core import blockwise_attention
from repro.models.attn_core import naive_attention as jax_naive_attention
from repro_torch.kernels.flash.flash import KV_TILE, flash_attention, plan, split_ranges
from repro_torch.kernels.flash.ops import flash
from repro_torch.kernels.flash.ref import flash_ref
from repro_torch.kernels.gmm.gmm import gmm, tile_shape
from repro_torch.kernels.gmm.ops import expert_ffn_gmm
from repro_torch.models.attn_core import _merge_partials, naive_attention

torch.set_num_threads(1)

# (M, K, N, E, bm, layout): a subset of tests/test_kernels.py::GMM_SHAPES with
# random block_expert, and the serving layout (one row block per expert,
# block_expert = arange(E)) that the decode step hands the kernel.
GMM_SHAPES = [(256, 128, 128, 4, 128, "random"), (512, 256, 384, 8, 64, "random"),
              (512, 128, 256, 4, 128, "serving"), (64, 128, 128, 8, 8, "serving"),
              (192, 128, 256, 4, 24, "random")]
GMM_IDS = ["-".join(map(str, s[:5])) + ("" if s[5] == "random" else f"-{s[5]}")
           for s in GMM_SHAPES]
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
GMM_TOL = {"float32": 1e-4, "bfloat16": 3e-2}   # tests/test_kernels.py's own


def _t(a, dtype="float32"):
    return torch.from_numpy(np.asarray(a)).to(TORCH_DT[dtype])


def _gmm_inputs(M, K, N, E, bm, layout="random", seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((E, K, N)) * 0.1).astype(np.float32)
    if layout == "serving":
        assert M == E * bm
        be = np.arange(E, dtype=np.int32)
    else:
        be = rng.integers(0, E, M // bm).astype(np.int32)
    return x, w, be


@pytest.mark.parametrize("M,K,N,E,bm,layout", GMM_SHAPES, ids=GMM_IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_plain_matches_jax_kernel(M, K, N, E, bm, layout, dtype):
    x, w, be = _gmm_inputs(M, K, N, E, bm, layout)
    yj = jax_gmm(jnp.asarray(x, JAX_DT[dtype]), jnp.asarray(w, JAX_DT[dtype]),
                 jnp.asarray(be), bm=bm, interpret=True)
    yt = gmm(_t(x, dtype), _t(w, dtype), torch.from_numpy(be), bm=bm)
    assert yt.dtype == TORCH_DT[dtype]
    np.testing.assert_allclose(yt.float().numpy(), np.asarray(yj, np.float32),
                               atol=GMM_TOL[dtype], rtol=GMM_TOL[dtype])


@pytest.mark.parametrize("M,N,bm,E,tile", [
    (1024, 16384, 128, 8, (128, 256)),  # decode gate/up: 512 wide tiles fill 4 waves 97%
    (1024, 6144, 128, 8, (128, 128)),   # decode down: 192 wide tiles fill 2 waves 73%
    (8192, 16384, 128, 8, (128, 256)), (8192, 6144, 128, 8, (128, 256)),
    (1024, 16384, 64, 8, (64, 256)),
    (256, 6144, 128, 8, (128, 128)),    # 48 wide tiles on 132 SMs
    (512, 384, 64, 8, (64, 128)), (512, 512, 256, 8, (128, 128)),
    # Row blocks that 64 does not divide: the swap-AB kernel, (rows a pass, 128),
    # a pass holding one expert's run (at decode one block: bm to a power of two).
    (64, 16384, 8, 8, (8, 128)), (128, 16384, 16, 8, (16, 128)), (256, 16384, 32, 8, (32, 128)),
    (192, 16384, 24, 8, (32, 128)), (768, 6144, 96, 8, (128, 128)),
    (192, 256, 24, 16, (32, 128)),      # fewer blocks than experts: one block a run
    (256, 16384, 8, 8, (32, 128)),      # 4 blocks an expert: one pass a run
    (8192, 16384, 8, 8, (128, 128)),    # 1024 rows an expert: 8 passes a run
    (1280, 2048, 160, 8, (128, 128))])  # a block longer than the widest pass
def test_gmm_tile_shape(M, N, bm, E, tile):
    """The kernel's tile: 64-row tiles only where bm needs them, 256 columns
    only where N allows and narrow tiles would not fill the SMs' waves
    better by over a tenth; for bm % 64 != 0 the swap-AB kernel's pass."""
    assert tile_shape(M, N, bm, n_sms=132, experts=E) == tile


def test_expert_ffn_gmm_matches_jax():
    rng = np.random.default_rng(1)
    E, N, D, F = 4, 128, 128, 256
    xe = rng.standard_normal((E, N, D)).astype(np.float32)
    w1, w3 = ((rng.standard_normal((E, D, F)) * 0.05).astype(np.float32) for _ in range(2))
    w2 = (rng.standard_normal((E, F, D)) * 0.05).astype(np.float32)
    yj = jax_expert_ffn_gmm(*(jnp.asarray(a) for a in (xe, w1, w2, w3)), "swiglu",
                            interpret=True)
    yt = expert_ffn_gmm(*(_t(a) for a in (xe, w1, w2, w3)), "swiglu")
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5, rtol=1e-5)


FLASH_CASES = [
    dict(B=2, H=4, Hkv=2, Sq=128, Skv=256, hd=64, q_off=128, kv_off=0, causal=True, window=0),
    dict(B=1, H=4, Hkv=2, Sq=128, Skv=256, hd=64, q_off=200, kv_off=64, causal=True, window=0),
    dict(B=2, H=4, Hkv=2, Sq=128, Skv=256, hd=64, q_off=128, kv_off=0, causal=True, window=96),
    dict(B=1, H=2, Hkv=2, Sq=128, Skv=128, hd=64, q_off=0, kv_off=0, causal=False, window=0),
    dict(B=1, H=4, Hkv=4, Sq=128, Skv=256, hd=80, q_off=128, kv_off=0, causal=True, window=0),
]


def _qkv(B, H, Hkv, Sq, Skv, hd, seed=0, **_):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, hd)).astype(np.float32),
            rng.standard_normal((B, Hkv, Skv, hd)).astype(np.float32),
            rng.standard_normal((B, Hkv, Skv, hd)).astype(np.float32))


@pytest.mark.parametrize("c", FLASH_CASES)
@pytest.mark.parametrize("partial", [False, True])
def test_flash_plain_matches_jax_kernel(c, partial):
    q, k, v = _qkv(**c)
    yj = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=c["q_off"],
                   kv_offset=c["kv_off"], causal=c["causal"], window=c["window"],
                   interpret=True, return_partial=partial)
    yt = flash(_t(q), _t(k), _t(v), q_offset=c["q_off"], kv_offset=c["kv_off"],
               causal=c["causal"], window=c["window"], return_partial=partial)
    pairs = zip(yt, yj) if partial else [(yt, yj)]
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("partial", [False, True])
def test_flash_per_row_offsets_match_blockwise(partial):
    """Per-row q_offset (the batched decode step) against the jnp blockwise
    core with per-row position arrays."""
    B, H, Hkv, Sq, Skv, hd = 3, 4, 2, 6, 96, 64
    q, k, v = _qkv(B, H, Hkv, Sq, Skv, hd, seed=2)
    offs = np.array([0, 37, 90], np.int32)
    q_pos = offs[:, None] + np.arange(Sq, dtype=np.int32)[None]
    kv_pos = np.broadcast_to(np.arange(Skv, dtype=np.int32), (B, Skv))
    yj = blockwise_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(q_pos), jnp.asarray(kv_pos), causal=True,
                             return_partial=partial)
    yt = flash_attention(_t(q), _t(k), _t(v), torch.from_numpy(offs), causal=True,
                         return_partial=partial)
    pairs = zip(yt, yj) if partial else [(yt, yj)]
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)


def test_partials_over_kv_halves_merge_to_full_attention():
    """Flash-decode contract: partials over two KV shards (the second at a
    kv_offset), merged online, equal attention over the whole cache — and
    the port's naive oracle equals the JAX package's."""
    B, H, Hkv, Sq, Skv, hd = 2, 4, 2, 8, 64, 64
    q, k, v = _qkv(B, H, Hkv, Sq, Skv, hd, seed=3)
    offs = torch.tensor([20, 56])
    h = Skv // 2
    a = flash_attention(_t(q), _t(k[:, :, :h]), _t(v[:, :, :h]), offs, return_partial=True)
    b = flash_attention(_t(q), _t(k[:, :, h:]), _t(v[:, :, h:]), offs, kv_offset=h,
                        return_partial=True)
    m, l, acc = _merge_partials(a[1], a[2], a[0], b[1], b[2], b[0])
    merged = acc / torch.clamp(l, min=1e-30)[..., None]
    q_pos = offs[:, None] + torch.arange(Sq)
    kv_pos = torch.arange(Skv).expand(B, Skv)
    ref = naive_attention(_t(q), _t(k), _t(v), q_pos, kv_pos)
    np.testing.assert_allclose(merged.numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)
    refj = jax_naive_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(q_pos.numpy()), jnp.asarray(kv_pos.numpy()))
    np.testing.assert_allclose(ref.numpy(), np.asarray(refj), atol=1e-5, rtol=1e-5)


# Stream blocks an H100 SM holds by head size (flash.cu's
# repro_flash_stream_blocks there: the occupancy API on SplitCfg's shared memory).
H100_STREAM_BLOCKS = {64: 4, 80: 2, 128: 2, 256: 1}


@pytest.mark.parametrize("shape,path,splits", [
    ((4, 48, 8, 1, 512, 128), "decode", 4),     # serving decode: 32 groups, 2 tiles a split
    ((4, 48, 8, 1, 32768, 128), "decode", 17),  # long decode: 17 x 32 blocks on 132 SMs
    ((1, 48, 8, 200, 512, 128), "prefill", 1),  # serving prefill chunk: 1200 packed rows
    ((1, 48, 8, 4096, 4096, 128), "prefill", 1),
    ((2, 48, 8, 10, 512, 128), "decode", 4),    # 60 packed rows: 4 row tiles
    ((2, 48, 8, 11, 512, 128), "prefill", 1),   # 66 packed rows
    ((1, 4, 1, 1, 40, 256), "decode", 1),       # one tile: one split
    # One row a KV head (multi-head decode) streams: as many splits as fill
    # the blocks an SM holds (1 at heads of 256, 2 at 128 and 80, 4 at 64)
    # over the groups in one wave, at least one 64-key tile each.
    ((2, 16, 16, 1, 1024, 256), "stream", 4),   # Gemma: 32 groups on 132 blocks
    ((1, 12, 12, 1, 1500, 64), "stream", 24),   # Whisper's cross-attention: one tile a split
    ((4, 32, 32, 1, 1024, 128), "stream", 2),   # CodeQwen1.5: 128 groups on 264 blocks
    ((2, 32, 32, 1, 1024, 80), "stream", 4),    # Zamba2
    ((16, 32, 32, 1, 4096, 64), "stream", 1),   # as many groups as blocks: no split
    ((1, 4, 4, 1, 40, 64), "stream", 1),        # one tile: one split
    ((2, 32, 8, 1, 8192, 64), "stream", 33),    # 4 rows of 64 (the ring decode): 256 <= 512
    ((1, 8, 1, 1, 512, 64), "stream", 8),       # 8 rows of 64: the most that stream
    ((1, 9, 1, 1, 512, 64), "decode", 4),       # 9 rows of 64
    ((2, 8, 4, 1, 512, 256), "stream", 8),      # 2 rows of 256: the most that stream there
    ((1, 3, 1, 1, 512, 256), "decode", 4),      # 3 rows of 256
])
def test_flash_plan(shape, path, splits):
    """The host's choice of device path and KV split count (an H100: 132
    SMs and the stream blocks each holds)."""
    assert plan(*shape, n_sms=132, stream_blocks=H100_STREAM_BLOCKS[shape[5]]) == (path, splits)


@pytest.mark.parametrize("blocks,splits", [(1, 4), (2, 8), (3, 12), (8, 16)])
def test_flash_plan_follows_stream_blocks(blocks, splits):
    """Gemma's decode (32 groups, 16 tiles) splits to fill the stream blocks
    the card's SMs hold, one tile a split at most."""
    assert plan(2, 16, 16, 1, 1024, 256, 132, blocks) == ("stream", splits)


def test_flash_plan_forced_and_rejected():
    assert plan(4, 48, 8, 1, 512, 128, 132, 2, path="prefill") == ("prefill", 1)
    assert plan(1, 48, 8, 200, 512, 128, 132, 2, path="decode", splits=3) == ("decode", 3)
    assert plan(2, 16, 16, 1, 1024, 256, 132, 1, path="decode") == ("decode", 8)
    assert plan(2, 16, 16, 1, 1024, 256, 132, 1, splits=16) == ("stream", 16)
    with pytest.raises(ValueError, match="does not split"):
        plan(1, 48, 8, 200, 512, 128, 132, 2, path="prefill", splits=2)
    with pytest.raises(ValueError, match="path"):
        plan(1, 48, 8, 200, 512, 128, 132, 2, path="ring")
    with pytest.raises(ValueError, match="splits"):
        plan(1, 48, 8, 1, 512, 128, 132, 2, splits=0)
    with pytest.raises(ValueError, match="rows x hd"):
        plan(4, 48, 8, 1, 512, 128, 132, 2, path="stream")


@pytest.mark.parametrize("q_first,q_last,Skv,kw,ranges", [
    (511, 511, 512, dict(splits=4), [(0, 128), (128, 256), (256, 384), (384, 512)]),
    (300, 300, 512, dict(splits=4), [(0, 128), (128, 256), (256, 301)]),   # 5 tiles: 3 runs of 2
    (0, 0, 512, dict(splits=4), [(0, 1)]),
    (60, 75, 256, dict(splits=2), [(0, 64), (64, 76)]),                   # row 60 sees no key of split 2
    (300, 301, 256, dict(splits=3, kv_offset=100), [(0, 128), (128, 202)]),
    (250, 253, 256, dict(splits=3, window=50), [(201, 254)]),             # one tile
    (250, 253, 1024, dict(splits=8, window=100), [(151, 192), (192, 254)]),
    (10, 10, 256, dict(splits=2, window=5, kv_offset=200), [(0, 0)]),     # sees nothing: one empty split
    (0, 2, 100, dict(splits=2, causal=False), [(0, 64), (64, 100)]),
    # One row a KV head (the stream path's plans): Gemma's decode row at
    # 1023 and one at 300 against 1024 keys (heads of 256, 4 splits), and
    # Whisper's cross-attention over 1500 frames (heads of 64, 24 splits of
    # one tile, the last ragged).
    (1023, 1023, 1024, dict(splits=4), [(0, 256), (256, 512), (512, 768), (768, 1024)]),
    (300, 300, 1024, dict(splits=4), [(0, 128), (128, 256), (256, 301)]),
    (0, 0, 1500, dict(splits=24, causal=False),
     [(64 * t, min(1500, 64 * t + 64)) for t in range(24)]),
    (1040, 1040, 8192, dict(splits=24, window=1024), [(17, 64)] +
     [(64 * t, 64 * t + 64) for t in range(1, 16)] + [(1024, 1041)]),
])
def test_flash_split_ranges(q_first, q_last, Skv, kw, ranges):
    """Which keys each KV split of a decode group covers: runs of whole
    64-key tiles over the keys the group can see, clipped to them."""
    got = split_ranges(q_first, q_last, Skv, **kw)
    assert got == ranges
    assert all(a % KV_TILE == 0 for a, _ in got[1:])


def _split_merge(q, k, v, offs, *, kv_offset, causal, window, splits):
    """The decode path's arithmetic on the CPU: the (H / Hkv) x Sq rows of a
    GQA group packed into 16-row tiles, each tile's visible keys cut by
    ``split_ranges``, one ``flash_ref`` partial per split (m = -1e30, l = 0
    where it has no key), merged with ``_merge_partials``."""
    B, H, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    rep, R = H // Hkv, (H // Hkv) * Sq
    acc = torch.zeros((B, H, Sq, hd))
    m = torch.full((B, H, Sq), -1e30)
    l = torch.zeros((B, H, Sq))
    for b in range(B):
        for hk in range(Hkv):
            heads = slice(hk * rep, (hk + 1) * rep)
            for r0 in range(0, R, 16):
                rows = range(r0, min(R, r0 + 16))
                ranges = split_ranges(offs[b] + r0 // rep, offs[b] + rows[-1] // rep, Skv,
                                      kv_offset=kv_offset, causal=causal, window=window,
                                      splits=splits)
                assert 1 <= len(ranges) <= splits
                for start, end in ranges:
                    if start == end:
                        continue                 # an empty split's partial is the identity
                    pa, pm, pl = flash_ref(
                        q[b:b + 1, heads], k[b:b + 1, hk:hk + 1, start:end],
                        v[b:b + 1, hk:hk + 1, start:end], torch.tensor([offs[b]]),
                        kv_offset=kv_offset + start, causal=causal, window=window,
                        return_partial=True)
                    for r in rows:
                        h, i = hk * rep + r % rep, r // rep
                        mm, ll, aa = _merge_partials(m[b, h, i], l[b, h, i], acc[b, h, i],
                                                     pm[0, r % rep, i], pl[0, r % rep, i],
                                                     pa[0, r % rep, i])
                        m[b, h, i], l[b, h, i], acc[b, h, i] = mm, ll, aa
    return acc, m, l


# (B, H, Hkv, Sq, Skv, hd, q_offset per batch row, kv_offset, causal, window, splits)
SPLIT_CASES = [
    (3, 12, 2, 1, 256, 64, [0, 77, 255], 0, True, 0, 4),     # GQA packing, per-row offsets
    (1, 2, 2, 16, 256, 64, [60], 0, True, 0, 2),              # row 60 sees no key of split 2
    (2, 8, 2, 2, 256, 64, [300, 140], 100, True, 0, 3),       # kv_offset
    (2, 4, 1, 4, 256, 64, [250, 90], 0, True, 50, 3),         # window
    (1, 8, 1, 5, 96, 128, [91], 0, True, 0, 2),               # hd 128, 3 row tiles
    (1, 4, 2, 3, 128, 64, [0], 0, False, 0, 2),               # not causal
    (2, 2, 1, 2, 256, 64, [1000, 20], 0, True, 30, 2),        # row 0 sees nothing
    (2, 32, 32, 1, 256, 80, [255, 100], 0, True, 0, 3),       # hd 80 (Zamba2's decode)
    (2, 4, 4, 1, 256, 64, [255, 100], 0, True, 0, 4),         # one row a KV head, 1-tile splits
    (1, 3, 3, 1, 128, 64, [0], 0, False, 0, 2),               # not causal (cross-attention)
    (1, 2, 2, 1, 256, 256, [255], 0, True, 0, 4),             # hd 256 (Gemma's decode)
    (2, 2, 2, 1, 256, 256, [255, 40], 0, True, 100, 2),       # hd 256, window
]


@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,hd,offs,kv_off,causal,window,splits", SPLIT_CASES)
@pytest.mark.parametrize("partial", [False, True])
def test_flash_split_merge_matches_jax_kernel(B, H, Hkv, Sq, Skv, hd, offs, kv_off, causal,
                                              window, splits, partial):
    """The decode path's plan (packed GQA rows, KV splits, merge) computes
    the JAX kernel's function: each batch row through the Pallas kernel in
    interpret mode at its own offset."""
    q, k, v = _qkv(B, H, Hkv, Sq, Skv, hd, seed=5)
    acc, m, l = _split_merge(_t(q), _t(k), _t(v), offs, kv_offset=kv_off, causal=causal,
                             window=window, splits=splits)
    rows = [jax_flash(jnp.asarray(q[b:b + 1]), jnp.asarray(k[b:b + 1]), jnp.asarray(v[b:b + 1]),
                      q_offset=offs[b], kv_offset=kv_off, causal=causal, window=window,
                      interpret=True, return_partial=partial) for b in range(B)]
    if partial:
        want = [np.concatenate([np.asarray(r[j]) for r in rows]) for j in range(3)]
        got = [acc, m, l]
    else:
        want = [np.concatenate([np.asarray(r) for r in rows])]
        got = [acc / torch.clamp(l, min=1e-30)[..., None]]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5, rtol=1e-5)


def test_cpu_tensors_leave_launch_counters_at_zero():
    g0, f0 = gmm.launches, flash_attention.launches
    x, w, be = _gmm_inputs(*GMM_SHAPES[0])
    gmm(_t(x), _t(w), torch.from_numpy(be))
    q, k, v = _qkv(**FLASH_CASES[0])
    flash(_t(q), _t(k), _t(v), q_offset=128)
    assert (gmm.launches, flash_attention.launches) == (g0, f0) == (0, 0)


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from repro_torch.configs import get_config, reduced
    from repro_torch.convert import params_from_jax
    from repro_torch.device import resolve_device
    from repro_torch.models.transformer import init_lm
    cfg = reduced(get_config("mixtral-8x22b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_lm(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({}, cfg)
    assert resolve_device("cpu").type == "cpu"


# ---------------------------------------------------------------------------
# Gradients: the GMM and flash autograd Functions on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,K,N,E,bm,layout", GMM_SHAPES, ids=GMM_IDS)
def test_gmm_trans_w_plain_matches_jax_kernel(M, K, N, E, bm, layout):
    """``trans_w``: x @ w[e]^T equals the Pallas kernel on a transposed copy."""
    x, w, be = _gmm_inputs(M, K, N, E, bm, layout)
    x_t = np.ascontiguousarray(x[:, :K])                          # (M, K) against w (E, N, K)
    w_t = np.ascontiguousarray(w.transpose(0, 2, 1))
    yj = jax_gmm(jnp.asarray(x_t), jnp.asarray(w), jnp.asarray(be), bm=bm, interpret=True)
    yt = gmm(_t(x_t), _t(w_t), torch.from_numpy(be), bm=bm, trans_w=True)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-4, rtol=1e-4)


def test_grouped_matmul_grads_match_autograd_of_plain():
    from repro_torch.kernels.gmm.ops import GroupedMatmul, uniform_block_expert
    from repro_torch.kernels.gmm.ref import gmm_ref
    rng = np.random.default_rng(4)
    E, span, K, N, bm = 4, 128, 128, 256, 64
    x = _t(rng.standard_normal((E * span, K))).requires_grad_()
    w = _t(rng.standard_normal((E, K, N)) * 0.1).requires_grad_()
    dy = _t(rng.standard_normal((E * span, N)))
    be = uniform_block_expert(E, span, bm)
    y = GroupedMatmul.apply(x, w, be, bm)
    dx, dw = torch.autograd.grad(y, (x, w), dy)
    y_ref = gmm_ref(x, w, be, bm=bm)
    dx_ref, dw_ref = torch.autograd.grad(y_ref, (x, w), dy)
    np.testing.assert_array_equal(y.detach().numpy(), y_ref.detach().numpy())
    for a, b in ((dx, dx_ref), (dw, dw_ref)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=1e-5)


def test_expert_ffn_gmm_grads_match_jax_einsum():
    """The expert FFN's gradients (dgrad through ``trans_w``, wgrad by bmm)
    equal ``jax.grad`` of the JAX package's einsum expert FFN."""
    import jax
    from repro.core.dispatcher import _expert_ffn_einsum
    rng = np.random.default_rng(5)
    E, N, D, F = 4, 128, 128, 256
    xe = rng.standard_normal((E, N, D)).astype(np.float32)
    ws = [(rng.standard_normal(s) * 0.05).astype(np.float32)
          for s in ((E, D, F), (E, F, D), (E, D, F))]
    dy = rng.standard_normal((E, N, D)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: _expert_ffn_einsum(*a, "swiglu"),
                     *(jnp.asarray(a) for a in (xe, *ws)))
    want = vjp(jnp.asarray(dy))
    args = [_t(a).requires_grad_() for a in (xe, *ws)]
    y = expert_ffn_gmm(*args, "swiglu")
    got = torch.autograd.grad(y, args, _t(dy))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4)


ATTN_GRAD_CASES = [
    dict(B=2, H=4, Hkv=2, S=192, hd=64, causal=True, window=0, block=64),
    dict(B=1, H=4, Hkv=1, S=128, hd=64, causal=True, window=40, block=32),
    dict(B=1, H=2, Hkv=2, S=96, hd=64, causal=False, window=0, block=96),
    dict(B=1, H=2, Hkv=2, S=160, hd=80, causal=True, window=0, block=64),  # Zamba2's heads
]


@pytest.mark.parametrize("c", ATTN_GRAD_CASES)
def test_blockwise_attention_backward_matches_jax_vjp(c):
    """Forward (flash partials → out) and backward (``_bwd_scan``, GQA folded)
    against the JAX package's ``blockwise_attention`` and its flash VJP."""
    import jax
    from repro_torch.models.attn_core import blockwise_attention as port_blockwise
    q, k, v = _qkv(c["B"], c["H"], c["Hkv"], c["S"], c["S"], c["hd"], seed=6)
    dout = np.random.default_rng(7).standard_normal(q.shape).astype(np.float32)
    pos = np.broadcast_to(np.arange(c["S"], dtype=np.int32), (c["B"], c["S"]))
    kw = dict(causal=c["causal"], window=c["window"], block_kv=c["block"])
    yj, vjp = jax.vjp(lambda q, k, v: blockwise_attention(q, k, v, jnp.asarray(pos),
                                                          jnp.asarray(pos), **kw),
                      jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    args = [_t(a).requires_grad_() for a in (q, k, v)]
    tpos = torch.from_numpy(pos.copy())
    yt = port_blockwise(*args, tpos, tpos, **kw)
    got = torch.autograd.grad(yt, args, _t(dout))
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), atol=1e-5, rtol=1e-5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4)


def test_flash_function_grads_match_autograd_of_plain():
    from repro_torch.models.attn_core import blockwise_attention as port_blockwise
    B, H, Hkv, S, hd = 1, 4, 2, 160, 64
    q, k, v = (_t(a).requires_grad_() for a in _qkv(B, H, Hkv, S, S, hd, seed=8))
    dout = _t(np.random.default_rng(9).standard_normal((B, H, S, hd)))
    got = torch.autograd.grad(port_blockwise(q, k, v, block_kv=64), (q, k, v), dout)
    ref = flash_ref(q, k, v, torch.zeros(B, dtype=torch.int32))
    want = torch.autograd.grad(ref, (q, k, v), dout)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=1e-4)


# Query positions that are no run (``query_positions``), beside keys at the
# same positions ("self") or at kv_offset + j ("run", offset 40: queries
# below it see no key): (B, H, Hkv, Sq, Skv, hd, kind, keys, causal, window).
QPOS_CASES = [
    (2, 4, 2, 48, 48, 64, "packed", "self", True, 0),
    (2, 4, 2, 48, 48, 80, "shared", "self", True, 16),
    (2, 4, 4, 48, 48, 128, "packed", "self", False, 12),
    (2, 4, 1, 40, 96, 256, "offsets", "run", True, 20),
    (2, 2, 2, 40, 96, 64, "packed", "run", True, 0),
    (1, 2, 2, 40, 96, 128, "shared", "run", False, 30),
]
QPOS_IDS = ["-".join(str(x) for x in (c[5], c[6], c[7], c[8], f"w{c[9]}")) for c in QPOS_CASES]


def _qpos_case(B, H, Hkv, Sq, Skv, hd, kind, keys, seed=12):
    from test_torch_kernels_cuda import query_positions
    q, k, v = _qkv(B, H, Hkv, Sq, Skv, hd, seed=seed)
    q_pos = query_positions(kind, B, Sq, seed)
    kv_pos = q_pos if keys == "self" else \
        np.broadcast_to(40 + np.arange(Skv, dtype=np.int32), (B, Skv)).copy()
    return q, k, v, q_pos, kv_pos


@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,hd,kind,keys,causal,window", QPOS_CASES, ids=QPOS_IDS)
@pytest.mark.parametrize("partial", [False, True])
def test_flash_query_positions_match_blockwise(B, H, Hkv, Sq, Skv, hd, kind, keys, causal,
                                              window, partial):
    """The plain flash at (B, Sq) query positions, with key positions or a
    key offset, against the jnp blockwise core at the same position arrays:
    causal, window and both, every head size; rows that see no key give 0
    (m = -1e30, l = 0 in the partials), as the reference's scan does."""
    q, k, v, q_pos, kv_pos = _qpos_case(B, H, Hkv, Sq, Skv, hd, kind, keys)
    yj = blockwise_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_pos),
                             jnp.asarray(kv_pos), causal=causal, window=window,
                             return_partial=partial)
    kv = dict(kv_pos=torch.from_numpy(kv_pos)) if keys == "self" else dict(kv_offset=40)
    yt = flash_attention(_t(q), _t(k), _t(v), None, q_pos=torch.from_numpy(q_pos),
                         causal=causal, window=window, return_partial=partial, **kv)
    pairs = zip(yt, yj) if partial else [(yt, yj)]
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)
    if keys == "run" and causal:            # queries below key 40 see none
        hidden = q_pos < 40
        assert hidden.any()
        out = yt[0] if partial else yt
        assert out.numpy()[np.broadcast_to(hidden[:, None], out.shape[:3])].max(initial=0) == 0
        if partial:
            assert (yt[1].numpy()[np.broadcast_to(hidden[:, None], yt[1].shape)] == -1e30).all()


@pytest.mark.parametrize("c", [0, 1, 3], ids=[QPOS_IDS[i] for i in (0, 1, 3)])
def test_blockwise_attention_at_positions_matches_jax_vjp(c):
    """``blockwise_attention`` with position arrays (the kernel's q_pos /
    kv_pos forward, ``_bwd_scan`` masked by the arrays) against the JAX
    package's flash VJP at the same positions."""
    import jax
    from repro_torch.models.attn_core import blockwise_attention as port_blockwise
    B, H, Hkv, Sq, Skv, hd, kind, keys, causal, window = QPOS_CASES[c]
    q, k, v, q_pos, kv_pos = _qpos_case(B, H, Hkv, Sq, Skv, hd, kind, keys)
    dout = np.random.default_rng(13).standard_normal(q.shape).astype(np.float32)
    kw = dict(causal=causal, window=window, block_kv=16)
    yj, vjp = jax.vjp(lambda q, k, v: blockwise_attention(q, k, v, jnp.asarray(q_pos),
                                                          jnp.asarray(kv_pos), **kw),
                      jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    args = [_t(a).requires_grad_() for a in (q, k, v)]
    yt = port_blockwise(*args, torch.from_numpy(q_pos), torch.from_numpy(kv_pos), **kw)
    got = torch.autograd.grad(yt, args, _t(dout))
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), atol=1e-5, rtol=1e-5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4)
