"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (marker ``cuda``) and skips without
one. The file imports nothing of JAX, so it also runs where JAX is not
installed:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash.flash import flash_attention
from repro_torch.kernels.flash.ops import flash
from repro_torch.kernels.flash.ref import flash_ref
from repro_torch.kernels.gmm.gmm import gmm
from repro_torch.kernels.gmm.ref import gmm_ref

pytestmark = pytest.mark.cuda
REL_TOL = 2e-2     # bf16 inputs and outputs; both sides accumulate in fp32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _bf16(rng, shape, scale=1.0, device="cuda"):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)) \
        .to(device=device, dtype=torch.bfloat16)


def _rel_err(got, ref):
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    return ((got - ref).abs().max() / ref.abs().max()).item()


# (M, K, N, E, bm, block_expert, tile): block_expert "random" draws an expert
# per row block, "serving" gives expert i the i-th block, a list is used as
# given; tile None lets the wrapper choose, (BM, BN) forces the kernel's tile.
GMM_CASES = [
    (1024, 256, 384, 4, 128, "random", None),
    (512, 512, 256, 8, 256, "random", None),            # two 128-row tiles per block
    (128, 64, 128, 1, 128, "random", None),             # K = 64: one stage; N = 128
    (512, 256, 384, 8, 64, "random", None),             # bm = 64: 64-row tiles
    (1152, 128, 3968, 4, 128, "random", None),          # 279 tiles: a persistent tail
    (256, 448, 256, 2, 128, "random", None),            # K = 7 x 64, no multiple of the stages
    (256, 128, 6144, 2, 128, "random", None),           # N = 6144
    (1024, 128, 512, 8, 128, [3, 0, 3, 5, 1, 1, 7, 0], None),   # unsorted; 2, 4, 6 own nothing
    (1024, 1024, 1024, 8, 128, "serving", None),
    (512, 192, 512, 4, 128, "random", (128, 256)),
    (512, 192, 512, 4, 128, "random", (128, 128)),
    (512, 192, 512, 4, 128, "random", (64, 256)),
    (512, 192, 512, 4, 128, "random", (64, 128)),
    (512, 320, 512, 8, 64, "random", (64, 256)),
    # Row blocks that 64 does not divide: the swap-AB kernel, passes of 8 to 128 rows.
    (256, 256, 384, 4, 32, "random", None),
    (128, 448, 256, 8, 16, "random", None),
    (64, 128, 6144, 8, 8, "serving", None),
    (192, 448, 384, 8, 24, "serving", None),            # passes of 32: 8 rows not stored
    (320, 256, 384, 8, 40, "serving", None),            # passes of 64
    (384, 192, 512, 4, 96, "random", None),             # passes of 128
    (1280, 128, 256, 8, 160, "random", None),           # 160 = a pass of 128 and one of 32
    (64, 448, 384, 8, 8, [3, 0, 3, 5, 1, 1, 7, 0], None),   # unsorted; 2, 4, 6 own nothing
    (192, 256, 384, 4, 24, [1, 1, 1, 3, 0, 0, 2, 3], None),  # a run of 3 across windows of 2
    (128, 256, 384, 2, 16, [0, 0, 0, 1, 1, 0, 1, 1], None),  # runs of 3, 1, 1, 2 in windows of 4
    (1024, 128, 512, 8, 128, [3, 0, 3, 5, 1, 1, 7, 0], (16, 128)),   # forced on bm 128
    (256, 256, 384, 4, 64, "random", (8, 128)),
    (256, 256, 384, 4, 32, [0, 0, 0, 1, 2, 2, 3, 1], (8, 128)),     # forced: 4 passes a block
]


@pytest.mark.parametrize("M,K,N,E,bm,layout,tile", GMM_CASES)
def test_gmm_kernel_matches_plain(cuda, M, K, N, E, bm, layout, tile):
    rng = np.random.default_rng(3)
    x, w = _bf16(rng, (M, K)), _bf16(rng, (E, K, N), K ** -0.5)
    if layout == "random":
        be = rng.integers(0, E, M // bm)
    elif layout == "serving":
        be = np.arange(M // bm) % E
    else:
        be = np.asarray(layout)
    be = torch.from_numpy(be.astype(np.int32)).to(cuda)
    block_m, block_n = tile or (None, None)
    n0 = gmm.launches
    y = gmm(x, w, be, bm=bm, block_m=block_m, block_n=block_n)
    assert gmm.launches == n0 + 1
    assert _rel_err(y, gmm_ref(x, w, be, bm=bm)) <= REL_TOL


FLASH_CASES = [
    dict(B=2, H=4, Hkv=2, Sq=128, Skv=256, hd=64, q_off=128, kv_off=0, causal=True, window=0),
    dict(B=1, H=4, Hkv=2, Sq=128, Skv=256, hd=64, q_off=200, kv_off=64, causal=True, window=0),
    dict(B=2, H=4, Hkv=2, Sq=128, Skv=256, hd=64, q_off=128, kv_off=0, causal=True, window=96),
    dict(B=1, H=2, Hkv=2, Sq=128, Skv=128, hd=64, q_off=0, kv_off=0, causal=False, window=0),
    dict(B=3, H=8, Hkv=2, Sq=70, Skv=200, hd=128, q_off=5, kv_off=0, causal=True, window=0),
    dict(B=2, H=6, Hkv=3, Sq=1, Skv=77, hd=128, q_off=76, kv_off=0, causal=True, window=30),
]


@pytest.mark.parametrize("c", FLASH_CASES)
@pytest.mark.parametrize("partial", [False, True])
def test_flash_kernel_matches_plain(cuda, c, partial):
    rng = np.random.default_rng(4)
    q = _bf16(rng, (c["B"], c["H"], c["Sq"], c["hd"]))
    k, v = (_bf16(rng, (c["B"], c["Hkv"], c["Skv"], c["hd"])) for _ in range(2))
    offs = torch.arange(c["B"], dtype=torch.int32, device=cuda) * 3 + c["q_off"]
    kw = dict(kv_offset=c["kv_off"], causal=c["causal"], window=c["window"],
              return_partial=partial)
    n0 = flash_attention.launches
    got = flash_attention(q, k, v, offs, **kw)
    assert flash_attention.launches == n0 + 1
    ref = flash_ref(q, k, v, offs, **kw)
    for a, b in (zip(got, ref) if partial else [(got, ref)]):
        assert _rel_err(a, b) <= REL_TOL


def test_flash_kernel_rows_that_see_nothing(cuda):
    """Rows whose window hides every key: output 0, m = -1e30, l = 0, as the
    TPU kernel gives."""
    rng = np.random.default_rng(5)
    q, k = _bf16(rng, (1, 2, 4, 64)), _bf16(rng, (1, 2, 8, 64))
    offs = torch.tensor([100], dtype=torch.int32, device=cuda)
    out = flash_attention(q, k, k, offs, window=4)
    acc, m, l = flash_attention(q, k, k, offs, window=4, return_partial=True)
    torch.cuda.synchronize()
    assert out.abs().max().item() == 0.0 and acc.abs().max().item() == 0.0
    assert (m == -1e30).all() and (l == 0).all()


# Both device paths, forced and chosen: (B, H, Hkv, Sq, Skv, hd, q_offset per
# batch row, kv_offset, causal, window, path, splits). Skv is no multiple of
# the 64- or 128-key tiles unless noted; the decode rows are (H / Hkv) * Sq
# packed rows per KV head.
PATH_CASES = [
    (4, 48, 8, 1, 512, 128, [0, 37, 300, 511], 0, True, 0, None, None),   # serving decode
    (3, 12, 4, 2, 333, 64, [5, 100, 331], 0, True, 0, "decode", None),
    (2, 32, 2, 3, 1000, 128, [997, 400], 0, True, 100, "decode", 7),       # 3 row tiles, window
    (16, 8, 8, 1, 2048, 64, list(range(5, 2048, 128)), 0, True, 0, "decode", None),  # many waves
    (2, 6, 1, 1, 777, 128, [900, 700], 120, True, 0, "decode", 64),        # kv_offset; empty splits
    (1, 4, 1, 40, 257, 64, [217], 0, True, 0, "decode", 3),                # 10 row tiles
    (2, 12, 2, 1, 300, 128, [299, 10], 0, True, 0, "prefill", None),
    (1, 4, 2, 200, 333, 128, [133], 0, True, 0, None, None),               # prefill chunk
    (2, 8, 2, 300, 300, 64, [0, 0], 0, True, 0, "prefill", None),
    (4, 32, 8, 512, 512, 128, [0, 0, 0, 0], 0, True, 0, "prefill", None),  # 512 blocks
    (1, 6, 6, 130, 700, 128, [570], 0, True, 200, None, None),             # window
    (1, 2, 1, 129, 255, 64, [0], 0, False, 0, "prefill", None),            # not causal
    (2, 4, 2, 70, 190, 128, [120, 5], 64, True, 0, "prefill", None),       # kv_offset
    # heads of 256 (Gemma): 64-key prefill tiles, Q fragments read from shared memory
    (2, 16, 16, 1, 1024, 256, [1023, 300], 0, True, 0, None, None),       # Gemma's decode
    (3, 8, 2, 2, 333, 256, [5, 100, 331], 0, True, 0, "decode", 3),
    (1, 4, 4, 300, 300, 256, [0], 0, True, 0, "prefill", None),
    (1, 4, 2, 200, 333, 256, [133], 0, True, 0, None, None),               # prefill chunk
    (1, 2, 2, 130, 700, 256, [570], 0, True, 200, "prefill", None),        # window
    (2, 4, 2, 70, 190, 256, [120, 5], 64, True, 0, "prefill", None),       # kv_offset
    # heads of 80 (Zamba2's shared block): 128-column prefill tiles over an
    # 80-column tensor map, 10 columns a thread in the decode merge
    (2, 32, 32, 1, 1024, 80, [1023, 300], 0, True, 0, None, None),        # Zamba2's decode
    (3, 8, 2, 2, 333, 80, [5, 100, 331], 0, True, 0, "decode", 3),
    (2, 6, 1, 1, 777, 80, [900, 700], 120, True, 0, "decode", 64),         # kv_offset; empty splits
    (1, 4, 4, 300, 300, 80, [0], 0, True, 0, "prefill", None),
    (1, 32, 32, 512, 1024, 80, [512], 0, True, 0, None, None),             # prefill chunk
    (1, 2, 2, 130, 700, 80, [570], 0, True, 200, "prefill", None),         # window
    (2, 4, 2, 70, 190, 80, [120, 5], 64, True, 0, "prefill", None),        # kv_offset
    (1, 4, 2, 129, 255, 80, [0], 0, False, 0, "prefill", None),            # not causal
    (2, 4, 4, 1, 255, 80, [0, 0], 0, False, 0, "decode", 2),               # not causal, decode
    # Whisper: 1500 frames, no multiple of any key tile, not causal
    (1, 12, 12, 1500, 1500, 64, [0], 0, False, 0, None, None),             # the encoder
    (1, 12, 12, 300, 1500, 64, [0], 0, False, 0, "prefill", None),         # cross-attention
    (2, 12, 12, 1, 1500, 64, [0, 0], 0, False, 0, "decode", None),
    # the stream path: one row a KV head (and up to rows x hd = 512)
    (1, 12, 12, 1, 1500, 64, [0], 0, False, 0, None, None),               # Whisper's cross decode
    (4, 32, 32, 1, 1024, 128, [1023, 1000, 517, 64], 0, True, 0, None, None),  # CodeQwen1.5
    (2, 6, 6, 1, 777, 128, [900, 700], 120, True, 0, "stream", 13),       # kv_offset; empty splits
    (2, 32, 8, 1, 700, 64, [699, 10], 0, True, 256, None, None),           # 4 rows of 64, window
    (1, 8, 1, 1, 333, 64, [332], 0, True, 0, "stream", 2),                 # 8 rows of 64
    (2, 8, 4, 1, 333, 256, [332, 190], 0, True, 0, None, None),            # 2 rows of 256
    (3, 8, 8, 2, 130, 80, [128, 3, 60], 0, True, 0, "stream", None),       # 2 queries a head
]
PATH_IDS = ["-".join(str(x) for x in (c[10] or "auto", c[5], c[3], c[4], f"w{c[9]}", f"s{c[11]}"))
            for c in PATH_CASES]


@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,hd,offs,kv_off,causal,window,path,splits",
                         PATH_CASES, ids=PATH_IDS)
@pytest.mark.parametrize("partial", [False, True])
def test_flash_paths_match_plain(cuda, B, H, Hkv, Sq, Skv, hd, offs, kv_off, causal, window,
                                 path, splits, partial):
    rng = np.random.default_rng(6)
    q = _bf16(rng, (B, H, Sq, hd))
    k, v = (_bf16(rng, (B, Hkv, Skv, hd)) for _ in range(2))
    q_off = torch.tensor(offs, dtype=torch.int32, device=cuda)
    kw = dict(kv_offset=kv_off, causal=causal, window=window, return_partial=partial)
    n0 = flash_attention.launches
    for _ in range(2):                  # the split counters must be back at 0 for the 2nd call
        got = flash_attention(q, k, v, q_off, path=path, splits=splits, **kw)
    assert flash_attention.launches == n0 + 2
    ref = flash_ref(q, k, v, q_off, **kw)
    for a, b in (zip(got, ref) if partial else [(got, ref)]):
        assert _rel_err(a, b) <= REL_TOL


@pytest.mark.parametrize("hd", [64, 80, 128, 256])
@pytest.mark.parametrize("splits", [1, 2, 3, 4, 5, 6])
def test_flash_stream_every_split_count(cuda, hd, splits):
    """Multi-head decode (one row a KV head) on the stream path at every
    head size, from one split to one 64-key tile a split, over 333 keys
    (no multiple of the tile) with rows at their own positions; both
    output modes, each called twice (the split counters back at 0)."""
    rng = np.random.default_rng(12)
    q = _bf16(rng, (3, 4, 1, hd))
    k, v = (_bf16(rng, (3, 4, 333, hd)) for _ in range(2))
    q_off = torch.tensor([332, 200, 63], dtype=torch.int32, device=cuda)
    for partial in (False, True):
        n0 = flash_attention.launches
        for _ in range(2):
            got = flash_attention(q, k, v, q_off, path="stream", splits=splits,
                                  return_partial=partial)
        assert flash_attention.launches == n0 + 2
        ref = flash_ref(q, k, v, q_off, return_partial=partial)
        for a, b in (zip(got, ref) if partial else [(got, ref)]):
            assert _rel_err(a, b) <= REL_TOL


def test_flash_stream_blocks_fill_a_wave(cuda):
    """The stream blocks an SM holds, as the planner reads them from the
    kernel (the occupancy API): at least one at every head size, and on an
    H100 what its 228 KB of shared memory holds (test_torch_kernels.py's
    H100_STREAM_BLOCKS, which the CPU plan tests take)."""
    from repro_torch.kernels.flash.flash import HEAD_DIMS, _stream_blocks, device_plan
    got = {hd: _stream_blocks(cuda.index, hd) for hd in HEAD_DIMS}
    assert min(got.values()) >= 1, got
    if "H100" in torch.cuda.get_device_name(cuda):
        assert got == {64: 4, 80: 2, 128: 2, 256: 1}
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert device_plan(2, 16, 16, 1, 1024, 256, cuda) == \
        ("stream", min(16, got[256] * n_sms // 32))


# Ring caches, keys at given positions (kv_pos): (B, H, Hkv, Sq, L, hd,
# newest query position a row, window, path, splits). L slots hold the
# positions of a sliding-window ring (attention._cache_kv_positions): rows
# wrap at other slots, and a row whose ring is not full has unwritten slots.
RING_CASES = [
    (2, 32, 8, 1, 8192, 64, [12319, 1055], 8192, None, None),     # serving's ring decode
    (3, 12, 4, 2, 333, 128, [5, 400, 1000], 100, "decode", 3),     # unwritten slots; splits
    (1, 32, 8, 512, 8192, 64, [12287], 8192, None, None),          # a ring prefill chunk
    (2, 4, 2, 70, 190, 128, [60, 500], 64, "prefill", None),
    (2, 16, 16, 1, 1024, 256, [2000, 300], 1024, None, None),       # heads of 256
    (1, 4, 2, 130, 304, 256, [700], 256, "prefill", None),
    (2, 32, 32, 1, 1024, 80, [2000, 300], 1024, None, None),        # heads of 80
    (1, 4, 2, 130, 304, 80, [700], 256, "prefill", None),
    (3, 8, 8, 1, 333, 128, [5, 400, 1000], 100, "stream", 3),      # one row a KV head
    (2, 12, 12, 1, 700, 64, [699, 2000], 512, "stream", 11),       # one tile a split
]


@pytest.mark.parametrize("B,H,Hkv,Sq,L,hd,last,window,path,splits", RING_CASES)
@pytest.mark.parametrize("partial", [False, True])
def test_flash_key_positions_match_plain(cuda, B, H, Hkv, Sq, L, hd, last, window, path,
                                         splits, partial):
    """The whole ring, and its second half (a CP slice, cut by slot, that
    may straddle the wrap), against the plain version at the same key
    positions."""
    from repro_torch.models.attention import _cache_kv_positions
    rng = np.random.default_rng(8)
    q = _bf16(rng, (B, H, Sq, hd))
    k, v = (_bf16(rng, (B, Hkv, L, hd)) for _ in range(2))
    pos = torch.tensor(last, device=cuda)[:, None] - Sq + 1 + torch.arange(Sq, device=cuda)
    kv_pos = _cache_kv_positions(pos, L).to(torch.int32)
    q_off = pos[:, 0].to(torch.int32).contiguous()
    for s in (slice(0, L), slice(L // 2, L)):
        kk, vv, kp = k[:, :, s].contiguous(), v[:, :, s].contiguous(), kv_pos[:, s].contiguous()
        kw = dict(kv_pos=kp, window=window, return_partial=partial)
        n0 = flash_attention.launches
        got = flash_attention(q, kk, vv, q_off, path=path, splits=splits, **kw)
        assert flash_attention.launches == n0 + 1
        ref = flash_ref(q, kk, vv, q_off, **kw)
        for a, b in (zip(got, ref) if partial else [(got, ref)]):
            assert _rel_err(a, b) <= REL_TOL


@pytest.mark.parametrize("path", ["decode", "prefill", "stream"])
def test_flash_paths_rows_that_see_nothing(cuda, path):
    """Rows whose window hides every key, on each path: output 0,
    m = -1e30, l = 0; the other rows as the plain version. The stream path
    at one head a KV head (3 rows of 128)."""
    rng = np.random.default_rng(7)
    Hkv = 4 if path == "stream" else 2
    q, k = _bf16(rng, (2, 4, 3, 128)), _bf16(rng, (2, Hkv, 300, 128))
    offs = torch.tensor([1000, 150], dtype=torch.int32, device=cuda)
    kw = dict(window=40, path=path, splits=None if path == "prefill" else 4)
    out = flash_attention(q, k, k, offs, **kw)
    acc, m, l = flash_attention(q, k, k, offs, return_partial=True, **kw)
    torch.cuda.synchronize()
    assert out[0].abs().max().item() == 0.0 and acc[0].abs().max().item() == 0.0
    assert (m[0] == -1e30).all() and (l[0] == 0).all()
    assert _rel_err(out[1], flash_ref(q, k, k, offs, window=40)[1]) <= REL_TOL


def query_positions(kind: str, B: int, S: int, seed: int = 0) -> np.ndarray:
    """(B, S) int32 query positions that are no run: ``packed``, two
    sequences a row whose positions restart (the second at 0, the first at
    a row's own offset); ``shared``, an image's patches that share one
    temporal id (the first third of a row), then its text; ``offsets``, a
    run a row at the row's own offset."""
    rng = np.random.default_rng(seed)
    out = np.empty((B, S), np.int64)
    for b in range(B):
        off = int(rng.integers(0, 40))
        if kind == "packed":
            cut = int(rng.integers(1, S)) if S > 1 else 1
            out[b] = np.concatenate([off + np.arange(cut), np.arange(S - cut)])
        elif kind == "shared":
            n = max(S // 3, 1)
            out[b] = off + np.concatenate([np.zeros(n), 1 + np.arange(S - n)])
        else:
            out[b] = 37 * b + off + np.arange(S)
    return out.astype(np.int32)


# Query positions (q_pos): (B, H, Hkv, Sq, Skv, hd, kind of query_positions,
# keys: "self" (kv_pos = q_pos), "ring" (a sliding-window ring's slots past
# the row's newest query), "run" (kv_offset + j, no kv_pos), causal, window,
# path, splits). Every head size on both paths, causal, window and both.
QPOS_CASES = [
    (1, 4, 2, 300, 300, 64, "packed", "self", True, 0, "prefill", None),
    (1, 4, 2, 300, 300, 80, "shared", "self", True, 0, "prefill", None),
    (1, 4, 2, 300, 300, 128, "packed", "self", True, 64, "prefill", None),
    (1, 4, 4, 300, 300, 256, "shared", "self", True, 0, "prefill", None),
    (2, 4, 2, 200, 200, 128, "offsets", "self", False, 50, "prefill", None),
    (2, 8, 2, 130, 333, 64, "packed", "run", False, 0, "prefill", None),
    (2, 8, 2, 130, 333, 80, "shared", "run", True, 100, "prefill", None),
    (2, 8, 2, 130, 333, 128, "packed", "run", True, 0, "prefill", None),
    (2, 8, 2, 130, 333, 256, "offsets", "run", True, 0, "prefill", None),
    (1, 4, 2, 70, 190, 80, "packed", "ring", True, 64, "prefill", None),
    (2, 8, 2, 2, 333, 64, "packed", "run", True, 0, "decode", 3),
    (3, 8, 2, 2, 333, 80, "offsets", "run", True, 100, "decode", 3),
    (1, 4, 1, 40, 257, 128, "packed", "run", True, 0, "decode", 3),       # 10 row tiles
    (2, 12, 4, 3, 300, 128, "shared", "ring", True, 100, "decode", 2),
    (2, 16, 16, 1, 1024, 256, "offsets", "ring", True, 1024, None, None),
    (2, 4, 4, 16, 16, 64, "packed", "self", True, 0, "decode", None),
    (2, 4, 4, 12, 12, 256, "shared", "self", False, 6, "decode", 2),
    (2, 8, 8, 1, 333, 64, "offsets", "run", True, 100, "stream", 4),
    (3, 8, 8, 1, 333, 80, "offsets", "ring", True, 200, "stream", 6),
    (2, 8, 8, 2, 200, 128, "packed", "run", True, 0, "stream", 2),
    (2, 16, 16, 1, 700, 256, "offsets", "run", False, 0, "stream", None),
]
QPOS_IDS = ["-".join(str(x) for x in (c[10] or "auto", c[5], c[6], c[7], c[8], f"w{c[9]}"))
            for c in QPOS_CASES]


def _qpos_inputs(cuda, B, H, Hkv, Sq, Skv, hd, kind, keys, seed=9):
    """q, k, v, q_pos and the key side's keyword (kv_pos or kv_offset)."""
    from repro_torch.models.attention import _cache_kv_positions
    rng = np.random.default_rng(seed)
    q = _bf16(rng, (B, H, Sq, hd))
    k, v = (_bf16(rng, (B, Hkv, Skv, hd)) for _ in range(2))
    q_pos = torch.from_numpy(query_positions(kind, B, Sq, seed)).to(cuda)
    if keys == "self":
        kv = dict(kv_pos=q_pos)
    elif keys == "ring":
        newest = q_pos.long().max(dim=1, keepdim=True).values
        kv = dict(kv_pos=_cache_kv_positions(newest, Skv).to(torch.int32).contiguous())
    else:
        kv = dict(kv_offset=0)
    return q, k, v, q_pos, kv


@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,hd,kind,keys,causal,window,path,splits", QPOS_CASES,
                         ids=QPOS_IDS)
@pytest.mark.parametrize("partial", [False, True])
def test_flash_query_positions_match_plain(cuda, B, H, Hkv, Sq, Skv, hd, kind, keys, causal,
                                           window, path, splits, partial):
    q, k, v, q_pos, kv = _qpos_inputs(cuda, B, H, Hkv, Sq, Skv, hd, kind, keys)
    kw = dict(q_pos=q_pos, causal=causal, window=window, return_partial=partial, **kv)
    n0 = flash_attention.launches
    for _ in range(2):                  # the split counters must be back at 0 for the 2nd call
        got = flash_attention(q, k, v, None, path=path, splits=splits, **kw)
    assert flash_attention.launches == n0 + 2
    ref = flash_ref(q, k, v, None, **kw)
    for a, b in (zip(got, ref) if partial else [(got, ref)]):
        assert _rel_err(a, b) <= REL_TOL


@pytest.mark.parametrize("path", ["decode", "prefill", "stream"])
@pytest.mark.parametrize("hd", [64, 80, 128, 256])
def test_flash_query_positions_rows_that_see_nothing(cuda, path, hd):
    """Query rows placed before every key (keys from kv_offset 100): output
    0, m = -1e30, l = 0 on each path, at every head size; the other rows as
    the plain version. The stream path at one head a KV head (2 rows)."""
    rng = np.random.default_rng(11)
    Sq = {"decode": 6, "prefill": 150, "stream": 2}[path]
    Hkv = 4 if path == "stream" else 2
    q, k = _bf16(rng, (2, 4, Sq, hd)), _bf16(rng, (2, Hkv, 300, hd))
    pos = np.tile(np.arange(Sq, dtype=np.int32) * 3 + 120, (2, 1))
    pos[0, ::2] = np.arange(0, Sq, 2) % 100            # row 0's even queries see no key
    q_pos = torch.from_numpy(pos).to(cuda)
    kw = dict(q_pos=q_pos, kv_offset=100, path=path, splits=None if path == "prefill" else 3)
    out = flash_attention(q, k, k, None, **kw)
    acc, m, l = flash_attention(q, k, k, None, return_partial=True, **kw)
    torch.cuda.synchronize()
    hidden = torch.zeros((2, Sq), dtype=torch.bool, device=cuda)
    hidden[0, ::2] = True
    assert out[:, :, :][hidden[:, None].expand(-1, 4, -1)].abs().max().item() == 0.0
    assert acc[hidden[:, None].expand(-1, 4, -1)].abs().max().item() == 0.0
    assert (m[hidden[:, None].expand(-1, 4, -1)] == -1e30).all()
    assert (l[hidden[:, None].expand(-1, 4, -1)] == 0).all()
    ref = flash_ref(q, k, k, None, q_pos=q_pos, kv_offset=100)
    assert _rel_err(out[1], ref[1]) <= REL_TOL
    assert _rel_err(out[0, :, 1::2], ref[0, :, 1::2]) <= REL_TOL


# Launches without q_pos on both paths at every head size, with and without
# kv_pos, in both modes: (B, H, Hkv, Sq, Skv, hd, q_offset per row, keys
# "run" or "ring", window, path, splits). FLAG_OFF_DIGESTS holds the sha256
# of each one's output bytes as the kernel gave them before q_pos was added
# (that build, on an H100 80GB HBM3): the flag-off instantiations must stay
# what they were, bit for bit. The inputs come from numpy. The rows of one
# or four heads a KV head (2, 3, 9), which the plan now sends to the stream
# path, force the decode path at the split counts it planned for them then.
FLAG_OFF = [
    (4, 48, 8, 1, 512, 128, [0, 37, 300, 511], "run", 0, None, None),
    (2, 32, 2, 3, 1000, 128, [997, 400], "run", 100, "decode", 7),
    (2, 16, 16, 1, 1024, 256, [1023, 300], "run", 0, "decode", 8),
    (2, 32, 32, 1, 1024, 80, [1023, 300], "run", 0, "decode", 8),
    (3, 12, 4, 2, 333, 64, [5, 100, 331], "run", 0, "decode", None),
    (1, 4, 2, 200, 333, 128, [133], "run", 0, None, None),
    (1, 4, 4, 300, 300, 256, [0], "run", 0, "prefill", None),
    (1, 32, 32, 512, 1024, 80, [512], "run", 0, None, None),
    (2, 8, 2, 300, 300, 64, [0, 0], "run", 0, "prefill", None),
    (2, 32, 8, 1, 8192, 64, [12319, 1055], "ring", 8192, "decode", 33),
    (1, 32, 8, 512, 8192, 64, [12287], "ring", 8192, None, None),
    (1, 4, 2, 130, 304, 256, [700], "ring", 256, "prefill", None),
    (3, 12, 4, 2, 333, 128, [5, 400, 1000], "ring", 100, "decode", 3),
]
FLAG_OFF_DIGESTS = {
    0: "395955df2548aea87a94eba245d2bdf71bece29e4461d3e073aa786f99da339b",
    1: "de246b47d3262d4d269176b6375bea63476c27926105eb99af7e16be31f43014",
    2: "db4eb7c45bb455f4fa253544aaed54c6c54a430983ba28835b69d3c54a3ec73d",
    3: "607689d20b7103f8b9dbd555d767523d2b3a5929ec3e7e3c4055298d1945d60e",
    4: "fb16c7dfd3cc8aa1599abf2585d691ef5e1adc52d91e90aa75904fb004345737",
    5: "475d2b40e62071e83be17df0fb11f0dfa5847b30e06c42f2087094755fc00e6c",
    6: "a600f14dc0f3df6fc8dfd161afc34048e122ad105b512c1d429ecbb5e1509c8e",
    7: "856f16691c8441851450e75cef88bdf8586614ae3e4cccca11f54e88ab8a2114",
    8: "5ac5fe815abfc6963f901be1efe9027250d2def6d7b2d5761b2336225903c36a",
    9: "29ba25a28448b9339fae3b54302f6dce0c99c813e31b76d2751e1a0e5b9e3d87",
    10: "422b225e7825d2b84e7230e9333da11b216dd34b37759ff5eb4172be1ab98ad7",
    11: "96402da2b21216e85d6b682c2d8abf28e4f2279b4c062990d566fd51776a9cdc",
    12: "e0581eba677b76fdb80b8441bdbed41fda6143a814ab0d834736084b0796b4b9",
}


def flag_off_digests() -> dict:
    """sha256 of every FLAG_OFF launch's output bytes (normalized, then the
    partial triple), by case index."""
    import hashlib
    from repro_torch.models.attention import _cache_kv_positions
    out = {}
    for i, (B, H, Hkv, Sq, Skv, hd, offs, keys, window, path, splits) in enumerate(FLAG_OFF):
        rng = np.random.default_rng(100 + i)
        q = _bf16(rng, (B, H, Sq, hd))
        k, v = (_bf16(rng, (B, Hkv, Skv, hd)) for _ in range(2))
        q_off = torch.tensor(offs, dtype=torch.int32, device="cuda")
        kw = dict(window=window, path=path, splits=splits)
        if keys == "ring":
            pos = q_off[:, None].long() + torch.arange(Sq, device="cuda")
            kw["kv_pos"] = _cache_kv_positions(pos, Skv).to(torch.int32).contiguous()
        h = hashlib.sha256()
        for t in (flash_attention(q, k, v, q_off, **kw),
                  *flash_attention(q, k, v, q_off, return_partial=True, **kw)):
            t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
            h.update(t.cpu().numpy().tobytes())
        out[i] = h.hexdigest()
    return out


def test_flash_without_query_positions_is_bitwise_unchanged(cuda):
    assert flag_off_digests() == FLAG_OFF_DIGESTS


def test_kernels_reject_shapes_they_do_not_take(cuda):
    x = torch.zeros((200, 128), dtype=torch.bfloat16, device=cuda)
    w = torch.zeros((2, 128, 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="bm"):
        gmm(x, w, torch.zeros(2, dtype=torch.int32, device=cuda), bm=100)
    with pytest.raises(ValueError, match="bm"):
        gmm(x[:128], w, torch.zeros(32, dtype=torch.int32, device=cuda), bm=4)
    with pytest.raises(ValueError, match="tile"):      # the TMA kernel: a tile that bm cuts
        gmm(x[:128], w, torch.zeros(2, dtype=torch.int32, device=cuda), bm=64, block_m=128)
    with pytest.raises(ValueError, match="tile"):      # the swap-AB kernel: 128 columns only
        gmm(x[:128], w, torch.zeros(4, dtype=torch.int32, device=cuda), bm=32, block_n=256)
    with pytest.raises(ValueError, match="K % 64"):
        gmm(x[:128, :96].contiguous(), w[:, :96].contiguous(),
            torch.zeros(1, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="tile"):
        gmm(x[:128], w, torch.zeros(1, dtype=torch.int32, device=cuda), block_n=256)
    with pytest.raises(TypeError, match="bf16"):
        gmm(x[:128].float(), w, torch.zeros(1, dtype=torch.int32, device=cuda))
    q = torch.zeros((1, 2, 4, 96), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash(q, q, q)
    q = torch.zeros((1, 2, 4, 64), dtype=torch.bfloat16, device=cuda)
    offs = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="does not split"):
        flash_attention(q, q, q, offs, path="prefill", splits=2)
    with pytest.raises(ValueError, match="path"):
        flash_attention(q, q, q, offs, path="ring")
    q9 = torch.zeros((1, 2, 9, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="rows x hd"):
        flash_attention(q9, q9, q9, offs, path="stream")
    q8 = torch.zeros((1, 8, 1, 64), dtype=torch.bfloat16, device=cuda)
    k1 = torch.zeros((1, 1, 65536, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="refused"):      # the merge's splits do not fit
        flash_attention(q8, k1, k1, offs, path="stream", splits=1024)
    with pytest.raises(ValueError, match="kv_pos must be"):
        flash_attention(q, q, q, offs, kv_pos=torch.zeros((1, 3), dtype=torch.int32,
                                                          device=cuda))


# The dgrad mode at the training slice's widths: w (E, 6144, 16384) or
# (E, 16384, 6144) read transposed, every forced tile, unsorted block_expert;
# and the swap-AB kernel's row blocks (tile None: the wrapper's pass), also at
# w (E, 384, 448): 7 K steps, 3 column strips.
TRANS_CASES = [(kw, nw, bm, tile)
               for kw, nw in ((6144, 16384), (16384, 6144))
               for bm, tiles in ((128, ((128, 256), (128, 128), (64, 256), (64, 128))),
                                 (64, ((64, 256), (64, 128))),
                                 (32, ((16, 128), None)), (8, ((8, 128), None)),
                                 (16, (None,)), (24, (None,)), (40, (None,)), (96, (None,)),
                                 (160, (None,)))
               for tile in tiles] + [(384, 448, bm, None) for bm in (8, 24, 96)]


@pytest.mark.parametrize("K_w,N_w,bm,tile", TRANS_CASES)
def test_gmm_trans_w_matches_plain(cuda, K_w, N_w, bm, tile):
    """y = x @ w[e]^T: x (M, N_w), w (E, K_w, N_w) → (M, K_w)."""
    rng = np.random.default_rng(8)
    E, M = 3, 512 // bm * bm
    x, w = _bf16(rng, (M, N_w)), _bf16(rng, (E, K_w, N_w), N_w ** -0.5)
    be = torch.from_numpy(np.resize(np.array([2, 0, 2, 1, 0, 0, 1, 2], np.int32), M // bm)).to(cuda)
    block_m, block_n = tile or (None, None)
    n0, t0 = gmm.launches, gmm.trans_w_launches
    y = gmm(x, w, be, bm=bm, trans_w=True, block_m=block_m, block_n=block_n)
    assert (gmm.launches, gmm.trans_w_launches) == (n0 + 1, t0 + 1) and y.shape == (M, K_w)
    assert _rel_err(y, gmm_ref(x, w, be, bm=bm, trans_w=True)) <= REL_TOL


def test_grouped_matmul_grads_match_plain_on_card(cuda):
    """The GMM Function's dgrad (kernel, ``trans_w``) and wgrad (bmm) against
    autograd of the plain version, bf16."""
    from repro_torch.kernels.gmm.ops import GroupedMatmul, uniform_block_expert
    rng = np.random.default_rng(9)
    E, span, K, N, bm = 4, 256, 512, 768, 128
    x = _bf16(rng, (E * span, K)).requires_grad_()
    w = _bf16(rng, (E, K, N), K ** -0.5).requires_grad_()
    dy = _bf16(rng, (E * span, N))
    be = uniform_block_expert(E, span, bm, device=cuda)
    n0, t0 = gmm.launches, gmm.trans_w_launches
    y = GroupedMatmul.apply(x, w, be, bm)
    dx, dw = torch.autograd.grad(y, (x, w), dy)
    assert (gmm.launches, gmm.trans_w_launches) == (n0 + 2, t0 + 1)   # forward + dgrad
    y_ref = gmm_ref(x, w, be, bm=bm)
    dx_ref, dw_ref = torch.autograd.grad(y_ref, (x, w), dy)
    for a, b in ((y, y_ref), (dx, dx_ref), (dw, dw_ref)):
        assert _rel_err(a, b) <= REL_TOL


@pytest.mark.parametrize("S,window", [(1024, 0), (700, 0), (512, 100)])
def test_flash_function_grads_match_plain_on_card(cuda, S, window):
    """``blockwise_attention`` (flash kernel forward, ``_bwd_scan`` backward)
    against autograd of ``flash_ref``, bf16, 48/8 heads of 128."""
    from repro_torch.models.attn_core import blockwise_attention
    rng = np.random.default_rng(10)
    B, H, Hkv, hd = 1, 48, 8, 128
    q = _bf16(rng, (B, H, S, hd)).requires_grad_()
    k, v = (_bf16(rng, (B, Hkv, S, hd)).requires_grad_() for _ in range(2))
    dout = _bf16(rng, (B, H, S, hd))
    n0 = flash_attention.launches
    out = blockwise_attention(q, k, v, window=window, block_kv=256)
    got = torch.autograd.grad(out, (q, k, v), dout)
    assert flash_attention.launches == n0 + 1
    ref = flash_ref(q, k, v, torch.zeros(B, dtype=torch.int32, device=cuda), window=window)
    want = torch.autograd.grad(ref, (q, k, v), dout)
    assert _rel_err(out, ref) <= REL_TOL
    for a, b in zip(got, want):
        assert _rel_err(a, b) <= REL_TOL


def test_kernels_launch_from_a_fresh_thread(cuda):
    """The autograd engine runs backward passes on threads of its own: each
    kernel launches from a thread that has made no CUDA call yet, after its
    tile was set up on the main thread."""
    import threading
    rng = np.random.default_rng(11)
    x, w = _bf16(rng, (256, 128)), _bf16(rng, (2, 128, 256), 128 ** -0.5)
    be = torch.tensor([1, 0], dtype=torch.int32, device=cuda)
    q, k = _bf16(rng, (1, 4, 200, 64)), _bf16(rng, (1, 2, 200, 64))
    offs = torch.zeros(1, dtype=torch.int32, device=cuda)
    calls = {"gmm": lambda: gmm(x, w, be), "gmm_trans_w": lambda: gmm(x, w.transpose(1, 2)
                                                                      .contiguous(), be,
                                                                      trans_w=True),
             "flash": lambda: flash_attention(q, k, k, offs)}
    want = {name: fn() for name, fn in calls.items()}        # main thread first
    got, errors = {}, []

    def worker():
        try:
            got.update({name: fn() for name, fn in calls.items()})
        except RuntimeError as e:
            errors.append(e)

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and not errors, errors
    torch.cuda.synchronize()
    for name in calls:
        assert torch.equal(got[name], want[name]), name


# Qwen2-57B-A14B's four GMM launches (64 experts, D 3584, F 2560): the
# serving decode step (4 tokens, dropless: 128 rows per expert) and the
# training step (CF 1.0, 4096 tokens, top-8: 512 rows per expert), gate/up
# and down, each in the forward and the trans_w (dgrad) mode.
QWEN2_GMM = [(rows, K, N) for rows in (128, 512) for K, N in ((3584, 2560), (2560, 3584))]


@pytest.mark.parametrize("rows,K,N", QWEN2_GMM)
@pytest.mark.parametrize("trans", [False, True])
def test_gmm_at_qwen2_shapes(cuda, rows, K, N, trans):
    """Forward: x (64 * rows, K) @ w (64, K, N). trans_w: x (64 * rows, N)
    @ w[e]^T for the same w, the data gradient of that product."""
    rng = np.random.default_rng(12)
    E, bm = 64, 128
    M = E * rows
    w = _bf16(rng, (E, K, N), K ** -0.5)
    x = _bf16(rng, (M, N if trans else K))
    be = torch.arange(E, dtype=torch.int32, device=cuda).repeat_interleave(rows // bm)
    n0, t0 = gmm.launches, gmm.trans_w_launches
    y = gmm(x, w, be, bm=bm, trans_w=trans)
    assert (gmm.launches, gmm.trans_w_launches) == (n0 + 1, t0 + int(trans))
    assert y.shape == (M, K if trans else N)
    assert _rel_err(y, gmm_ref(x, w, be, bm=bm, trans_w=trans)) <= REL_TOL


# Qwen2's 28 query heads over 4 KV heads (a GQA group of 7) at head size
# 128: decode-path rows (7 * Sq) that end inside a 16-row tile (Sq 1, 2),
# split a group across two tiles (Sq 3) or fill four (Sq 9), the prefill
# path on a prefill chunk (Sq 128) and forced on Sq 3, over a paged length
# of 512 keys with per-row offsets; then causal self-attention at 4096.
QWEN2_FLASH = [(4, 1, 512, [0, 37, 300, 511], None), (4, 2, 512, [7, 200, 401, 510], None),
               (4, 3, 512, [0, 61, 250, 509], None), (2, 9, 512, [100, 503], None),
               (2, 3, 512, [100, 509], "prefill"), (1, 128, 512, [384], None),
               (1, 4096, 4096, [0], None)]


@pytest.mark.parametrize("B,Sq,Skv,offs,path", QWEN2_FLASH,
                         ids=[f"Sq{c[1]}-{c[4] or 'auto'}" for c in QWEN2_FLASH])
@pytest.mark.parametrize("partial", [False, True])
def test_flash_at_qwen2_heads(cuda, B, Sq, Skv, offs, path, partial):
    rng = np.random.default_rng(13)
    H, Hkv, hd = 28, 4, 128
    q = _bf16(rng, (B, H, Sq, hd))
    k, v = (_bf16(rng, (B, Hkv, Skv, hd)) for _ in range(2))
    q_off = torch.tensor(offs, dtype=torch.int32, device=cuda)
    n0 = flash_attention.launches
    got = flash_attention(q, k, v, q_off, return_partial=partial, path=path)
    assert flash_attention.launches == n0 + 1
    ref = flash_ref(q, k, v, q_off, return_partial=partial)
    for a, b in (zip(got, ref) if partial else [(got, ref)]):
        assert _rel_err(a, b) <= REL_TOL


def test_shared_expert_moe_block_matches_reference_on_card(cuda):
    """The MoE block with a sigmoid-gated shared expert, bf16, sort layout
    (three GMM launches), against ``moe_ffn_reference`` plus the dense
    shared expert, both in fp32 on the same bf16 values."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import MoEConfig
    from repro_torch.core.dispatcher import _shared_expert_ffn, moe_ffn_reference
    from repro_torch.core.moe_layer import MoEParams, moe_block
    rng = np.random.default_rng(14)
    E, D, F, Fs, T = 8, 512, 256, 512, 256
    mcfg = MoEConfig(n_experts=E, top_k=2, d_expert=F, dropless=True, permute_mode="sort",
                     n_shared_experts=1, d_shared_expert=Fs, shared_expert_gate=True)
    cfg = dataclasses.replace(reduced(get_config("qwen2-57b-a14b")), d_model=D, moe=mcfg)
    x = _bf16(rng, (1, T, D))
    wg = _bf16(rng, (D, E), 0.1).float()
    w1, w3 = (_bf16(rng, (E, D, F), D ** -0.5) for _ in range(2))
    w2 = _bf16(rng, (E, F, D), F ** -0.5)
    ws1, ws3 = (_bf16(rng, (D, Fs), D ** -0.5) for _ in range(2))
    ws2 = _bf16(rng, (Fs, D), Fs ** -0.5)
    gate = _bf16(rng, (D, 1), 0.1)
    p = MoEParams(wg, w1, w2, w3, ws1=ws1, ws2=ws2, ws3=ws3, gate=gate)
    n0 = gmm.launches
    with torch.no_grad():
        y, aux = moe_block(p, x, cfg)
    assert gmm.launches == n0 + 3 and y.dtype == torch.bfloat16
    assert float(aux["moe_drop_fraction"]) == 0.0
    f = [t.float() for t in (x[0], wg, w1, w2, w3)]
    want, _ = moe_ffn_reference(f[0][None], *f[1:], mcfg)
    want = want[0] + _shared_expert_ffn(f[0], [t.float() for t in (ws1, ws2, ws3, gate)],
                                        "swiglu")
    assert _rel_err(y[0], want) <= REL_TOL
