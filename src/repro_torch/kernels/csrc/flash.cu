// Blockwise (flash) attention forward, bf16 in, fp32 online softmax, for
// sm_90a (Hopper: mma.sync + cp.async on the decode path, mma.sync + TMA +
// mbarrier on the stream path, TMA + mbarrier + wgmma on the prefill path).
//
// Replaces the Pallas TPU kernel `flash_attention` / `_flash_kernel` in
// src/repro/kernels/flash/flash.py, and with it the jnp scan `_fwd_scan`
// (src/repro/models/attn_core.py) that the JAX serving path runs for its
// cache attention. Same contract:
//   q (B, H, Sq, hd), k/v (B, Hkv, Skv, hd), hd in {64, 80, 128, 256}; GQA head h
//   reads KV head h / (H / Hkv); query row i of batch row b sits at
//   position q_offset[b] + i, key j at kv_offset + j, or at kv_pos[b, j]
//   when the caller gives key positions (the reference's blockwise_attention
//   contract, src/repro/models/attn_core.py: a sliding-window ring cache's
//   slots hold positions that wrap inside the view); causal and
//   sliding-window masks as flash.py:48-57 (NEG_INF = -1e30, p zeroed where
//   not visible); p is rounded to bf16 before the PV product (flash.py:67).
// Outputs: normalized o = acc / max(l, 1e-30) in bf16, or the fp32 partial
// triple (acc, m, l) over the whole KV. q_offset is one int32 per batch
// row, so the batched decode step, whose rows sit at different positions,
// uses the same kernel.
//
// One C entry point, one kernel launch per call, three device paths chosen
// on the host from the shapes (kernels/flash/flash.py::plan):
//
// 1. Decode / short query (`flash_fwd_kernel_split`): (H/Hkv) x Sq <= 64
//    rows per KV head, as in the serving decode step (6 rows: one query of
//    each of the 6 heads that share a KV head). Bound by memory: ~1 flop
//    per KV byte, and at the serving step's 512 keys by launch latency.
//    - The rows of the whole GQA group are packed as the rows of one
//      16-row mma.sync m16n8k16 tile, so each KV byte is read once per
//      group, not once per query head.
//    - One block of 4 warps works on one (row tile, KV head, batch row,
//      KV split); the KV range that the tile's rows can see is cut into
//      `splits` runs of 64-key tiles so that the blocks fill the SMs. A
//      split wholly outside the visible range exits at once.
//    - K/V tiles stream through a 2-stage cp.async ring; each warp takes
//      16 keys of every 64-key tile with its own online softmax and its
//      accumulator in registers; the 4 warps merge through shared memory.
//    - The splits merge inside the same launch: each writes its fp32
//      partial (m, l, acc) to a workspace and counts itself in on a
//      per-group counter; the last to arrive merges them (the math of
//      attn_core._merge_partials, exact for rows that see no key in a split:
//      m = -1e30, l = 0) and sets the counter back to 0. The counters are
//      allocated and zeroed once per device by the wrapper; one launch at a
//      time may use them (one stream).
// 1b. Few rows a KV head (`flash_fwd_kernel_split` with STREAM, path 2):
//    (H/Hkv) x Sq x hd <= 512, as multi-head attention's decode (one row a
//    KV head: Gemma, Whisper, CodeQwen1.5, Qwen1.5, Zamba2) and Llama's 4
//    rows of 64. One row fills 1/16 of the m16 tile, but decode is bound by
//    bytes, so the packing and the per-warp arithmetic stay as in 1.; what
//    bound the decode design there (launch/bench_flash.py, PERF.md) was a
//    split's tiles loaded one after another (the 2-stage ring issues the
//    next tile only after the wait on the current one), one block an SM at
//    heads of 256 (143 KB), and a planner aiming at 4 blocks an SM (Gemma's
//    step ran in 2 waves, 8 splits of 2 tiles). The stream design:
//    - K/V tiles by TMA from 3-D tensor maps (64-key boxes of 64 columns,
//      128 B swizzle; fragments read at the swizzled addresses; the TMA
//      zero-fills rows past Skv) onto one mbarrier a stage of a 3-stage
//      ring; thread 0 issues the first 3 tiles before the first wait and
//      each next one as soon as the block leaves the stage it reuses.
//    - The planner asks the kernel how many blocks an SM holds
//      (repro_flash_stream_blocks: the occupancy API on this shared memory;
//      4 at heads of 64, 2 at 80 and 128, 1 at 256 on an H100) and gives
//      the (batch row, KV head) groups as many splits as fill them in one
//      wave, one 64-key tile each at least.
//    - Only the valid rows' partials go to the workspace, and the last split
//      merges them in one round trip: each thread owns a float4 of the
//      group's rows and loads its splits' acc while the m and l of every
//      (row, split) go to shared memory; a warp a row makes the weights.
//    - Without a causal or window mask the loads do not wait for q_offset.
//    Tried and dropped: TMA bulk copies of one key row a thread into padded
//    rows (each copy issued at ~28 cycles: 2x slower than cp.async at heads
//    of 64); the splits of a group as one thread block cluster merging
//    through distributed shared memory, with no workspace, counter or fence
//    (3% faster for Whisper, but clusters of 4 blocks of 206 KB do not all
//    fit the GPCs at once: Gemma's one wave became two, 1.7x slower);
//    prefetching the tensor maps (no change); this TMA ring on the decode
//    path too, at 2 stages with its plan unchanged, so that both paths
//    load alike: the GQA rows got 1-9% slower in a paired run (parent,
//    change, change, parent; launch/bench_flash.py, H100 80GB HBM3 at
//    700 W): the serving decode 0.0098 -> 0.0104 ms, the long decode
//    0.1346 -> 0.1407, Qwen2-VL's 0.0102 -> 0.0111, Qwen2's 0.0093 ->
//    0.0095. So the decode path keeps its cp.async ring and the two rings
//    stay, chosen by rows x hd in the planner. Not built: 32-key tiles at
//    heads of 256 for two blocks an SM. One block with its 3 stages keeps
//    192 KB of K/V in flight an SM, ~25 MB over the card, far above what
//    HBM's rate times its latency asks (~3.4 MB at ~1 us), and Gemma's
//    step is 128 blocks, under one wave; a 32-key tile would also leave
//    two of the block's four 16-key warps without keys. What Gemma's row
//    still loses to its byte bound is the chain a split ends with (the
//    counter's fence and atomic, the last split's merge loads).
// 2. Prefill / long query (`flash_fwd_kernel_wgmma`): bound by the tensor
//    cores at training lengths (4096 causal: ~206 GFLOP for ~60 MB).
//    - One block per (128 query rows, head, batch row), heads not packed;
//      every head's last query tile is issued first, so the long causal
//      rows start first.
//    - Two producer threads issue TMA loads (128 B swizzle): one the Q tile
//      and the 128-key K tiles (64 at hd 256), the other the V tiles, into a
//      3-stage ring (4 at hd 64, 2 at hd 256) with separate full/empty
//      mbarriers for K and V, from 3-D tensor maps over (hd, S, B x heads),
//      so the zero fill stops at a head's ragged edge.
//    - Two consumer warpgroups of 64 rows each run wgmma: S = Q K^T (both
//      K-major), the online softmax on S in registers, then O += P V with P
//      converted in registers as the A operand and V as MN-major B (the
//      transpose bit; LBO = the stride between 64-column swizzle atoms, SBO
//      = 8 rows, as gmm.cu's weights). O stays in registers.
//    - Each warpgroup issues S(t) together with P(t-1) V(t-1) and runs the
//      softmax of tile t while P V runs; the two warpgroups take turns to
//      issue (named barriers), so one's softmax overlaps the other's
//      products.
//    - KV tiles the causal or window mask hides from every row of the block
//      are skipped (exact no-ops of the online softmax); the mask is
//      evaluated only on tiles that cross a mask edge or Skv.
//    - The epilogue goes through per-warp strips in the warpgroup's own Q
//      rows and writes 16 bytes per lane.
//
// Measured on an H100 80GB HBM3 at 700 W (launch/bench_flash.py, PERF.md):
// the serving decode launch 0.0098 ms (SDPA 0.0140; one tiny kernel 0.0014),
// the long decode at 79% of its byte bound (SDPA 58%), the 4096 causal case
// at ~51% of its operation bound (SDPA ~58%). In that order the pipelining
// of each warpgroup took the causal case from 0.58 to 0.48 ms, the
// ping-pong to 0.44, the second producer with the epilogue in Q's rows to
// 0.43 and the longest-first issue order to 0.41. Measured and dropped: a
// 3-stage decode ring (2 stages leave room for 3 blocks per SM: 6% faster),
// 8 one-tile splits at the serving step (4 of 2 tiles are 8% faster), two
// accumulation chains for S on the decode path (no change), a 2-stage
// prefill ring (within noise) and a persistent prefill grid (4-5% slower).
// With key positions (chip_smoke.py phase 14, head size 64): the ring
// decode against 8192 slots 0.021 ms (SDPA 0.018), a 512-query ring prefill
// chunk 0.118 ms (SDPA 0.147). The prefill path stages a tile's positions
// in shared memory: read per mask test they took 0.528 ms, and held in
// registers (32 a thread) they spilled (0.201 ms). The stream path against
// the decode path's plan before it, same call: Gemma's decode (2 rows, 16
// heads of 256, 1024 keys) 0.0391 -> 0.0164 ms (SDPA 0.0176), Whisper's
// cross-attention decode (12 heads of 64, 1500 frames) 0.0089 -> 0.0081
// (SDPA 0.0070: a 1-tile split's launch, load, fence, counter and merge
// round trips), CodeQwen1.5's (4 rows, 32 heads of 128) 0.0383 -> 0.0311
// (SDPA 0.0263), Zamba2's 0.0151 -> 0.0131, the ring decode 0.0198 ->
// 0.0189 (SDPA 0.0176); the GQA rows on the decode path within 2%.
//
// Heads of 256 (Gemma): the prefill path takes 64-key tiles (WgCfg::BN; a
// 128-key K or V tile is 64 KB, so only one stage would fit beside the
// 64 KB Q tile), its S product one m64n64k16 wgmma a k-step and its P V two
// N = 128 wgmma on the two halves of O and of V's swizzle atoms; the
// decode path reads Q's fragments from the staged Q tile at each k-step
// instead of holding all 64 registers of them beside the accumulator's 128.
//
// Heads of 80 (Zamba2's shared block): the decode path runs 5 k-steps and
// 10 n-tiles of mma.sync (row pitch 88: 176 B, 16-byte aligned, no
// ldmatrix conflicts) and merges 10 columns a thread with 4- and 8-byte
// stores. The prefill path keeps its 64-column swizzle atoms: its tiles are
// 128 columns wide (WgCfg::TD), the tensor maps' inner extent stays 80 (a
// row pitch of 160 B), so the TMA fills columns 80..127 with zeros; S = Q K^T
// takes 5 k-steps (the zero columns add nothing), P V runs at N = 128 (1.6x
// the products an exact 80 needs) and the epilogue stores only 80 columns.
//
// Key positions (kv_pos) keep both paths as they are and change only the
// mask, in their own instantiations (template flag POS), so a launch
// without them runs the code it ran before: with them the keys are not a
// contiguous run, so every key is in the visible range (no split or tile is
// skipped by position), each masked tile reads its keys' positions (int32,
// L1-cached) and the prefill path evaluates the mask on every tile.
//
// Query positions (q_pos, the reference's (B, Sq) q_pos array: packed rows
// whose positions restart, per-row offsets, an image's patches that share
// one temporal id) do the same in a template flag of their own (QPOS), so
// a launch without them, with or without kv_pos, runs the code it ran
// before: each thread reads its rows' positions once (the decode path's
// two packed rows, the prefill path's two rows), q_offset is not read,
// every key is in the visible range (no split, and no prefill tile, is
// skipped by position: the per-tile causal skip is off under the flag)
// and every tile is masked element by element. A row that sees no key
// keeps m = -1e30, l = 0, acc = 0 and writes 0, as the reference's scan.
// Their instantiations compile in flash_qpos.cu, beside this file's (the
// build's nvcc for flash.cu took ~50 s with all 32 kernels in one unit).
//
// Requires 16-byte aligned, contiguous tensors; the wrapper checks them and
// this entry point again.
#include <cstdint>
#include <type_traits>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float fast_exp2(float x) {   // 2^x; 0 for x far below 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Absolute positions of one batch row's keys: with POS the caller's
// kv_pos[j] (pos: the row's (Skv,) run), else offset + j.
template <bool POS>
struct KeyPos {
  const int* pos;
  int offset;
  __device__ __forceinline__ int operator()(int kidx) const {
    if constexpr (POS) return __ldg(pos + kidx);
    else return offset + kidx;
  }
};

// Visibility of key index kidx (0-based in k) to a query at absolute
// position q_pos: in range, causal, window (flash.py:48-57).
template <bool POS>
__device__ __forceinline__ bool visible(int q_pos, int kidx, int Skv, const KeyPos<POS>& kp,
                                        int causal, int window) {
  if constexpr (POS) {
    if (kidx >= Skv) return false;           // no position to read past the keys
  }
  const int d = q_pos - kp(kidx);
  return kidx < Skv && (!causal || d >= 0) && (!window || d < window);
}

// Keys [lo, hi) that some query at positions [q_first, q_last] can see;
// hi <= lo when none. With key or query positions (QPOS: the caller's
// q_pos, no run either) every key may be seen.
template <bool POS, bool QPOS>
__device__ __forceinline__ void visible_range(int q_first, int q_last, int Skv,
                                              const KeyPos<POS>& kp, int causal, int window,
                                              int& lo, int& hi) {
  if constexpr (POS || QPOS) {
    lo = 0;
    hi = Skv;
  } else {
    lo = window ? max(0, q_first - window + 1 - kp.offset) : 0;
    hi = causal ? min(Skv, q_last - kp.offset + 1) : Skv;
  }
}

// ===================================================== decode path (split)

constexpr int S_ROWS = 16;                   // packed rows per tile: one m16 tile
constexpr int S_BKV = 64;                    // keys per KV tile: 16 per warp
constexpr int S_STAGES = 2;                  // cp.async ring depth (3 blocks per SM at hd 128)
constexpr int S_THREADS = 128;
constexpr int T_STAGES = 3;                  // TMA ring depth of the few-rows (STREAM) instantiations
constexpr int T_MAX_ELEMS = 512;             // STREAM: rows x HD of a group, one float4 a thread in the merge

template <int HD>
struct SplitCfg {
  static constexpr int LD = HD + 8;          // bf16 row pitch of Q/K/V tiles (no ldmatrix conflicts)
  static constexpr int TILE = S_BKV * LD * 2;                 // bytes of one K or V tile
  static constexpr int RING = S_STAGES * 2 * TILE;
  static constexpr int Q_BYTES = S_ROWS * LD * 2;
  static constexpr int A_LD = HD + 4;        // fp32 row pitch of the warps' accumulators
  static constexpr int MERGE = 4 * S_ROWS * (A_LD + 2) * 4;  // reuses the ring
  static constexpr int SMEM = Q_BYTES + RING;
  static constexpr int PART = S_ROWS * (HD + 2);             // floats of one split's partial
  static_assert(MERGE <= RING, "merge area must fit the ring");
  // STREAM: K and V tiles as the TMA boxes land them, 64-column atoms of
  // 64 rows x 128 B, 128 B swizzle (heads of 80 in two atoms, columns 80..127
  // zero), 1024-aligned: 1024 B of slack, T_STAGES (K, V) tiles, Q as above,
  // one mbarrier a stage. Blocks an SM holds (228 KB, 1 KB reserved a
  // block, 128 B of static shared memory): 4 at heads of 64, 2 at 80 and
  // 128, 1 at 256 (on an H100); repro_flash_stream_blocks reports it.
  static constexpr int ATOMS = (HD == 80 ? 128 : HD) / 64;
  static constexpr int T_TILE = ATOMS * S_BKV * 128;
  static constexpr int T_RING = T_STAGES * 2 * T_TILE;
  static constexpr int T_SMEM = 1024 + T_RING + Q_BYTES + 8 * T_STAGES;
  static_assert(T_SMEM <= SMEM_LIMIT && MERGE <= T_RING, "the TMA ring must fit shared memory");
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(pred ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One (64 columns, rows, 1) box of a 3-D (hd, S, B x heads) tensor map.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Byte offset of (row, col) (col a multiple of 8) in a tile of S_BKV-row,
// 64-column atoms with 128 B swizzle: the 16-byte chunk XOR row % 8.
__device__ __forceinline__ uint32_t sw128_off(int row, int col) {
  return (col / 64) * (S_BKV * 128) + row * 128 + ((((col % 64) / 8) ^ (row & 7)) * 16);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// D += A B, m16n8k16, bf16 x bf16 -> fp32.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The split plan of one (batch row, row tile) group; kernels/flash/flash.py
// ::split_ranges computes the same on the host. The visible keys [lo, hi)
// of the group's rows, in 64-key tiles [t_lo, t_hi), are cut into runs of
// `chunk` tiles; split s takes run s. n_active splits have keys (at least
// one, which writes the empty result when no key is visible).
struct SplitPlan {
  int lo, hi, t_lo, t_hi, chunk, n_active;
  template <bool POS, bool QPOS>
  __device__ __forceinline__ SplitPlan(int q_first, int q_last, int Skv, const KeyPos<POS>& kp,
                                       int causal, int window, int splits,
                                       std::integral_constant<bool, QPOS>) {
    visible_range<POS, QPOS>(q_first, q_last, Skv, kp, causal, window, lo, hi);
    t_lo = lo / S_BKV;
    t_hi = hi > lo ? (hi + S_BKV - 1) / S_BKV : t_lo;
    const int n_t = t_hi - t_lo;
    chunk = n_t > 0 ? (n_t + splits - 1) / splits : 0;
    n_active = n_t > 0 ? (n_t + chunk - 1) / chunk : 1;
  }
};

// N fp32 values to dst: 16-byte stores, or 8-byte ones where N is not a
// multiple of 4 (heads of 80: 10 columns a thread at an 8-byte boundary).
template <int N>
__device__ __forceinline__ void store_f32(float* dst, const float (&a)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      reinterpret_cast<float4*>(dst)[i] = make_float4(a[4 * i], a[4 * i + 1], a[4 * i + 2], a[4 * i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) reinterpret_cast<float2*>(dst)[i] = make_float2(a[2 * i], a[2 * i + 1]);
  }
}

// a += f * src[0..N), read past L1 (another block's partial), 16 or 8 bytes at a time.
template <int N>
__device__ __forceinline__ void add_scaled_cg(float (&a)[N], float f, const float* src) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 x = __ldcg(reinterpret_cast<const float4*>(src) + i);
      a[4 * i] += f * x.x; a[4 * i + 1] += f * x.y; a[4 * i + 2] += f * x.z; a[4 * i + 3] += f * x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 x = __ldcg(reinterpret_cast<const float2*>(src) + i);
      a[2 * i] += f * x.x; a[2 * i + 1] += f * x.y;
    }
  }
}

// Store one merged row segment: normalized bf16, or the fp32 partial.
template <int N>
__device__ __forceinline__ void store_row(const float (&a)[N], float m, float l, bool lead,
                                          size_t row, int col, int HDv, __nv_bfloat16* out,
                                          float* acc_out, float* m_out, float* l_out) {
  if (out != nullptr) {
    const float den = fmaxf(l, 1e-30f);
    uint32_t w[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) w[i] = pack_bf16(a[2 * i] / den, a[2 * i + 1] / den);
    if constexpr (N % 8 == 0) {
      uint4* dst = reinterpret_cast<uint4*>(out + row * HDv + col);
#pragma unroll
      for (int i = 0; i < N / 8; ++i) dst[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
    } else {                                 // heads of 80: 10 columns a thread, 4-byte aligned
      uint32_t* dst = reinterpret_cast<uint32_t*>(out + row * HDv + col);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) dst[i] = w[i];
    }
  } else {
    store_f32<N>(acc_out + row * HDv + col, a);
    if (lead) {
      m_out[row] = m;
      l_out[row] = l;
    }
  }
}

// STREAM (the few-rows instantiations, path 2): the K/V tiles arrive by
// TMA from tensor maps (k_map, v_map; unused otherwise), one box a 64-column
// atom, onto one mbarrier a stage of a T_STAGES ring (the first T_STAGES
// tiles issued before the first wait) and are read at their swizzled
// addresses; only the valid rows' partials are published, and the last
// split merges them in one round trip, every thread on one float4 of the
// group's rows.
template <int HD, bool POS, bool QPOS, bool STREAM>
__global__ void __launch_bounds__(S_THREADS)
flash_fwd_kernel_split(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const int* __restrict__ q_offset,
                       const int* __restrict__ q_pos_in,
                       const int* __restrict__ kv_pos, __nv_bfloat16* __restrict__ out,
                       float* __restrict__ acc_out, float* __restrict__ m_out,
                       float* __restrict__ l_out, float* __restrict__ ws,
                       int* __restrict__ counters, int H, int Hkv,
                       int Sq, int Skv, int kv_offset, int causal, int window, float scale,
                       int splits, const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map) {
  using C = SplitCfg<HD>;
  constexpr int CH = HD / 8;                 // 16-byte chunks per row
  constexpr int STAGES = STREAM ? T_STAGES : S_STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  // STREAM: the ring first, at a 1024-byte boundary (the swizzle's period).
  unsigned char* const base =
      STREAM ? smem + (((smem_u32(smem) + 1023u) & ~1023u) - smem_u32(smem)) : smem;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(STREAM ? base + C::T_RING : smem);
  unsigned char* ring = STREAM ? base : smem + C::Q_BYTES;

  const int rt = blockIdx.x / splits, s = blockIdx.x % splits;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int rep = H / Hkv, R = rep * Sq;
  const int n_rt = (R + S_ROWS - 1) / S_ROWS;
  const int r0 = rt * S_ROWS;
  // STREAM: without a causal or window mask no position is read, so the
  // tile loads need not wait for q_offset.
  const int q_off = QPOS || (STREAM && !causal && !window) ? 0 : q_offset[b];
  const int* const qp = QPOS ? q_pos_in + static_cast<size_t>(b) * Sq : nullptr;
  const KeyPos<POS> kp{POS ? kv_pos + static_cast<size_t>(b) * Skv : nullptr, kv_offset};
  const SplitPlan plan(q_off + r0 / rep, q_off + min(R - 1, r0 + S_ROWS - 1) / rep, Skv, kp,
                       causal, window, splits, std::integral_constant<bool, QPOS>{});
  if (s >= plan.n_active) return;            // no key of this split is visible
  const int ts = plan.t_lo + s * plan.chunk;
  const int n_tiles = max(0, min(plan.t_hi, ts + plan.chunk) - ts);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const size_t kv_head = static_cast<size_t>(b) * Hkv + hk;
  const __nv_bfloat16* kb = k + kv_head * Skv * HD;
  const __nv_bfloat16* vb = v + kv_head * Skv * HD;

  // Packed row r -> query i = r / rep of head hk * rep + r % rep.
  auto out_row = [&](int r) -> size_t {
    const int rr = r0 + r;
    return (static_cast<size_t>(b) * H + hk * rep + rr % rep) * Sq + rr / rep;
  };

  auto load_tile = [&](int t, int stage) {
    const uint32_t kd = smem_u32(ring + stage * 2 * C::TILE);
    const uint32_t vd = kd + C::TILE;
    const int kv0 = t * S_BKV;
#pragma unroll
    for (int i = 0; i < S_BKV * CH / S_THREADS; ++i) {
      const int idx = i * S_THREADS + tid, row = idx / CH, ch = idx % CH;
      const bool in = kv0 + row < Skv;
      const size_t off = in ? static_cast<size_t>(kv0 + row) * HD + ch * 8 : 0;
      const uint32_t so = (row * C::LD + ch * 8) * 2;
      cp_async16(kd + so, kb + off, in);
      cp_async16(vd + so, vb + off, in);
    }
  };

  // STREAM: thread 0 loads tile t's K and V boxes into `stage`; the TMA
  // fills rows past Skv (and heads of 80's columns past 80) with zeros.
  const uint32_t bars = smem_u32(Qs) + C::Q_BYTES;
  auto issue_tile = [&](int t, int stage) {
    const uint32_t bar = bars + 8 * stage, dst = smem_u32(ring) + stage * 2 * C::T_TILE;
    mbar_expect_tx(bar, 2 * C::T_TILE);
#pragma unroll
    for (int j = 0; j < C::ATOMS; ++j) {
      tma_load_3d(dst + j * S_BKV * 128, &k_map, bar, j * 64, t * S_BKV, b * Hkv + hk);
      tma_load_3d(dst + C::T_TILE + j * S_BKV * 128, &v_map, bar, j * 64, t * S_BKV, b * Hkv + hk);
    }
  };

  // Start the ring, then stage the packed Q rows (zero past R). STREAM:
  // thread 0 starts the ring before the block's barrier that makes the
  // mbarriers' initialisation visible to the other threads.
  if constexpr (STREAM) {
    if (tid == 0) {
      for (int i = 0; i < T_STAGES; ++i) mbar_init(bars + 8 * i, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int p = 0; p < T_STAGES && p < n_tiles; ++p) issue_tile(ts + p, p);
    }
    __syncthreads();
  } else {
#pragma unroll
    for (int p = 0; p < S_STAGES - 1; ++p) {
      if (p < n_tiles) load_tile(ts + p, p);
      cp_async_commit();
    }
  }
  for (int idx = tid; idx < S_ROWS * CH; idx += S_THREADS) {
    const int r = idx / CH, ch = idx % CH;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < R) val = *reinterpret_cast<const uint4*>(q + out_row(r) * HD + ch * 8);
    *reinterpret_cast<uint4*>(Qs + r * C::LD + ch * 8) = val;
  }
  __syncthreads();
  // Q's fragments: held in registers up to heads of 128; at 256 they would
  // take 64 registers beside the 128 of the accumulator, so each k-step
  // reads its fragment from the staged tile instead.
  constexpr bool Q_REGS = HD <= 128;
  auto q_addr = [&](int kk) {
    return smem_u32(Qs + (lane % 16) * C::LD + kk * 16 + (lane / 16) * 8);
  };
  uint32_t qf[Q_REGS ? HD / 16 : 1][4];
  if constexpr (Q_REGS) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) ldsm_x4(qf[kk], q_addr(kk));
  }

  // This thread's two rows (g, g + 8) and their positions.
  bool row_ok[2];
  int q_pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = r0 + g + 8 * h;
    row_ok[h] = rr < R;
    if constexpr (QPOS) q_pos[h] = row_ok[h] ? __ldg(qp + rr / rep) : 0;
    else q_pos[h] = q_off + rr / rep;
  }
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    if constexpr (STREAM) {
      mbar_wait(bars + 8 * (it % T_STAGES), (it / T_STAGES) & 1);
      __syncthreads();                       // tile it landed; tile it-1's stage is free
      if (tid == 0 && it > 0 && it + T_STAGES - 1 < n_tiles)
        issue_tile(ts + it + T_STAGES - 1, (it - 1) % T_STAGES);
    } else {
      cp_async_wait<S_STAGES - 2>();
      __syncthreads();                       // tile it landed; tile it-1's stage is free
      if (it + S_STAGES - 1 < n_tiles) load_tile(ts + it + S_STAGES - 1, (it + S_STAGES - 1) % S_STAGES);
      cp_async_commit();
    }

    const int key0 = (ts + it) * S_BKV + warp * 16;   // this warp's 16 keys
    if (key0 >= plan.hi || key0 + 16 <= plan.lo) continue;   // hidden from every row
    // Fragment addresses: this warp's rows warp * 16 + r of the stage's
    // K or V tile, padded rows, or (STREAM) swizzled atoms.
    const uint32_t kst = smem_u32(ring) + (it % STAGES) * 2 * (STREAM ? C::T_TILE : C::TILE);
    const uint32_t ks = kst + warp * 16 * C::LD * 2;
    const uint32_t vs = ks + C::TILE;
    auto k_at = [&](int kk) -> uint32_t {
      const int r = (lane / 16) * 8 + lane % 8, col = kk * 16 + ((lane / 8) & 1) * 8;
      if constexpr (STREAM) return kst + sw128_off(warp * 16 + r, col);
      else return ks + (r * C::LD + col) * 2;
    };
    auto v_at = [&](int n) -> uint32_t {
      const int r = ((lane / 8) & 1) * 8 + lane % 8, col = n * 16 + (lane / 16) * 8;
      if constexpr (STREAM) return kst + C::T_TILE + sw128_off(warp * 16 + r, col);
      else return vs + (r * C::LD + col) * 2;
    };

    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t kf[4];
      ldsm_x4(kf, k_at(kk));
      if constexpr (Q_REGS) {
        mma16816(sc[0], qf[kk], kf[0], kf[1]);
        mma16816(sc[1], qf[kk], kf[2], kf[3]);
      } else {
        uint32_t qa[4];
        ldsm_x4(qa, q_addr(kk));
        mma16816(sc[0], qa, kf[0], kf[1]);
        mma16816(sc[1], qa, kf[2], kf[3]);
      }
    }
    // Online softmax over these 16 keys; rows g (e < 2) and g + 8 (e >= 2).
    uint32_t vis = 0;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const bool ok = row_ok[h] &&
                        visible(q_pos[h], key0 + j * 8 + 2 * c + (e & 1), Skv, kp, causal, window);
        vis |= static_cast<uint32_t>(ok) << (j * 4 + e);
        sc[j][e] = ok ? sc[j][e] * scale : NEG_INF;
        mx[h] = fmaxf(mx[h], sc[j][e]);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m_run[h], quad_max(mx[h]));
      corr[h] = exp2f((m_run[h] - m_new) * LOG2E);
      m_run[h] = m_new;
      l_run[h] *= corr[h];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ((vis >> (j * 4 + e)) & 1u) ? exp2f((sc[j][e] - m_run[e / 2]) * LOG2E) : 0.f;
        sc[j][e] = p;
        l_run[e / 2] += p;
      }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      acc[j][0] *= corr[0]; acc[j][1] *= corr[0];
      acc[j][2] *= corr[1]; acc[j][3] *= corr[1];
    }
    const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]), pack_bf16(sc[0][2], sc[0][3]),
                            pack_bf16(sc[1][0], sc[1][1]), pack_bf16(sc[1][2], sc[1][3])};
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      uint32_t vf[4];
      ldsm_x4_t(vf, v_at(n));
      mma16816(acc[2 * n], pa, vf[0], vf[1]);
      mma16816(acc[2 * n + 1], pa, vf[2], vf[3]);
    }
  }
  if constexpr (!STREAM) cp_async_wait<0>();           // STREAM: every tile was waited on
  __syncthreads();                           // the ring is free for the merge

  // Merge the 4 warps' partials through shared memory.
  float* Mw = reinterpret_cast<float*>(ring);                // [4][16]
  float* Lw = Mw + 4 * S_ROWS;                               // [4][16]
  float* Aw = Lw + 4 * S_ROWS;                               // [4][16][A_LD]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float l = quad_sum(l_run[h]);
    if (c == 0) {
      Mw[warp * S_ROWS + g + 8 * h] = m_run[h];
      Lw[warp * S_ROWS + g + 8 * h] = l;
    }
  }
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    float* a0 = Aw + (warp * S_ROWS + g) * C::A_LD + j * 8 + 2 * c;
    *reinterpret_cast<float2*>(a0) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(a0 + 8 * C::A_LD) = make_float2(acc[j][2], acc[j][3]);
  }
  __syncthreads();

  constexpr int SEG = HD / 8;                // columns per thread: 8 threads per row
  const int row = tid / 8, col = (tid % 8) * SEG;
  const bool lead = tid % 8 == 0;
  float m = NEG_INF;
#pragma unroll
  for (int w = 0; w < 4; ++w) m = fmaxf(m, Mw[w * S_ROWS + row]);
  float l = 0.f, a[SEG];
#pragma unroll
  for (int i = 0; i < SEG; ++i) a[i] = 0.f;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const float f = exp2f((Mw[w * S_ROWS + row] - m) * LOG2E);
    l += f * Lw[w * S_ROWS + row];
    const float* src = Aw + (w * S_ROWS + row) * C::A_LD + col;
#pragma unroll
    for (int i = 0; i < SEG; ++i) a[i] += f * src[i];
  }
  const bool row_valid = r0 + row < R;

  if (plan.n_active == 1) {                  // the only split: write the result
    if (row_valid) store_row(a, m, l, lead, out_row(row), col, HD, out, acc_out, m_out, l_out);
    return;
  }

  // STREAM: the merge of the P split partials in the workspace (PART
  // layout: m [S_ROWS], l [S_ROWS], acc [S_ROWS][HD]) of the group's nv rows
  // (R x HD <= T_MAX_ELEMS: one row tile) in one round trip: G thread groups
  // of one float4 a thread each load every G-th split's acc (up to T_PRE
  // of them ahead) while (1) every (row, split) pair's m and l go to shared
  // memory; (2) each row's m, l and its splits' weights, a warp a row over
  // the splits; (3) each thread's weighted sum; (4) the groups' sums added
  // and stored.
  auto merge = [&](const float* parts, int P) {
    constexpr int CPR = HD / 4;              // float4s a row
    constexpr int T_PRE = 4;
    const int nv = R - r0, chunks = nv * CPR, G = S_THREADS / chunks;
    float* Ms = reinterpret_cast<float*>(ring);              // [nv][P]: m, then its weight
    float* Ls = Ms + nv * P;                                 // [nv][P]
    float* Rm = Ls + nv * P;                                 // [nv]: the merged m, then l
    float* Rl = Rm + nv;
    float4* Red = reinterpret_cast<float4*>(ring + (((2 * nv * P + 2 * nv) * 4 + 15) & ~15));
    const bool mine = tid < G * chunks;
    const int q4 = tid % chunks, p0 = tid / chunks;         // this thread's float4, first split
    const float* src = parts + 2 * S_ROWS + (q4 / CPR) * HD + (q4 % CPR) * 4;
    float4 pre[T_PRE];
#pragma unroll
    for (int j = 0; j < T_PRE; ++j)
      pre[j] = mine && p0 + j * G < P
                   ? __ldcg(reinterpret_cast<const float4*>(src + (p0 + j * G) * C::PART))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = tid; i < nv * P; i += S_THREADS) {
      Ms[i] = __ldcg(parts + (i % P) * C::PART + i / P);
      Ls[i] = __ldcg(parts + (i % P) * C::PART + S_ROWS + i / P);
    }
    __syncthreads();
    for (int rw = warp; rw < nv; rw += S_THREADS / 32) {
      float mx = NEG_INF, sum = 0.f;
      for (int p = lane; p < P; p += 32) mx = fmaxf(mx, Ms[rw * P + p]);
#pragma unroll
      for (int o = 16; o > 0; o /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      for (int p = lane; p < P; p += 32) {
        const float f = exp2f((Ms[rw * P + p] - mx) * LOG2E);
        Ms[rw * P + p] = f;
        sum += f * Ls[rw * P + p];
      }
#pragma unroll
      for (int o = 16; o > 0; o /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        Rm[rw] = mx;
        Rl[rw] = sum;
      }
    }
    __syncthreads();
    if (mine) {
      const float* f = Ms + (q4 / CPR) * P;
      float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < T_PRE; ++j) {
        const float w = p0 + j * G < P ? f[p0 + j * G] : 0.f;
        s4.x += w * pre[j].x; s4.y += w * pre[j].y; s4.z += w * pre[j].z; s4.w += w * pre[j].w;
      }
#pragma unroll 4
      for (int p = p0 + T_PRE * G; p < P; p += G) {
        const float4 x = __ldcg(reinterpret_cast<const float4*>(src + p * C::PART));
        const float w = f[p];
        s4.x += w * x.x; s4.y += w * x.y; s4.z += w * x.z; s4.w += w * x.w;
      }
      Red[tid] = s4;
    }
    __syncthreads();
    if (tid < chunks) {
      float4 s4 = Red[tid];
      for (int g = 1; g < G; ++g) {
        const float4 x = Red[g * chunks + tid];
        s4.x += x.x; s4.y += x.y; s4.z += x.z; s4.w += x.w;
      }
      const int rw = tid / CPR, c4 = (tid % CPR) * 4;
      const float a4[4] = {s4.x, s4.y, s4.z, s4.w};
      store_row<4>(a4, Rm[rw], Rl[rw], c4 == 0, out_row(rw), c4, HD, out, acc_out, m_out, l_out);
    }
  };

  // Several splits: publish this split's partial, count in; the last merges.
  const int grp = (b * Hkv + hk) * n_rt + rt;
  float* part = ws + (static_cast<size_t>(grp) * splits + s) * C::PART;
  if (!STREAM || row_valid) {
    if (lead) {
      part[row] = m;
      part[S_ROWS + row] = l;
    }
    store_f32<SEG>(part + 2 * S_ROWS + row * HD + col, a);
  }
  __threadfence();
  __syncthreads();
  __shared__ int is_last;
  if (tid == 0) is_last = atomicAdd(counters + grp, 1) == plan.n_active - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  const float* parts = ws + static_cast<size_t>(grp) * splits * C::PART;
  if constexpr (STREAM) {
    merge(parts, plan.n_active);
    if (tid == 0) counters[grp] = 0;         // ready for the next launch
    return;
  }
  m = NEG_INF;
  for (int p = 0; p < plan.n_active; ++p) m = fmaxf(m, __ldcg(parts + p * C::PART + row));
  l = 0.f;
#pragma unroll
  for (int i = 0; i < SEG; ++i) a[i] = 0.f;
  for (int p = 0; p < plan.n_active; ++p) {
    const float* src = parts + p * C::PART;
    const float f = exp2f((__ldcg(src + row) - m) * LOG2E);
    l += f * __ldcg(src + S_ROWS + row);
    add_scaled_cg<SEG>(a, f, src + 2 * S_ROWS + row * HD + col);
  }
  if (row_valid) store_row(a, m, l, lead, out_row(row), col, HD, out, acc_out, m_out, l_out);
  if (tid == 0) counters[grp] = 0;           // ready for the next launch
}

// ================================================== prefill path (wgmma)

constexpr int W_BM = 128;                    // query rows per block: 64 per consumer warpgroup
constexpr int W_CONSUMER_WARPS = 8;
constexpr int W_THREADS = 32 * W_CONSUMER_WARPS + 128;   // + the producer warpgroup
constexpr int W_EPI_COLS = 32;               // fp32 epilogue strip: 16 rows x 32 columns per warp

template <int HD>
struct WgCfg {
  // Keys per K/V tile: 128, or 64 at heads of 256, where a 128-key tile
  // (64 KB for K or V) leaves room for one stage beside the 64 KB Q tile and
  // a consumer thread's S would take 64 registers beside O's 128.
  static constexpr int BN = HD > 128 ? 64 : 128;
  // Columns of a tile row: heads of 80 sit in tiles of 128 (two swizzle
  // atoms), whose columns 80..127 the TMA fills with zeros, past the
  // tensor map's inner extent of 80.
  static constexpr int TD = HD == 80 ? 128 : HD;
  static constexpr int KS = (HD + 15) / 16;  // k-steps of S = Q K^T: the zero columns add nothing
  static constexpr int ATOMS = TD / 64;      // 64-column (128 B) swizzle atoms per row
  static constexpr int Q_BYTES = W_BM * TD * 2;
  static constexpr int KV_BYTES = BN * TD * 2;              // one K or V tile
  static constexpr int FIT = (SMEM_LIMIT - 1024 - Q_BYTES - 256) / (2 * KV_BYTES);
  static constexpr int STAGES = FIT > 4 ? 4 : FIT;
  // 1024 B of slack to align Q to the swizzle atom, Q, the ring, then the
  // mbarriers: Q full, K full/empty and V full/empty per stage.
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * 2 * KV_BYTES + 8 * (1 + 4 * STAGES);
  // With key positions, after the mbarriers: each consumer warpgroup's copy
  // of the BN positions of the tile it masks.
  static constexpr int POS_BYTES = 2 * BN * 4;
  static_assert(STAGES >= 2 && SMEM + POS_BYTES <= SMEM_LIMIT, "tiles do not fit shared memory");
};

// hopper.cuh's fence_regs for the registers an asynchronous wgmma reads
// (its A operand): keeps them live, unchanged, until after the wait.
template <int M>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[M][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// Named barriers (ids 1..15; 0 is __syncthreads) over `count` threads.
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// wgmma.mma_async m64nNk16, bf16 x bf16 -> fp32. SS: A and B K-major in
// shared memory (S = Q K^T); RS: A in registers, B MN-major (imm-trans-b =
// 1; O += P V). The accumulators are overwritten when scale_d == 0.
template <int N>
struct WgmmaSS;
template <int N>
struct WgmmaRS;

template <>
struct WgmmaSS<128> {
  __device__ static __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaSS<64> {
  __device__ static __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaRS<128> {
  __device__ static __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaRS<64> {
  __device__ static __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};


template <int HD, bool POS, bool QPOS>
__global__ void __launch_bounds__(W_THREADS, 1)
flash_fwd_kernel_wgmma(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const int* __restrict__ q_offset, const int* __restrict__ q_pos_in,
                       const int* __restrict__ kv_pos,
                       __nv_bfloat16* __restrict__ out, float* __restrict__ acc_out,
                       float* __restrict__ m_out, float* __restrict__ l_out, int H, int Hkv,
                       int Sq, int Skv, int kv_offset, int causal, int window, float scale) {
  using C = WgCfg<HD>;
  constexpr int STAGES = C::STAGES;
  constexpr int BN = C::BN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base;                                   // [ATOMS][BM][64]
  const uint32_t ring = base + C::Q_BYTES;                     // STAGES x (K, V) [ATOMS][BN][64]
  const uint32_t bars = base + C::Q_BYTES + STAGES * 2 * C::KV_BYTES;
  const uint32_t q_full = bars;
  const uint32_t k_full = bars + 8, v_full = k_full + 8 * STAGES;
  const uint32_t k_empty = v_full + 8 * STAGES, v_empty = k_empty + 8 * STAGES;

  // Blocks are issued x fastest: every head's last query tile (the longest
  // causal rows) first, the first tiles last.
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / (H / Hkv);
  const int q0 = qt * W_BM;
  const int q_off = QPOS ? 0 : q_offset[b];
  const KeyPos<POS> kp{POS ? kv_pos + static_cast<size_t>(b) * Skv : nullptr, kv_offset};
  int lo, hi;
  visible_range<POS, QPOS>(q_off + q0, q_off + min(q0 + W_BM, Sq) - 1, Skv, kp, causal, window,
                           lo, hi);
  const int t_begin = lo / BN;
  const int t_end = hi > lo ? (hi + BN - 1) / BN : t_begin;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, W_CONSUMER_WARPS);
      mbar_init(v_empty + 8 * s, W_CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= W_CONSUMER_WARPS) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    // Warp 8 loads Q and the K tiles, warp 9 the V tiles: a V stage that is
    // still being read does not hold back the next K tile.
    const bool k_thread = warp == W_CONSUMER_WARPS && lane == 0;
    const bool v_thread = warp == W_CONSUMER_WARPS + 1 && lane == 0;
    if (k_thread) {
      mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int j = 0; j < C::ATOMS; ++j)
        tma_load_3d(q_s + j * W_BM * 128, &q_map, q_full, j * 64, q0, b * H + h);
    }
    if (k_thread || v_thread) {
      const CUtensorMap* map = k_thread ? &k_map : &v_map;
      const uint32_t full = k_thread ? k_full : v_full, empty = k_thread ? k_empty : v_empty;
      const uint32_t off = k_thread ? 0 : C::KV_BYTES;
      int stage = 0;
      uint32_t phase = 0;
      for (int t = t_begin; t < t_end; ++t) {
        const uint32_t dst = ring + stage * 2 * C::KV_BYTES + off;
        mbar_wait(empty + 8 * stage, phase ^ 1);
        mbar_expect_tx(full + 8 * stage, C::KV_BYTES);
#pragma unroll
        for (int j = 0; j < C::ATOMS; ++j)
          tma_load_3d(dst + j * BN * 128, map, full + 8 * stage, j * 64, t * BN, b * Hkv + hk);
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = warp / 4, wq = warp % 4;    // warpgroup, warp within it
  // Key positions (POS): each of the first BN threads loads one of a tile's
  // BN before the tile's S product is issued, and the warpgroup stages them in its slot of
  // shared memory for the mask (named barrier 3 + wg over its 128 threads),
  // so no thread keeps the 32 its columns need in registers.
  int* const pos_s = reinterpret_cast<int*>(smem_raw + (bars - raw) + 8 * (1 + 4 * STAGES)) +
                     wg * BN;
  const int tid_wg = threadIdx.x % 128;
  auto fetch_pos = [&](int t) -> int {
    const int kidx = t * BN + tid_wg;
    return kidx < Skv ? kp(kidx) : 0;
  };
  const int g = lane / 4, c = lane % 4;
  const int row0 = q0 + wg * 64 + wq * 16 + g;               // this thread's rows: row0, row0 + 8
  int q_pos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if constexpr (QPOS)
      q_pos[r] = row < Sq ? __ldg(q_pos_in + static_cast<size_t>(b) * Sq + row) : 0;
    else
      q_pos[r] = q_off + row;
  }
  const int wq_first = q0 + wg * 64, wq_last = min(q0 + wg * 64 + 63, Sq - 1);
  constexpr int TD = C::TD;
  float o[TD / 2];
#pragma unroll
  for (int i = 0; i < TD / 2; ++i) o[i] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
  const uint32_t q_wg = q_s + wg * 64 * 128;
  int stage = 0;
  uint32_t phase = 0;
  auto advance = [&] {
    if (++stage == STAGES) { stage = 0; phase ^= 1; }
  };
  // S = Q K^T of the stage's K tile into s, one commit group.
  auto mma_s = [&](float (&s)[BN / 2], int st) {
    const uint32_t ks = ring + st * 2 * C::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < C::KS; ++kk)
      WgmmaSS<BN>::mma(s, sw128_desc(q_wg + (kk / 4) * W_BM * 128 + (kk % 4) * 32, 16, 1024),
                         sw128_desc(ks + (kk / 4) * BN * 128 + (kk % 4) * 32, 16, 1024), kk);
    wgmma_commit();
  };
  // O += P V of the stage's V tile, one commit group. At heads of 256 the
  // product is two N = 128 wgmma per k-step, on the two halves of O (its
  // registers are column-major in 8-column groups, so a half is a run of 64)
  // and of V's swizzle atoms.
  auto mma_pv = [&](const uint32_t (&pa)[BN / 16][4], int st) {
    const uint32_t vs = ring + st * 2 * C::KV_BYTES + C::KV_BYTES;
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      if constexpr (TD <= 128) {
        WgmmaRS<TD>::mma(o, pa[kc], sw128_desc(vs + kc * 16 * 128, BN * 128, 1024), 1);
      } else {
#pragma unroll
        for (int n = 0; n < TD / 128; ++n)
          WgmmaRS<128>::mma(*reinterpret_cast<float(*)[64]>(&o[64 * n]), pa[kc],
                            sw128_desc(vs + n * 2 * BN * 128 + kc * 16 * 128, BN * 128, 1024), 1);
      }
    }
    wgmma_commit();
  };
  // Online softmax of tile t's scores, in place: s[4j + e] (row row0 +
  // 8 (e / 2), key t*BN + 8j + 2c + (e & 1)) becomes p. Returns the rescale
  // factors of the rows' earlier sums in corr.
  auto softmax = [&](float (&s)[BN / 2], int t, float (&corr)[2], int my_pos) {
    const int k0 = t * BN;
    if constexpr (POS) {
      named_bar_sync(3 + wg, 128);           // every thread has read the last tile's
      if (tid_wg < BN) pos_s[tid_wg] = my_pos;
      named_bar_sync(3 + wg, 128);
    }
    const bool edge = POS || QPOS || k0 + BN > Skv ||
                      (causal && kv_offset + k0 + BN - 1 > q_off + wq_first) ||
                      (window && q_off + wq_last - (kv_offset + k0) >= window);
    // Off the mask edges with a positive scale, s stays unscaled (the max
    // commutes with the scale) and the scale goes into the exponent's FFMA.
    const bool raw = !edge && scale > 0.f;
    float mx[2] = {NEG_INF, NEG_INF};
    if (edge) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int e = i % 4;
        const int kidx = k0 + (i / 4) * 8 + 2 * c + (e & 1);
        bool ok;
        if constexpr (POS) {
          const int d = q_pos[e / 2] - pos_s[kidx - k0];
          ok = kidx < Skv && (!causal || d >= 0) && (!window || d < window);
        } else {
          ok = visible(q_pos[e / 2], kidx, Skv, kp, causal, window);
        }
        s[i] = ok ? s[i] * scale : NEG_INF;
        mx[e / 2] = fmaxf(mx[e / 2], s[i]);
      }
    } else if (raw) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], s[i]);
      mx[0] *= scale;
      mx[1] *= scale;
    } else {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        s[i] *= scale;
        mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], s[i]);
      }
    }
    const float mul = raw ? scale * LOG2E : LOG2E;
    float mb[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
      corr[r] = fast_exp2((m_run[r] - m_new) * LOG2E);
      m_run[r] = m_new;
      mb[r] = m_new * LOG2E;
      l_run[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int r = (i % 4) / 2;
      float p = fast_exp2(fmaf(s[i], mul, -mb[r]));
      if (edge && s[i] == NEG_INF) p = 0.f;  // hidden key: 0 even when m is NEG_INF
      l_run[r] += p;
      s[i] = p;
    }
  };
  // p (fp32) -> the bf16 A operand of P V: pa[kc] holds keys 16kc..16kc+15.
  auto to_a = [&](const float (&s)[BN / 2], uint32_t (&pa)[BN / 16][4]) {
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) pa[i / 8][(i % 8) / 2] = pack_bf16(s[i], s[i + 1]);
  };

  // Ping-pong: the two warpgroups take turns to issue their wgmma (named
  // barriers 1 and 2, each met by one warpgroup's sync and the other's
  // arrive), so one runs its softmax while the other's products run. Both
  // walk the block's tiles [t_begin, t_end): a tile hidden from all of a
  // warpgroup's rows is an exact no-op (p = 0, corr = 1). Each issues
  // n + 1 times (S of the first tile, S(t) with P V(t-1), P V of the last);
  // warpgroup 1 opens the first turn and skips its last hand-over.
  const int n_t = t_end - t_begin;
  const int my_bar = 1 + wg, other_bar = 2 - wg;
  int turn = 0;
  auto my_turn = [&] { named_bar_sync(my_bar, 256); };
  auto hand_over = [&] {
    if (wg == 0 || ++turn < n_t + 1) named_bar_arrive(other_bar, 256);
  };

  mbar_wait(q_full, 0);
  if (n_t > 0) {
    // Software pipeline: S(t) = Q K(t)^T is issued with O += P(t-1) V(t-1)
    // behind it, so the tensor cores run P V while this warpgroup runs the
    // softmax of tile t. Every register a wgmma reads or accumulates into
    // is pinned (fence_regs) before the one wgmma.fence of its issue, and p
    // becomes the A operand only after P(t-1) V(t-1) retired, so no other
    // instruction writes them while the wgmma are in flight (ptxas would
    // serialize the wgmma).
    if (wg == 1) named_bar_arrive(other_bar, 256);
    float s[BN / 2], corr[2];
    uint32_t pa[BN / 16][4];
    int my_pos = POS ? fetch_pos(t_begin) : 0;
    mbar_wait(k_full + 8 * stage, phase);
    my_turn();
    fence_regs(s);
    wgmma_fence();
    mma_s(s, stage);
    hand_over();
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(k_empty + 8 * stage);
    softmax(s, t_begin, corr, my_pos);
    to_a(s, pa);
    int pv_stage = stage;                    // the stage of the tile whose P V is pending
    uint32_t pv_phase = phase;
    advance();
    for (int t = t_begin + 1; t < t_end; ++t) {
      if constexpr (POS) my_pos = fetch_pos(t);
      mbar_wait(k_full + 8 * stage, phase);
      mbar_wait(v_full + 8 * pv_stage, pv_phase);
      my_turn();
      fence_regs(s);
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
      mma_s(s, stage);
      mma_pv(pa, pv_stage);
      hand_over();
      wgmma_wait<1>();                       // S(t) done; P(t-1) V(t-1) may still run
      fence_regs(s);
      if (lane == 0) mbar_arrive(k_empty + 8 * stage);
      softmax(s, t, corr, my_pos);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);                        // P(t-1) was read until here
      if (lane == 0) mbar_arrive(v_empty + 8 * pv_stage);
      to_a(s, pa);
#pragma unroll
      for (int i = 0; i < TD / 2; ++i) o[i] *= corr[(i % 4) / 2];
      pv_stage = stage;
      pv_phase = phase;
      advance();
    }
    mbar_wait(v_full + 8 * pv_stage, pv_phase);
    my_turn();
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
    mma_pv(pa, pv_stage);
    hand_over();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    if (lane == 0) mbar_arrive(v_empty + 8 * pv_stage);
  }

  // Epilogue: this warp's 16 rows, 32 columns at a time, through a strip in
  // its warpgroup's own Q rows (read for the last time by its last wgmma).
  // Strip row r keeps its 8-column chunks XOR-swizzled by r & 3.
  float l[2], den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l_run[r]);
    den[r] = out != nullptr ? fmaxf(l[r], 1e-30f) : 1.f;
  }
  float* strip = reinterpret_cast<float*>(smem_raw + (base - raw) + wg * 64 * 128 +
                                          wq * 16 * W_EPI_COLS * 4);
  auto at = [&](int r, int col) {            // strip address of (row, column)
    return strip + r * W_EPI_COLS + (((col / 8) ^ (r & 3)) * 8) + col % 8;
  };
  const int wrow0 = q0 + wg * 64 + wq * 16;                  // the strip's first row
  const size_t head_row = (static_cast<size_t>(b) * H + h) * Sq;
#pragma unroll
  for (int cc = 0; cc < (HD + W_EPI_COLS - 1) / W_EPI_COLS; ++cc) {   // 2.5 strips at 80
#pragma unroll
    for (int jj = 0; jj < W_EPI_COLS / 8; ++jj) {
      const int j = cc * (W_EPI_COLS / 8) + jj;
      *reinterpret_cast<float2*>(at(g, jj * 8 + 2 * c)) =
          make_float2(o[4 * j] / den[0], o[4 * j + 1] / den[0]);
      *reinterpret_cast<float2*>(at(g + 8, jj * 8 + 2 * c)) =
          make_float2(o[4 * j + 2] / den[1], o[4 * j + 3] / den[1]);
    }
    __syncwarp();
    if (out != nullptr) {                    // 16 rows x 64 B: 2 x 16 B per lane
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = (i * 32 + lane) / 4, ch = lane % 4;
        if (wrow0 + r < Sq && cc * W_EPI_COLS + ch * 8 < HD) {
          const float4 x = *reinterpret_cast<const float4*>(at(r, ch * 8));
          const float4 y = *reinterpret_cast<const float4*>(at(r, ch * 8) + 4);
          *reinterpret_cast<uint4*>(out + (head_row + wrow0 + r) * HD + cc * W_EPI_COLS + ch * 8) =
              make_uint4(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w), pack_bf16(y.x, y.y),
                         pack_bf16(y.z, y.w));
        }
      }
    } else {                                 // 16 rows x 128 B: 4 x 16 B per lane
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = (i * 32 + lane) / 8, q4 = lane % 8;
        if (wrow0 + r < Sq && cc * W_EPI_COLS + q4 * 4 < HD)
          *reinterpret_cast<float4*>(acc_out + (head_row + wrow0 + r) * HD + cc * W_EPI_COLS + q4 * 4) =
              *reinterpret_cast<const float4*>(at(r, q4 * 4));
      }
    }
    __syncwarp();
  }
  if (out == nullptr && c == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row0 + 8 * r < Sq) {
        m_out[head_row + row0 + 8 * r] = m_run[r];
        l_out[head_row + row0 + 8 * r] = l[r];
      }
    }
  }
}

// ================================================================== host

// A (hd, S, heads) bf16 tensor, row-major (hd innermost); boxes of
// (64, rows, 1) with 128 B swizzle. Rows past S of a head are zero-filled.
bool encode_3d(CUtensorMap* map, const void* ptr, int hd, int S, int heads, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(S) * hd * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Opt a kernel into its dynamic shared memory once per device.
template <typename K>
cudaError_t set_smem_once(K kernel, int bytes, bool (&done)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err != cudaSuccess) return err;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace

// One launch's arguments; outside the anonymous namespace, as the launches
// with query positions take them in the other translation unit.
struct FlashArgs {
  const void *q, *k, *v;
  const int* q_offset;
  const int* q_pos;
  const int* kv_pos;
  __nv_bfloat16* out;
  float *acc, *m, *l, *ws;
  int* counters;
  int B, H, Hkv, Sq, Skv, kv_offset, causal, window, splits;
  float scale;
  cudaStream_t stream;
};

namespace {

template <int HD, bool POS, bool QPOS, bool STREAM>
int launch_split(const FlashArgs& a) {
  static bool done[MAX_DEVICES];
  constexpr int smem = STREAM ? SplitCfg<HD>::T_SMEM : SplitCfg<HD>::SMEM;
  const cudaError_t err = set_smem_once(flash_fwd_kernel_split<HD, POS, QPOS, STREAM>, smem, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = (a.H / a.Hkv) * a.Sq;
  const int n_rt = (rows + S_ROWS - 1) / S_ROWS;
  // STREAM: one row tile whose rows take one float4 a thread in the merge,
  // and the merge's m, l and weights of every (row, split) and its thread
  // groups' sums fit the ring (the wrapper raises a ValueError).
  if (STREAM && (rows * HD > T_MAX_ELEMS ||
                 (2 * rows * a.splits + 2 * rows) * 4 + 16 + S_THREADS * 16 > SplitCfg<HD>::T_RING))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap k_map{}, v_map{};                // STREAM only: 64-key boxes of K and V
  if (STREAM && (!encode_3d(&k_map, a.k, HD, a.Skv, a.B * a.Hkv, S_BKV) ||
                 !encode_3d(&v_map, a.v, HD, a.Skv, a.B * a.Hkv, S_BKV)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_rt * a.splits, a.Hkv, a.B);
  flash_fwd_kernel_split<HD, POS, QPOS, STREAM><<<grid, S_THREADS, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), a.q_offset, a.q_pos, a.kv_pos, a.out, a.acc, a.m,
      a.l, a.ws, a.counters, a.H, a.Hkv, a.Sq, a.Skv, a.kv_offset, a.causal, a.window, a.scale, a.splits,
      k_map, v_map);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, bool POS, bool QPOS>
int launch_wgmma(const FlashArgs& a) {
  static bool done[MAX_DEVICES];
  constexpr int smem = WgCfg<HD>::SMEM + (POS ? WgCfg<HD>::POS_BYTES : 0);
  const cudaError_t err = set_smem_once(flash_fwd_kernel_wgmma<HD, POS, QPOS>, smem, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap q_map, k_map, v_map;
  if (!encode_3d(&q_map, a.q, HD, a.Sq, a.B * a.H, W_BM) ||
      !encode_3d(&k_map, a.k, HD, a.Skv, a.B * a.Hkv, WgCfg<HD>::BN) ||
      !encode_3d(&v_map, a.v, HD, a.Skv, a.B * a.Hkv, WgCfg<HD>::BN))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(a.H, a.B, (a.Sq + W_BM - 1) / W_BM);
  flash_fwd_kernel_wgmma<HD, POS, QPOS><<<grid, W_THREADS, smem, a.stream>>>(
      q_map, k_map, v_map, a.q_offset, a.q_pos, a.kv_pos, a.out, a.acc, a.m, a.l, a.H, a.Hkv,
      a.Sq, a.Skv, a.kv_offset, a.causal, a.window, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool POS, bool QPOS, bool STREAM>
int launch_split_hd(const FlashArgs& a, int hd) {
  return hd == 256 ? launch_split<256, POS, QPOS, STREAM>(a)
         : hd == 128 ? launch_split<128, POS, QPOS, STREAM>(a)
         : hd == 80 ? launch_split<80, POS, QPOS, STREAM>(a) : launch_split<64, POS, QPOS, STREAM>(a);
}

// Blocks of a STREAM instantiation an SM holds, by the occupancy API.
template <int HD>
int stream_blocks(int* blocks) {
  static bool done[MAX_DEVICES];
  const auto kernel = flash_fwd_kernel_split<HD, false, false, true>;
  const cudaError_t err = set_smem_once(kernel, SplitCfg<HD>::T_SMEM, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, S_THREADS, SplitCfg<HD>::T_SMEM));
}

template <bool POS, bool QPOS>
int launch(const FlashArgs& a, int path, int hd) {
  if (path == 0) return launch_split_hd<POS, QPOS, false>(a, hd);
  if (path == 2) return launch_split_hd<POS, QPOS, true>(a, hd);
  return hd == 256 ? launch_wgmma<256, POS, QPOS>(a)
         : hd == 128 ? launch_wgmma<128, POS, QPOS>(a)
         : hd == 80 ? launch_wgmma<80, POS, QPOS>(a) : launch_wgmma<64, POS, QPOS>(a);
}

}  // namespace

// The launches with query positions (QPOS) are instantiated in a
// translation unit of their own, flash_qpos.cu, which includes this file
// with FLASH_QPOS_UNIT defined: nvcc compiles the two halves of the
// kernels side by side.
extern "C" int repro_flash_fwd_bf16_qpos(const FlashArgs* a, int path, int hd, int key_positions);

#ifdef FLASH_QPOS_UNIT
extern "C" int repro_flash_fwd_bf16_qpos(const FlashArgs* a, int path, int hd,
                                         int key_positions) {
  return key_positions ? launch<true, true>(*a, path, hd) : launch<false, true>(*a, path, hd);
}
#else
// path 0: the decode (split) path over `splits` KV splits; with splits > 1
// `ws` holds their partials and `counters` one zeroed int per (batch row,
// KV head, 16-row tile). path 2: the same over the TMA ring (STREAM), for
// (H / Hkv) x Sq x hd <= 512. path 1: the prefill (wgmma) path. out != nullptr:
// normalized bf16 output; otherwise acc/m/l receive the fp32 partial
// triple. q_pos: nullptr (query i of row b at q_offset[b] + i) or (B, Sq)
// int32 query positions (q_offset is then not read and may be nullptr).
// kv_pos: nullptr (key j at kv_offset + j) or (B, Skv) int32 key
// positions. One kernel launch per call.
extern "C" int repro_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                    const void* q_offset, const void* q_pos, const void* kv_pos,
                                    void* out,
                                    void* acc, void* m,
                                    void* l, void* ws, void* counters, int B, int H, int Hkv,
                                    int Sq, int Skv, int hd, int kv_offset, int causal,
                                    int window, float scale, int path, int splits,
                                    void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || H % Hkv ||
      (hd != 64 && hd != 80 && hd != 128 && hd != 256) || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (out == nullptr && (acc == nullptr || m == nullptr || l == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (q_offset == nullptr && q_pos == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (path < 0 || path > 2 || (path == 1 && (Sq + W_BM - 1) / W_BM > 65535))
    return static_cast<int>(cudaErrorInvalidValue);
  if (path != 1 && (splits < 1 || (splits > 1 && (ws == nullptr || counters == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  const FlashArgs a{q, k, v, static_cast<const int*>(q_offset), static_cast<const int*>(q_pos),
                    static_cast<const int*>(kv_pos), static_cast<__nv_bfloat16*>(out),
                    static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l),
                    static_cast<float*>(ws), static_cast<int*>(counters), B, H, Hkv, Sq, Skv,
                    kv_offset, causal, window, splits, scale,
                    static_cast<cudaStream_t>(stream)};
  if (q_pos != nullptr) return repro_flash_fwd_bf16_qpos(&a, path, hd, kv_pos != nullptr);
  return kv_pos != nullptr ? launch<true, false>(a, path, hd) : launch<false, false>(a, path, hd);
}

// The number of blocks of the path-2 (STREAM) kernel at head size hd that
// one SM of the current device holds, into *blocks: the planner's
// (kernels/flash/flash.py::plan) count of the blocks that fill one wave.
extern "C" int repro_flash_stream_blocks(int hd, int* blocks) {
  if (blocks == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 64: return stream_blocks<64>(blocks);
    case 80: return stream_blocks<80>(blocks);
    case 128: return stream_blocks<128>(blocks);
    case 256: return stream_blocks<256>(blocks);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
#endif
