// Grouped matmul (GMM) for the MoE expert FFN, bf16 in, fp32 accumulation,
// bf16 out, for sm_90a (Hopper: TMA, mbarrier, wgmma).
//
// Replaces the Pallas TPU kernel `gmm` / `_gmm_kernel` in
// src/repro/kernels/gmm/gmm.py:
//     y[i*bm:(i+1)*bm] = x[i*bm:(i+1)*bm] @ w[block_expert[i]]
// x (M, K) rows grouped by expert, w (E, K, N), block_expert (M/bm,) int32,
// y (M, N). All row-major and contiguous.
//
// What bounds it on an H100: at decode every expert owns one 128-row block
// of which a handful of rows are real tokens, so a launch streams all E
// K x N weight matrices from device memory once at ~0.6 flop per weight
// byte: it is bound by memory bandwidth (3.35 TB/s). At prefill or
// training sizes (1024 rows per expert) it is bound by the tensor cores
// (989 TFLOP/s bf16).
//
// Design. The TPU grid's sequential K axis becomes a loop inside the block
// and its scalar prefetch of block_expert one load per tile.
// - Persistent grid: min(#SMs, #tiles) blocks, each walking BM x BN output
//   tiles with a stride. Tiles are ordered in groups of the row tiles that
//   one expert owns when the experts own equal spans (ceil(M/bm / E) blocks
//   of bm rows), row tile fastest: at 1024 rows per expert the blocks
//   running together share that expert's weight columns in L2; at decode
//   (one block per expert) a group is one row tile, so they share its x rows
//   and read one expert's weight rows side by side.
// - Loads through TMA with 128-byte swizzle: an x tile (BM x 64, K
//   innermost) and BN/64 w tiles (64 x 64, N innermost, from the 2-D view
//   (E*K, N)) per stage into a STAGES-deep ring, each stage guarded by a
//   "full" mbarrier (TMA transaction bytes) and an "empty" one (one arrival
//   per consumer warp). There is no __syncthreads in the K loop.
// - Warp specialisation: one producer thread issues the loads (its
//   warpgroup drops to 40 registers); two consumer warpgroups issue
//   wgmma.mma_async m64nWNk16 from shared memory with fp32 accumulators in
//   registers. x is K-major A; the w tile is MN-major B (N contiguous,
//   transpose bit set, LBO = stride between 64-column swizzle atoms, SBO =
//   stride between 8-row groups), so the weights keep their (E, K, N)
//   layout. One wgmma group stays in flight while the next stage is
//   awaited; the stage before it is released.
// - Epilogue: each consumer warp converts its 16 rows to bf16 in a private
//   strip of shared memory and writes 16 bytes per lane, while the producer
//   already loads the next tile.
// - Tiles: BM = 128 (each consumer warpgroup owns 64 rows) when
//   bm % 128 == 0, else BM = 64 (the warpgroups split the columns); BN = 256
//   when N % 256 == 0, unless 128-column tiles fill the SMs' waves over a
//   tenth better. The host (kernels/gmm/gmm.py::tile_shape) chooses; both
//   can be forced for measurement.
// - L2 hints: weights evict_first (at decode each is read once), x
//   evict_last (every column tile of its row block reads it again).
//
// Measured on an H100 80GB HBM3 at 700 W (launch/bench_gmm.py; PERF.md):
// 128 x 256 is the fastest tile at M = 8192 by 12-40% and within
// 1% of the fastest for the decode gate/up launch, but for the decode down
// launch (192 wide tiles: two waves on 132 SMs, 73% full) 128 x 128 is 3%
// faster, hence the choice by wave fill. The hints gain ~5% at decode and
// ~9% at M = 8192 over none. At decode, groups of one row tile gain ~2%
// over groups of 8, but at M = 8192 they cost 1.8x: there a group must be
// one expert's span, hence the group size from M, bm and E. A 2-block
// cluster sharing the x tile by TMA multicast was slower (0.82 ms instead
// of 0.57 at decode) and was dropped; so was releasing each stage only
// after its own wgmma finished.
//
// Transposed weights (trans_w, the dgrad dx = dy @ w[e]^T of training;
// the TPU package has no backward kernel, its einsum gradients run in XLA):
// y (M, N) = x (M, K) @ w[e]^T for w (E, N, K). The same kernel with the w
// tile K-major, like A: TMA boxes of 64 rows of w[e] (output columns) x 64
// of its columns (K) from the 2-D view (E*N, K), the same 128 B swizzle,
// SBO = 1024 B, imm-trans-b = 0. No copy of w is made.
//
// Row blocks that 64 does not divide (bm any multiple of 8; the TPU kernel
// takes any bm with M % bm == 0): a wgmma tile is 64 rows, so with the
// tokens on its M side it would span row blocks of other experts. A second
// kernel (gmm_swap_kernel below) swaps the operands: the weight's output
// columns take wgmma's 64-row side and the tokens of a run of one expert's
// row blocks its N side (8 to 128), so each weight strip is read once a run
// whatever bm; the same TMA ring, producer and consumer warpgroups. Such
// launches are small-M decode shapes, bound by the weight bytes.
//
// Requires M % bm == 0, K % 64 == 0, N % BN == 0 (BN = 128 for the swap-AB
// kernel), bm % BM == 0 for the TMA kernel, bm % 8 == 0, and 16-byte
// aligned pointers; the wrapper checks them and this entry point again.
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int BK = 64;                    // 64 bf16 = 128 B, the swizzle span
constexpr int CONSUMER_WARPS = 8;         // two warpgroups
constexpr int THREADS = 32 * CONSUMER_WARPS + 128;   // + the producer warpgroup
constexpr int W_BOX_BYTES = BK * 64 * 2;  // one 64 x 64 w box: 8 KB
constexpr int EPI_LD = 72;                // epilogue strip row: 64 bf16 + pad
constexpr int EPI_BYTES = CONSUMER_WARPS * 16 * EPI_LD * 2;

template <int BM, int BN>
struct Cfg {
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int FIT = (SMEM_LIMIT - 1024 - EPI_BYTES - 256) / STAGE_BYTES;
  static constexpr int STAGES = FIT > 8 ? 8 : FIT;
  static constexpr int WN = BM == 128 ? BN : BN / 2;   // columns per consumer warpgroup
  // 1024 B of slack to align the ring to the swizzle atom, then the ring,
  // the epilogue strips, and 2 mbarriers per stage.
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + EPI_BYTES + 16 * STAGES;
  static_assert(SMEM <= SMEM_LIMIT, "tile does not fit shared memory");
};

// An L2 eviction policy: evict_first for data read once, evict_last for
// data that later tiles read again.
template <bool FIRST>
__device__ __forceinline__ uint64_t l2_policy() {
  uint64_t p;
  if (FIRST)
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  else
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1, {%3, %4}], [%2], %5;\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
        "l"(policy)
      : "memory");
}

// wgmma.mma_async m64nNk16, bf16 x bf16 -> fp32, both operands from shared
// memory: A K-major (TA = imm-trans-a = 0) or MN-major (TA = 1); B MN-major
// (TB = imm-trans-b = 1) or K-major (TB = 0); the accumulators are
// overwritten when scale_d == 0.
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  template <int TB, int TA = 0>
  __device__ static __forceinline__ void mma(float (&d)[4], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, %4, %5, "
        "p, 1, 1, %8, %7;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TB), "n"(TA));
  }
};

template <>
struct Wgmma<16> {
  template <int TB, int TA = 0>
  __device__ static __forceinline__ void mma(float (&d)[8], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %12, %11;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TB), "n"(TA));
  }
};

template <>
struct Wgmma<32> {
  template <int TB, int TA = 0>
  __device__ static __forceinline__ void mma(float (&d)[16], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, %20, %19;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TB), "n"(TA));
  }
};

template <>
struct Wgmma<64> {
  template <int TB, int TA = 0>
  __device__ static __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %36, %35;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TB), "n"(TA));
  }
};

template <>
struct Wgmma<128> {
  template <int TB, int TA = 0>
  __device__ static __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %68, %67;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TB), "n"(TA));
  }
};

template <>
struct Wgmma<256> {
  template <int TB, int TA = 0>
  __device__ static __forceinline__ void mma(float (&d)[128], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, %132, %131;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TB), "n"(TA));
  }
};


// Output tile t of the persistent walk -> (row block, column tile): groups
// of `group` row blocks, row block fastest within a group.
__device__ __forceinline__ void tile_coords(int t, int n_mb, int n_nb, int group, int& mb,
                                            int& nb) {
  const int per_group = group * n_nb;
  const int g = t / per_group;
  const int first = g * group;
  const int gm = min(group, n_mb - first);
  const int local = t - g * per_group;
  mb = first + local % gm;
  nb = local / gm;
}

template <int BM, int BN, bool TRANS_W>
__global__ void __launch_bounds__(THREADS, 1)
gmm_bf16_kernel(const __grid_constant__ CUtensorMap x_map,
                const __grid_constant__ CUtensorMap w_map,
                const int* __restrict__ block_expert, __nv_bfloat16* __restrict__ y,
                int M, int K, int N, int bm, int E, int group) {
  using C = Cfg<BM, BN>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t a_ring = base;                          // STAGES x (BM x 64)
  const uint32_t b_ring = base + STAGES * C::A_BYTES;    // STAGES x BN/64 x (64 x 64)
  __nv_bfloat16* epi = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + (base - raw) + STAGES * C::STAGE_BYTES);
  const uint32_t full = base + STAGES * C::STAGE_BYTES + EPI_BYTES;
  const uint32_t empty = full + 8 * STAGES;

  const int n_mb = M / BM, n_nb = N / BN, n_tiles = n_mb * n_nb, KT = K / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == CONSUMER_WARPS && lane == 0) {
      const uint64_t keep = l2_policy<false>(), stream = l2_policy<true>();
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        int mb, nb;
        tile_coords(t, n_mb, n_nb, group, mb, nb);
        const int row0 = mb * BM;
        const int e = block_expert[row0 / bm];
        if (e < 0 || e >= E) __trap();          // never read another expert's rows
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(empty + 8 * stage, phase ^ 1);
          const uint32_t bar = full + 8 * stage;
          mbar_expect_tx(bar, C::STAGE_BYTES);
          tma_load(a_ring + stage * C::A_BYTES, &x_map, bar, kt * BK, row0, keep);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j) {
            const uint32_t dst = b_ring + stage * C::B_BYTES + j * W_BOX_BYTES;
            if (TRANS_W)   // 64 rows of w[e] (output columns) x 64 of its columns (K)
              tma_load(dst, &w_map, bar, kt * BK, e * N + nb * BN + j * 64, stream);
            else           // 64 rows of w[e] (K) x 64 of its columns (output columns)
              tma_load(dst, &w_map, bar, nb * BN + j * 64, e * K + kt * BK, stream);
          }
          if (++stage == STAGES) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    constexpr int WN = C::WN;
    const int wg = warp / 4;
    const int m_off = BM == 128 ? wg * 64 : 0;         // this warpgroup's rows
    const int n_off = BM == 128 ? 0 : wg * WN;         // and columns in the tile
    __nv_bfloat16* strip = epi + warp * 16 * EPI_LD;
    float acc[WN / 2];
#pragma unroll
    for (int i = 0; i < WN / 2; ++i) acc[i] = 0.f;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      int mb, nb;
      tile_coords(t, n_mb, n_nb, group, mb, nb);
      int prev = -1;
      for (int kt = 0; kt < KT; ++kt) {
        mbar_wait(full + 8 * stage, phase);
        const uint32_t a = a_ring + stage * C::A_BYTES + m_off * 128;
        const uint32_t b = b_ring + stage * C::B_BYTES + (n_off / 64) * W_BOX_BYTES;
        fence_regs(acc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          if (TRANS_W)   // K-major B: like A, 16 K values = 32 B along each 128 B row
            Wgmma<WN>::template mma<0>(acc, sw128_desc(a + kk * 32, 16, 1024),
                                       sw128_desc(b + kk * 32, 16, 1024), kt | kk);
          else           // MN-major B: 16 K rows of 128 B, 64-column atoms W_BOX_BYTES apart
            Wgmma<WN>::template mma<1>(acc, sw128_desc(a + kk * 32, 16, 1024),
                                       sw128_desc(b + kk * 16 * 128, W_BOX_BYTES, 1024),
                                       kt | kk);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        fence_regs(acc);
        if (prev >= 0 && lane == 0) mbar_arrive(empty + 8 * prev);   // its wgmma are done
        prev = stage;
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty + 8 * prev);

      // Epilogue: this warp's 16 rows, 64 columns at a time, through its strip.
      const int row = mb * BM + m_off + (warp % 4) * 16;
      const int col = nb * BN + n_off;
#pragma unroll
      for (int c = 0; c < WN / 64; ++c) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = c * 8 + jj;
          __nv_bfloat16* p = strip + (lane / 4) * EPI_LD + jj * 8 + 2 * (lane % 4);
          *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
          *reinterpret_cast<__nv_bfloat162*>(p + 8 * EPI_LD) =
              __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
        }
        __syncwarp();
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = (i * 32 + lane) / 8, cc = (lane % 8) * 8;
          *reinterpret_cast<uint4*>(y + static_cast<size_t>(row + r) * N + col + c * 64 + cc) =
              *reinterpret_cast<const uint4*>(strip + r * EPI_LD + cc);
        }
        __syncwarp();
      }
    }
  }
}

// Row-major (outer, inner) bf16 matrix, boxes of (box_outer, 64), 128 B swizzle.
bool encode(CUtensorMap* map, const void* ptr, uint64_t outer, uint64_t inner,
            uint32_t box_outer) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * 2};
  const cuuint32_t box[2] = {64, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BM, int BN, bool TRANS_W>
int launch(const void* x, const void* w, const int* be, __nv_bfloat16* y, int M, int K,
           int N, int bm, int E, cudaStream_t stream) {
  using C = Cfg<BM, BN>;
  static bool attr_set[MAX_DEVICES];     // per device, per tile shape: set once
  static int n_sms[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(gmm_bf16_kernel<BM, BN, TRANS_W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&n_sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set[dev] = true;
  }
  CUtensorMap x_map, w_map;
  // w as a row-major 2-D matrix: (E*K, N), or (E*N, K) when transposed.
  if (!encode(&x_map, x, M, K, BM) ||
      !encode(&w_map, w, static_cast<uint64_t>(E) * (TRANS_W ? N : K), TRANS_W ? K : N, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (M / BM) * (N / BN);
  const int grid = n_tiles < n_sms[dev] ? n_tiles : n_sms[dev];
  // Walk together the row tiles that share one expert's weights when the
  // experts own equal spans: ceil(row blocks / E) blocks of bm rows.
  const int blocks = M / bm;
  const int group = (blocks + E - 1) / E * (bm / BM);
  gmm_bf16_kernel<BM, BN, TRANS_W><<<grid, THREADS, C::SMEM, stream>>>(x_map, w_map, be, y, M,
                                                                       K, N, bm, E, group);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Row blocks that 64 does not divide (bm any multiple of 8): swap-AB.
//
// A wgmma tile is 64 rows deep, deeper than such a row block. So the
// weight's output columns take wgmma's M side and the tokens its N side
// (any multiple of 8): the accumulators hold y^T. A tile is 128 output
// columns (64 a consumer warpgroup) of a window of G row blocks; the window
// is cut into runs of one expert (neighbouring blocks of another expert end
// a run, found from block_expert on the device), each run into passes of
// at most P rows, P = the wgmma's N. A pass streams its expert's weight
// strip over K once and multiplies each K tile with the pass's x tile, so
// a run of up to P rows reads each weight strip once, whatever bm.
// - Operands: forward, the (K, N) weight box (64 K rows x 64 columns, N
//   innermost, from the 2-D view (E*K, N)) is an MN-major A (imm-trans-a
//   1, the layout of the TMA kernel's B); trans_w, w[e]'s (N, K) rows are a
//   K-major A, like the TMA kernel's x. The x box (P rows x 64 of K) is a
//   K-major B. All through TMA with 128-byte swizzle.
// - Ring, producer, consumers as in the TMA kernel: one producer thread
//   fills a STAGES-deep ring (full / empty mbarriers; no __syncthreads in the
//   K loop) and runs ahead into the next pass and tile; two consumer
//   warpgroups keep one wgmma group in flight and release the stage before.
//   Persistent grid over (window, column strip) tiles, strips of one window
//   fastest; windows of one expert's run together when runs span several.
// - Epilogue: each warp turns its 16 columns x P tokens of y^T into y's rows
//   through a strip of shared memory, 32 tokens at a time, and stores 16
//   bytes a lane; rows past the pass's end (the x box reaches into the next
//   run, or past M, where TMA fills zeros) are computed but never stored.
// - P and G: the wrapper estimates one expert's run as run blocks, the
//   experts owning equal spans (kernels/gmm/gmm.py::run_blocks), and passes
//   it in. P (tile_shape) is the smallest of 8, 16, 32, 64, 128 that holds
//   such a run (at decode one block: bm rounded up to a power of two), else
//   128; G = run when the run fits in P, else P / bm. Any block_expert is
//   right: a shorter run only computes rows it does not store.
//
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 3; the rows
// of PERF.md section 6), Mixtral's decode gate/up, x (8*bm, 6144), w (8,
// 6144, 16384), one block an expert, at bm 8 / 16 / 24 / 32: 0.5093 /
// 0.5087 / 0.5141 / 0.5215 ms, 93-94% of the byte bound (0.4816-0.4842),
// against torch.bmm's 0.5111 / 0.5134 / 0.5155 / 0.5161 in the same run;
// the trans_w dgrad 0.5105-0.5237 against 0.5333-0.5398. The mma.sync
// kernel it replaced (16- or 8-row tiles from a cp.async ring, one column
// strip's row tiles each reading its weights) took 0.5450 / 0.5498 / - /
// 0.7635 in an earlier run of the same script: at bm 32 two row tiles read
// each weight strip.
constexpr int SW_BN = 128;                      // output columns a tile
constexpr int SW_W_BYTES = 2 * W_BOX_BYTES;     // its weight tile a K step: 16 KB
constexpr int SW_TOK = 32;                      // tokens an epilogue chunk
constexpr int SW_LD = 24;                       // bf16 pitch of a chunk row: 16 columns + pad
constexpr int SW_EPI_BYTES = CONSUMER_WARPS * SW_TOK * SW_LD * 2;

template <int P>
struct SwapCfg {
  static constexpr int X_BYTES = P * BK * 2;    // P token rows x 64 of K
  static constexpr int STAGE_BYTES = SW_W_BYTES + X_BYTES;
  static constexpr int FIT = (SMEM_LIMIT - 1024 - SW_EPI_BYTES - 256) / STAGE_BYTES;
  static constexpr int STAGES = FIT > 12 ? 12 : FIT;
  static constexpr int TOK = P < SW_TOK ? P : SW_TOK;
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + SW_EPI_BYTES + 16 * STAGES;
  static_assert(SMEM <= SMEM_LIMIT, "ring does not fit shared memory");
};

// The passes of one tile's window of row blocks [win*G, min(win*G + G, n_blocks)):
// runs of one expert, each cut into passes of at most P rows.
template <int P>
struct Passes {
  const int* be;
  int b, b_end, bm, expert, row, run_end;
  __device__ Passes(const int* be_, int win, int G, int n_blocks, int bm_)
      : be(be_), b(win * G), b_end(min(win * G + G, n_blocks)), bm(bm_), expert(0),
        row(0), run_end(0) {}
  // The next pass (its expert, first row and rows); false past the window.
  __device__ __forceinline__ bool next(int& e, int& row0, int& rows) {
    if (row >= run_end) {
      if (b >= b_end) return false;
      expert = be[b];
      int b2 = b + 1;
      while (b2 < b_end && be[b2] == expert) ++b2;
      row = b * bm;
      run_end = b2 * bm;
      b = b2;
    }
    e = expert;
    row0 = row;
    rows = min(P, run_end - row);
    row += P;
    return true;
  }
};

template <int P, bool TRANS_W>
__global__ void __launch_bounds__(THREADS, 1)
gmm_swap_kernel(const __grid_constant__ CUtensorMap x_map,
                const __grid_constant__ CUtensorMap w_map,
                const int* __restrict__ block_expert, __nv_bfloat16* __restrict__ y,
                int M, int K, int N, int bm, int E, int G, int group) {
  using C = SwapCfg<P>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t w_ring = base;                          // STAGES x 2 x (64 x 64)
  const uint32_t x_ring = base + STAGES * SW_W_BYTES;    // STAGES x (P x 64)
  __nv_bfloat16* epi = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + (base - raw) + STAGES * C::STAGE_BYTES);
  const uint32_t full = base + STAGES * C::STAGE_BYTES + SW_EPI_BYTES;
  const uint32_t empty = full + 8 * STAGES;

  const int n_blocks = M / bm, n_win = (n_blocks + G - 1) / G, n_strips = N / SW_BN;
  const int n_tiles = n_win * n_strips, KT = K / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == CONSUMER_WARPS && lane == 0) {
      const uint64_t keep = l2_policy<false>(), stream = l2_policy<true>();
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        int win, strip;
        tile_coords(t, n_win, n_strips, group, win, strip);
        const int col0 = strip * SW_BN;
        Passes<P> passes(block_expert, win, G, n_blocks, bm);
        int e, row0, rows;
        while (passes.next(e, row0, rows)) {
          if (e < 0 || e >= E) __trap();        // never read another expert's rows
          for (int kt = 0; kt < KT; ++kt) {
            mbar_wait(empty + 8 * stage, phase ^ 1);
            const uint32_t bar = full + 8 * stage;
            mbar_expect_tx(bar, C::STAGE_BYTES);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const uint32_t dst = w_ring + stage * SW_W_BYTES + j * W_BOX_BYTES;
              if (TRANS_W)   // 64 rows of w[e] (output columns) x 64 of its columns (K)
                tma_load(dst, &w_map, bar, kt * BK, e * N + col0 + j * 64, stream);
              else           // 64 rows of w[e] (K) x 64 of its columns (output columns)
                tma_load(dst, &w_map, bar, col0 + j * 64, e * K + kt * BK, stream);
            }
            tma_load(x_ring + stage * C::X_BYTES, &x_map, bar, kt * BK, row0, keep);
            if (++stage == STAGES) { stage = 0; phase ^= 1; }
          }
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    constexpr int TOK = C::TOK;
    const int wg = warp / 4;
    __nv_bfloat16* strip_s = epi + warp * SW_TOK * SW_LD;
    float acc[P / 2];
#pragma unroll
    for (int i = 0; i < P / 2; ++i) acc[i] = 0.f;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      int win, strip;
      tile_coords(t, n_win, n_strips, group, win, strip);
      const int col = strip * SW_BN + wg * 64 + (warp % 4) * 16;   // this warp's 16 columns
      Passes<P> passes(block_expert, win, G, n_blocks, bm);
      int e, row0, rows;
      while (passes.next(e, row0, rows)) {
        int prev = -1;
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(full + 8 * stage, phase);
          const uint32_t a = w_ring + stage * SW_W_BYTES + wg * W_BOX_BYTES;
          const uint32_t b = x_ring + stage * C::X_BYTES;
          fence_regs(acc);
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            const uint64_t bd = sw128_desc(b + kk * 32, 16, 1024);   // 16 K values = 32 B a row
            if (TRANS_W)   // K-major A: w[e]'s rows, 16 K values along each 128 B row
              Wgmma<P>::template mma<0, 0>(acc, sw128_desc(a + kk * 32, 16, 1024), bd, kt | kk);
            else           // MN-major A: 16 K rows of 128 B, one 64-column atom
              Wgmma<P>::template mma<0, 1>(acc, sw128_desc(a + kk * 16 * 128, W_BOX_BYTES, 1024),
                                           bd, kt | kk);
          }
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
          fence_regs(acc);
          if (prev >= 0 && lane == 0) mbar_arrive(empty + 8 * prev);   // its wgmma are done
          prev = stage;
          if (++stage == STAGES) { stage = 0; phase ^= 1; }
        }
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_regs(acc);
        if (lane == 0) mbar_arrive(empty + 8 * prev);

        // Epilogue: acc[4j + {0,1}] = y^T[lane/4][8j + 2(lane%4) + {0,1}], acc[4j + {2,3}]
        // the same tokens of column lane/4 + 8; TOK tokens at a time through the strip.
#pragma unroll
        for (int c = 0; c < P / TOK; ++c) {
          if (c * TOK >= rows) break;
#pragma unroll
          for (int jj = 0; jj < TOK / 8; ++jj) {
            const int j = c * (TOK / 8) + jj;
            __nv_bfloat16* p = strip_s + (jj * 8 + 2 * (lane % 4)) * SW_LD + lane / 4;
            p[0] = __float2bfloat16_rn(acc[4 * j]);
            p[SW_LD] = __float2bfloat16_rn(acc[4 * j + 1]);
            p[8] = __float2bfloat16_rn(acc[4 * j + 2]);
            p[SW_LD + 8] = __float2bfloat16_rn(acc[4 * j + 3]);
          }
          __syncwarp();
#pragma unroll
          for (int i = lane; i < 2 * TOK; i += 32) {   // a token row's 16 columns: two 16 B halves
            const int r = c * TOK + i / 2;
            if (r < rows)
              *reinterpret_cast<uint4*>(y + static_cast<size_t>(row0 + r) * N + col + (i % 2) * 8) =
                  *reinterpret_cast<const uint4*>(strip_s + (i / 2) * SW_LD + (i % 2) * 8);
          }
          __syncwarp();
        }
      }
    }
  }
}

template <int P, bool TRANS_W>
int launch_swap(const void* x, const void* w, const int* be, __nv_bfloat16* y, int M, int K,
                int N, int bm, int E, int run, cudaStream_t stream) {
  using C = SwapCfg<P>;
  static bool attr_set[MAX_DEVICES];
  static int n_sms[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(gmm_swap_kernel<P, TRANS_W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&n_sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set[dev] = true;
  }
  CUtensorMap x_map, w_map;
  if (!encode(&x_map, x, M, K, P) ||
      !encode(&w_map, w, static_cast<uint64_t>(E) * (TRANS_W ? N : K), TRANS_W ? K : N, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  // A window is one expert's run (run blocks, the wrapper's estimate, from
  // which it also chose P) when it fits a pass, else P rows' worth of
  // blocks; the windows of one run go together.
  const int blocks = M / bm;
  const int G = run * bm <= P ? run : (P > bm ? P / bm : 1);
  const int n_win = (blocks + G - 1) / G, group = (run + G - 1) / G;
  const int n_tiles = n_win * (N / SW_BN);
  const int grid = n_tiles < n_sms[dev] ? n_tiles : n_sms[dev];
  gmm_swap_kernel<P, TRANS_W><<<grid, THREADS, C::SMEM, stream>>>(x_map, w_map, be, y, M, K,
                                                                   N, bm, E, G, group);
  return static_cast<int>(cudaGetLastError());
}

// The swap-AB kernel for bm % 64 != 0 or a forced pass of fewer than 64 rows
// (block_m = P); else the TMA kernel's (block_m, block_n) tile.
bool swap_ab(int bm, int block_m) { return bm % 64 != 0 || block_m < 64; }

template <bool TRANS_W>
int dispatch(const void* x, const void* w, const int* be, __nv_bfloat16* y, int M, int K,
             int N, int bm, int E, int block_m, int block_n, int run, cudaStream_t s) {
  if (swap_ab(bm, block_m)) {
    switch (block_m) {
      case 8: return launch_swap<8, TRANS_W>(x, w, be, y, M, K, N, bm, E, run, s);
      case 16: return launch_swap<16, TRANS_W>(x, w, be, y, M, K, N, bm, E, run, s);
      case 32: return launch_swap<32, TRANS_W>(x, w, be, y, M, K, N, bm, E, run, s);
      case 64: return launch_swap<64, TRANS_W>(x, w, be, y, M, K, N, bm, E, run, s);
      default: return launch_swap<128, TRANS_W>(x, w, be, y, M, K, N, bm, E, run, s);
    }
  }
  if (block_m == 128)
    return block_n == 256 ? launch<128, 256, TRANS_W>(x, w, be, y, M, K, N, bm, E, s)
                          : launch<128, 128, TRANS_W>(x, w, be, y, M, K, N, bm, E, s);
  return block_n == 256 ? launch<64, 256, TRANS_W>(x, w, be, y, M, K, N, bm, E, s)
                        : launch<64, 128, TRANS_W>(x, w, be, y, M, K, N, bm, E, s);
}

}  // namespace

// y (M, N) = x (M, K) @ w[e], w (E, K, N); with trans_w, y = x @ w[e]^T for
// w (E, N, K) (the dgrad of the forward product). run: the row blocks of one
// expert's run when the experts own equal spans (kernels/gmm/gmm.py::
// run_blocks), the swap-AB kernel's window; the TMA kernel ignores it.
extern "C" int repro_gmm_bf16(const void* x, const void* w, const void* block_expert,
                              void* y, int M, int K, int N, int bm, int E, int block_m,
                              int block_n, int run, int trans_w, void* stream) {
  const bool tile_ok =
      swap_ab(bm, block_m)
          ? (block_m == 8 || block_m == 16 || block_m == 32 || block_m == 64 ||
             block_m == 128) && block_n == SW_BN
          : (block_m == 64 || block_m == 128) && (block_n == 128 || block_n == 256) &&
                bm % block_m == 0;
  if (M <= 0 || E <= 0 || bm <= 0 || bm % 8 || !tile_ok || M % bm || run <= 0 || K <= 0 ||
      K % BK || N % block_n || static_cast<int64_t>(E) * (trans_w ? N : K) > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* be = static_cast<const int*>(block_expert);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return trans_w ? dispatch<true>(x, w, be, out, M, K, N, bm, E, block_m, block_n, run, s)
                 : dispatch<false>(x, w, be, out, M, K, N, bm, E, block_m, block_n, run, s);
}
