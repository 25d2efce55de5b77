// Grouped matmul (GMM) for the MoE expert FFN, bf16 in, fp32 accumulation,
// bf16 out, for sm_90a.
//
// Replaces the Pallas TPU kernel `gmm` / `_gmm_kernel` in
// src/repro/kernels/gmm/gmm.py:
//     y[i*bm:(i+1)*bm] = x[i*bm:(i+1)*bm] @ w[block_expert[i]]
// x (M, K) rows grouped by expert, w (E, K, N), block_expert (M/bm,) int32,
// y (M, N). All row-major and contiguous.
//
// What bounds it on an H100: at decode the row count is tiny (M = E * 128
// padded rows, of which only a handful are real tokens), so each launch
// streams every used expert's K x N weight matrix from device memory once
// and does ~0.6 flop per weight byte: it is bound by memory bandwidth
// (3.35 TB/s), not by the tensor cores (989 TFLOP/s bf16).
//
// Design. One thread block per 128 x 128 output tile. The TPU kernel's
// scalar prefetch of block_expert becomes one load by the block itself, and
// the TPU grid's sequential K axis becomes a loop inside the block, since
// Hopper blocks carry nothing from one to the next. The K loop streams
// 128 x 32 tiles of x and 32 x 128 tiles of w through a 3-stage cp.async
// ring in shared memory, so two tiles are in flight while the tensor cores
// (mma.sync through nvcuda::wmma, 16 x 16 x 16 bf16) work on the third;
// that keeps enough bytes outstanding per SM to stream the weights. Each of
// the 8 warps owns a 32 x 64 sub-tile in fp32 accumulator fragments. The
// epilogue stages each 16 x 16 fragment through shared memory and writes
// 16 bytes per lane. wgmma/TMA are left for a later change.
//
// Requires bm % 128 == 0, M % bm == 0, K % 32 == 0, N % 128 == 0 and
// 16-byte aligned pointers; the wrapper (kernels/gmm/gmm.py) checks them.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int STAGES = 3;
constexpr int THREADS = 256;                 // 8 warps: 4 (rows) x 2 (cols)
constexpr int A_LD = BK + 8;                 // padded smem rows (bf16 elements)
constexpr int B_LD = BN + 8;
constexpr int A_TILE = BM * A_LD;
constexpr int B_TILE = BK * B_LD;
constexpr int SMEM_BYTES = STAGES * (A_TILE + B_TILE) * 2;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(THREADS)
gmm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ w,
                const int* __restrict__ block_expert,
                __nv_bfloat16* __restrict__ y, int K, int N, int bm, int E) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Bs = As + STAGES * A_TILE;

  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int e = block_expert[row0 / bm];
  if (e < 0 || e >= E) __trap();              // never read another expert's rows
  const __nv_bfloat16* xa = x + static_cast<size_t>(row0) * K;
  const __nv_bfloat16* wb = w + static_cast<size_t>(e) * K * N + col0;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2;                    // warp rows [wm*32, wm*32+32)
  const int wn = warp % 2;                    // warp cols [wn*64, wn*64+64)

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * BK;
    __nv_bfloat16* a = As + stage * A_TILE;
    __nv_bfloat16* b = Bs + stage * B_TILE;
    for (int c = tid; c < BM * (BK / 8); c += THREADS) {
      const int r = c / (BK / 8), cc = (c % (BK / 8)) * 8;
      cp_async16(a + r * A_LD + cc, xa + static_cast<size_t>(r) * K + k0 + cc);
    }
    for (int c = tid; c < BK * (BN / 8); c += THREADS) {
      const int r = c / (BN / 8), cc = (c % (BN / 8)) * 8;
      cp_async16(b + r * B_LD + cc, wb + static_cast<size_t>(k0 + r) * N + cc);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int KT = K / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();                          // tile kt landed; tile kt-1 consumed
    const int nk = kt + STAGES - 1;
    if (nk < KT) load_stage(nk % STAGES, nk);
    cp_async_commit();

    const __nv_bfloat16* a = As + (kt % STAGES) * A_TILE;
    const __nv_bfloat16* b = Bs + (kt % STAGES) * B_TILE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], a + (wm * 32 + i * 16) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], b + kk * B_LD + wn * 64 + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                            // ring no longer read: reuse it

  float* stage = reinterpret_cast<float*>(smem_raw) + warp * 256;
  const int lane = tid % 32;
  const int r = lane / 2, c = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      __align__(16) __nv_bfloat16 out[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) out[t] = __float2bfloat16(stage[r * 16 + c + t]);
      const size_t row = static_cast<size_t>(row0 + wm * 32 + i * 16 + r);
      *reinterpret_cast<uint4*>(y + row * N + col0 + wn * 64 + j * 16 + c) =
          *reinterpret_cast<const uint4*>(out);
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" int repro_gmm_bf16(const void* x, const void* w, const void* block_expert,
                              void* y, int M, int K, int N, int bm, int E,
                              void* stream) {
  if (M <= 0 || bm <= 0 || bm % BM || M % bm || K % BK || N % BN || E <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // Per device, so set on every call (it costs far less than the launch).
  const cudaError_t err = cudaFuncSetAttribute(
      gmm_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(N / BN, M / BM);
  gmm_bf16_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const int*>(block_expert), static_cast<__nv_bfloat16*>(y), K, N, bm, E);
  return static_cast<int>(cudaGetLastError());
}
