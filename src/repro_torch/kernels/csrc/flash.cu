// Blockwise (flash) attention forward, bf16 in, fp32 online softmax, for
// sm_90a.
//
// Replaces the Pallas TPU kernel `flash_attention` / `_flash_kernel` in
// src/repro/kernels/flash/flash.py, and with it the jnp scan `_fwd_scan`
// (src/repro/models/attn_core.py) that the JAX serving path runs for its
// cache attention. Same contract:
//   q (B, H, Sq, hd), k/v (B, Hkv, Skv, hd), GQA head h reads KV head
//   h / (H / Hkv); query row i of batch row b sits at position
//   q_offset[b] + i, key j at kv_offset + j; causal and sliding-window
//   masks as flash.py:48-57 (NEG_INF = -1e30, p zeroed where not visible);
//   p is rounded to bf16 before the PV product (flash.py:67).
// Outputs: normalized o = acc / max(l, 1e-30) in bf16, or the fp32 partial
// triple (acc, m, l). q_offset is one int32 per batch row, so the batched
// decode step, whose rows sit at different positions, uses the same kernel.
//
// What bounds it on an H100: serving runs it with few query rows per head
// (1 at decode, <= one prefill chunk at prefill) against the whole cache, so
// it does ~1 flop per KV byte at decode and is bound by memory bandwidth;
// at the slice's sizes it is short enough that launch latency matters too.
//
// Design. One block of 4 warps per (query tile of 64 rows, head, batch
// row); each warp owns 16 query rows end to end, so the online softmax
// needs only warp-level synchronisation. The block loops over 64-row KV
// tiles in shared memory: S = Q K^T and O += P V run on the tensor cores
// (wmma 16 x 16 x 16 bf16, fp32 accumulate); the running max and sum live in
// registers (two lanes per row), the fp32 accumulator in shared memory.
// The repeated GQA KV is never materialized: every head indexes its KV
// head. KV tiles that the causal or window mask hides from every row of the
// query tile are skipped; such a tile is an exact no-op of the online
// softmax (corr = 1, p = 0), so results are identical. Ragged Sq and Skv
// are zero-filled and masked. Simple first: no cp.async/TMA pipelining yet.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;

template <int HD>
struct Layout {
  static constexpr int QK_LD = HD + 8;     // bf16 rows of Q, K, V tiles
  static constexpr int S_LD = BKV + 4;     // fp32 scores
  static constexpr int P_LD = BKV + 8;     // bf16 probabilities
  static constexpr int O_LD = HD + 4;      // fp32 accumulator
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + size_t(BQ) * QK_LD * 2;
  static constexpr size_t v_off = k_off + size_t(BKV) * QK_LD * 2;
  static constexpr size_t s_off = v_off + size_t(BKV) * QK_LD * 2;
  static constexpr size_t p_off = s_off + size_t(BQ) * S_LD * 4;
  static constexpr size_t o_off = p_off + size_t(BQ) * P_LD * 2;
  static constexpr size_t bytes = o_off + size_t(BQ) * O_LD * 4;
};

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ q_offset, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ acc_out, float* __restrict__ m_out,
                 float* __restrict__ l_out, int H, int Hkv, int Sq, int Skv,
                 int kv_offset, int causal, int window, float scale) {
  using L = Layout<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L::q_off);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L::k_off);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem + L::p_off);
  float* Os = reinterpret_cast<float*>(smem + L::o_off);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  constexpr int CH = HD / 8;                 // 16-byte chunks per row

  const __nv_bfloat16* qb = q + (static_cast<size_t>(b) * H + h) * Sq * HD;
  const __nv_bfloat16* kb = k + (static_cast<size_t>(b) * Hkv + hk) * Skv * HD;
  const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * Hkv + hk) * Skv * HD;
  const int q_off = q_offset[b];

  for (int c = tid; c < BQ * CH; c += THREADS) {
    const int r = c / CH, cc = (c % CH) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < Sq) val = *reinterpret_cast<const uint4*>(qb + static_cast<size_t>(q0 + r) * HD + cc);
    *reinterpret_cast<uint4*>(Qs + r * L::QK_LD + cc) = val;
  }
  for (int i = tid; i < BQ * L::O_LD; i += THREADS) Os[i] = 0.0f;

  // KV tiles some row of this query tile can see; the rest are exact no-ops.
  const int q_last = min(q0 + BQ, Sq) - 1;
  int kv_begin = 0, kv_end = Skv;
  if (causal) kv_end = min(Skv, q_off + q_last - kv_offset + 1);
  if (window) kv_begin = max(0, q_off + q0 - window + 1 - kv_offset);
  const int t_begin = kv_begin / BKV;
  const int t_end = kv_end > 0 ? (kv_end + BKV - 1) / BKV : 0;

  const int r = warp * 16 + lane / 2;        // the row this lane pair owns
  const int half = lane % 2;                 // which half of its columns
  const int q_pos = q_off + q0 + r;
  float m_run = NEG_INF, l_run = 0.0f;

  for (int t = t_begin; t < t_end; ++t) {
    const int kv0 = t * BKV;
    __syncthreads();                         // previous K/V tile consumed
    for (int c = tid; c < BKV * CH; c += THREADS) {
      const int rr = c / CH, cc = (c % CH) * 8;
      uint4 kval = make_uint4(0, 0, 0, 0), vval = make_uint4(0, 0, 0, 0);
      if (kv0 + rr < Skv) {
        const size_t off = static_cast<size_t>(kv0 + rr) * HD + cc;
        kval = *reinterpret_cast<const uint4*>(kb + off);
        vval = *reinterpret_cast<const uint4*>(vb + off);
      }
      *reinterpret_cast<uint4*>(Ks + rr * L::QK_LD + cc) = kval;
      *reinterpret_cast<uint4*>(Vs + rr * L::QK_LD + cc) = vval;
    }
    __syncthreads();

    {  // S = Q K^T for this warp's 16 rows
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf[BKV / 16];
#pragma unroll
      for (int j = 0; j < BKV / 16; ++j) wmma::fill_fragment(sf[j], 0.0f);
#pragma unroll
      for (int kk = 0; kk < HD; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, Qs + warp * 16 * L::QK_LD + kk, L::QK_LD);
#pragma unroll
        for (int j = 0; j < BKV / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, Ks + j * 16 * L::QK_LD + kk, L::QK_LD);
          wmma::mma_sync(sf[j], fa, fb, sf[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < BKV / 16; ++j)
        wmma::store_matrix_sync(Ss + warp * 16 * L::S_LD + j * 16, sf[j], L::S_LD,
                                wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax over this lane's 32 columns of row r.
    const float* srow = Ss + r * L::S_LD + half * 32;
    float sv[32];
    uint32_t vis_bits = 0;
    float m_cur = NEG_INF;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int kidx = kv0 + half * 32 + i;
      const int kpos = kv_offset + kidx;
      bool vis = kidx < Skv;
      if (causal) vis = vis && (q_pos >= kpos);
      if (window) vis = vis && (q_pos - kpos < window);
      const float s = vis ? srow[i] * scale : NEG_INF;
      vis_bits |= static_cast<uint32_t>(vis) << i;
      sv[i] = s;
      m_cur = fmaxf(m_cur, s);
    }
    m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 1));
    const float m_new = fmaxf(m_run, m_cur);
    __nv_bfloat16* prow = Ps + r * L::P_LD + half * 32;
    float lsum = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = ((vis_bits >> i) & 1u) ? expf(sv[i] - m_new) : 0.0f;
      prow[i] = __float2bfloat16(p);
      lsum += p;
    }
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    const float corr = expf(m_run - m_new);
    l_run = l_run * corr + lsum;
    m_run = m_new;
    float* orow = Os + r * L::O_LD + half * (HD / 2);
#pragma unroll 8
    for (int i = 0; i < HD / 2; ++i) orow[i] *= corr;
    __syncwarp();

    // O += P V for this warp's 16 rows.
#pragma unroll
    for (int n0 = 0; n0 < HD; n0 += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::load_matrix_sync(of, Os + warp * 16 * L::O_LD + n0, L::O_LD, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BKV; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
        wmma::load_matrix_sync(pa, Ps + warp * 16 * L::P_LD + kk, L::P_LD);
        wmma::load_matrix_sync(vf, Vs + kk * L::QK_LD + n0, L::QK_LD);
        wmma::mma_sync(of, pa, vf, of);
      }
      wmma::store_matrix_sync(Os + warp * 16 * L::O_LD + n0, of, L::O_LD, wmma::mem_row_major);
    }
    __syncwarp();
  }
  __syncthreads();                           // zero-fill visible when no tile ran

  if (q0 + r >= Sq) return;
  const size_t row = (static_cast<size_t>(b) * H + h) * Sq + q0 + r;
  const float* orow = Os + r * L::O_LD + half * (HD / 2);
  if (out != nullptr) {
    const float den = fmaxf(l_run, 1e-30f);
    __nv_bfloat16* o = out + row * HD + half * (HD / 2);
    for (int i = 0; i < HD / 2; ++i) o[i] = __float2bfloat16(orow[i] / den);
  } else {
    float* a = acc_out + row * HD + half * (HD / 2);
    for (int i = 0; i < HD / 2; ++i) a[i] = orow[i];
    if (half == 0) {
      m_out[row] = m_run;
      l_out[row] = l_run;
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* q_offset,
           void* out, void* acc, void* m, void* l, int B, int H, int Hkv, int Sq,
           int Skv, int kv_offset, int causal, int window, float scale,
           cudaStream_t stream) {
  // Per device, so set on every call (it costs far less than the launch).
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Layout<HD>::bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<HD><<<grid, THREADS, Layout<HD>::bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(q_offset),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), H, Hkv, Sq, Skv, kv_offset,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out != nullptr: normalized bf16 output. Otherwise acc/m/l receive the fp32
// partial triple.
extern "C" int repro_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                    const void* q_offset, void* out, void* acc,
                                    void* m, void* l, int B, int H, int Hkv, int Sq,
                                    int Skv, int hd, int kv_offset, int causal,
                                    int window, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || H % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  if (out == nullptr && (acc == nullptr || m == nullptr || l == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128)
    return launch<128>(q, k, v, q_offset, out, acc, m, l, B, H, Hkv, Sq, Skv,
                       kv_offset, causal, window, scale, s);
  if (hd == 64)
    return launch<64>(q, k, v, q_offset, out, acc, m, l, B, H, Hkv, Sq, Skv,
                      kv_offset, causal, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
