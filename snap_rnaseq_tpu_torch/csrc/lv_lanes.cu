// K1: LV-lanes — banded Landau-Vishkin distance with a per-row free
// prefix and the fused probability backtrace; five scalars out per row.
//
// Replaces the TPU kernel snap_rnaseq_tpu/ops/lv_pallas.py
// _lv_kernel_lanes_bits (reached through lv_distance_pallas_lanes), which
// score_phase (models/single.py) calls with both seed-split directions.
//
// What bounds it on an H100: neither bytes nor arithmetic throughput but
// latency and divergence.  Each row reads ~P + T bytes and writes 20, so
// at the main-path shape (P = 100, T = 116) ~10^4 rows move ~2.5 MB, a
// microsecond of HBM time; the work is a data-dependent DP of up to
// e_max levels x D diagonals with early exits, so lanes of a warp idle
// while the slowest row finishes.  Design: one candidate per thread (the
// TPU layout put candidates on lanes too); the rows staged in shared
// memory with coalesced loads; mismatches found four bytes at a time
// (XOR + __ffs) instead of the TPU kernel's (D, W, C) bit-mask scratch;
// the DP table kept per thread in local memory as int16 (L1-resident)
// for the backtrace, which runs in the same thread so only five scalars
// reach device memory.  A row stops at its winning level.
#include "lv_common.cuh"

namespace {

template <int MAXE>
__global__ void lv_lanes_kernel(const uint8_t* __restrict__ pattern,
                                const int* __restrict__ p_len,
                                const uint8_t* __restrict__ text,
                                const int* __restrict__ t_len,
                                const int* __restrict__ k,
                                const float* __restrict__ qlp,
                                const int* __restrict__ free_len,
                                const int* __restrict__ prio_g, int B, int P,
                                int T, int e_max, lvk::Consts cs,
                                int* __restrict__ dist,
                                int* __restrict__ e_fin,
                                int* __restrict__ d_fin,
                                float* __restrict__ logp,
                                int* __restrict__ net) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int D = 2 * e_max + 1;
  int* prio = reinterpret_cast<int*>(smem);
  uint8_t* rows = smem + lvk::round4(D * 4);
  const int sp = lvk::round4(P + lvk::ROW_SLACK);
  const int stride = sp + lvk::round4(e_max + T + lvk::ROW_SLACK);
  const int row0 = blockIdx.x * blockDim.x;
  const int nrows = min(static_cast<int>(blockDim.x), B - row0);
  for (int d = threadIdx.x; d < D; d += blockDim.x) prio[d] = prio_g[d];
  lvk::fill_rows(rows, stride, sp, pattern, P, text, T, t_len, e_max, row0,
                 nrows);
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= nrows) return;

  const int i = row0 + threadIdx.x;
  const uint8_t* pat = rows + threadIdx.x * stride;
  lvk::LocalTab<MAXE> tab;
  tab.D = D;
  int8_t acts[MAXE + 1];
  int16_t matched[MAXE + 1];
  const lvk::Result r = lvk::lv_one(
      pat, pat + sp, p_len[i], t_len[i], k[i], free_len ? free_len[i] : 0,
      e_max, prio, qlp ? qlp + (size_t)i * P : nullptr, cs, tab, acts,
      matched);
  dist[i] = r.dist;
  e_fin[i] = r.e_fin;
  d_fin[i] = r.d_fin;
  logp[i] = r.logp;
  net[i] = r.net;
}

template <int MAXE>
cudaError_t launch(const void* pattern, const void* p_len, const void* text,
                   const void* t_len, const void* k, const void* qlp,
                   const void* free_len, const void* prio, int B, int P,
                   int T, int e_max, lvk::Consts cs, void* dist, void* e_fin,
                   void* d_fin, void* logp, void* net, cudaStream_t stream) {
  const int D = 2 * e_max + 1;
  const int row_bytes = lvk::round4(P + lvk::ROW_SLACK) +
                        lvk::round4(e_max + T + lvk::ROW_SLACK);
  int threads = 128;
  while (threads > 32 && threads * row_bytes > 160 * 1024) threads /= 2;
  const size_t smem = lvk::round4(D * 4) + (size_t)threads * row_bytes;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lv_lanes_kernel<MAXE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (B + threads - 1) / threads;
  lv_lanes_kernel<MAXE><<<blocks, threads, smem, stream>>>(
      static_cast<const uint8_t*>(pattern), static_cast<const int*>(p_len),
      static_cast<const uint8_t*>(text), static_cast<const int*>(t_len),
      static_cast<const int*>(k), static_cast<const float*>(qlp),
      static_cast<const int*>(free_len), static_cast<const int*>(prio), B, P,
      T, e_max, cs, static_cast<int*>(dist), static_cast<int*>(e_fin),
      static_cast<int*>(d_fin), static_cast<float*>(logp),
      static_cast<int*>(net));
  return cudaGetLastError();
}

}  // namespace

// pattern (B, P) u8; text (B, T) u8 (unpadded, masked to t_len in-kernel);
// p_len, t_len, k, free (B,) i32 (free may be null); qlp (B, P) f32 or
// null (then every quality is qconst); prio (D,) i32.
extern "C" int lv_lanes_launch(const void* pattern, const void* p_len,
                               const void* text, const void* t_len,
                               const void* k, const void* qlp,
                               const void* free_len, const void* prio, int B,
                               int P, int T, int e_max, float log_gap_open,
                               float log_gap_extend, float log_one_minus_snp,
                               float qconst, void* dist, void* e_fin,
                               void* d_fin, void* logp, void* net,
                               void* stream) {
  if (B <= 0) return 0;
  if (e_max < 1 || e_max > 31) return static_cast<int>(cudaErrorInvalidValue);
  const lvk::Consts cs{log_gap_open, log_gap_extend, log_one_minus_snp,
                       qconst};
  auto s = static_cast<cudaStream_t>(stream);
  if (e_max <= 8)
    return launch<8>(pattern, p_len, text, t_len, k, qlp, free_len, prio, B,
                     P, T, e_max, cs, dist, e_fin, d_fin, logp, net, s);
  if (e_max <= 16)
    return launch<16>(pattern, p_len, text, t_len, k, qlp, free_len, prio, B,
                      P, T, e_max, cs, dist, e_fin, d_fin, logp, net, s);
  return launch<31>(pattern, p_len, text, t_len, k, qlp, free_len, prio, B,
                    P, T, e_max, cs, dist, e_fin, d_fin, logp, net, s);
}
