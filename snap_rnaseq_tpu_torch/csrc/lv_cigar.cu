// K3: LV-CIGAR — banded Landau-Vishkin distance that also recovers the edit
// script (what ops/lv.py _recover_actions computes: the action and matched
// run of every level, and the start run L[0][centre]), from which the host
// emits CIGAR tokens (ops/cigar.py emit_tokens).  On request it also writes
// the whole (e_max+1, D) L and action tables, as the TPU kernel does, so a
// check can hold them against the plain version; the CIGAR path does not
// ask for them.
//
// Replaces the TPU kernel snap_rnaseq_tpu/ops/lv_pallas.py _lv_kernel
// (reached through lv_distance_pallas_core with keep_tables=True and the
// CIGAR diagonal order), called by ops/cigar.py for every SAM record whose
// CIGAR the substitution closed form cannot write.
//
// What bounds it on an H100: by the roofline, integer operations (a row
// reads ~210 bytes and writes ~270: the scalars and 2 x 31 script entries,
// against some thousands of DP operations).  What limits it in practice is
// the latency of one thread's serial work: a flush holds a few hundred rows
// at most, all of them in one wave of blocks, so the call lasts as long as
// the slowest row's DP and backtrace.  Design: one candidate per thread,
// rows staged in shared memory, four-byte XOR + __ffs extension as in K1,
// the DP in a per-thread int16 table in local memory that stops at the
// row's last level, and the backtrace on that table; only the script and
// scalars go out.  With tables asked for, the thread streams its L table
// and the action table (recomputed from level e-1) to its output rows,
// repeating the last level for the frozen ones exactly as the TPU kernel's
// where(done, L, best) did.  A warp per row, lanes over diagonals, would
// cut the serial chain.
#include "lv_common.cuh"

namespace {

__global__ void lv_cigar_kernel(const uint8_t* __restrict__ pattern,
                                const int* __restrict__ p_len,
                                const uint8_t* __restrict__ text,
                                const int* __restrict__ t_len,
                                const int* __restrict__ k,
                                const float* __restrict__ qlp,
                                const int* __restrict__ prio_g, int B, int P,
                                int T, int e_max, lvk::Consts cs,
                                int* __restrict__ dist,
                                int* __restrict__ e_fin,
                                int* __restrict__ d_fin,
                                float* __restrict__ logp,
                                int* __restrict__ net,
                                int* __restrict__ start_run, int* L_out,
                                int* A_out, int* acts_out,
                                int* matched_out) {
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
  lvk::LocalTab<31> tab;
  tab.D = D;
  int8_t acts[32];
  int16_t matched[32];
  const lvk::Result r = lvk::lv_one(
      pat, pat + sp, p_len[i], t_len[i], k[i], 0, e_max, prio,
      qlp ? qlp + (size_t)i * P : nullptr, cs, tab, acts, matched);
  // whole tables out when asked: levels past r.last repeat level r.last,
  // and their actions are all taken from it
  if (L_out != nullptr) {
    int* L_row = L_out + (size_t)i * (e_max + 1) * D;
    int* A_row = A_out + (size_t)i * (e_max + 1) * D;
    for (int e = 0; e <= e_max; ++e) {
      const int src = e < r.last ? e : r.last;
      const int prev = e - 1 < r.last ? e - 1 : r.last;
      for (int d = 0; d < D; ++d) {
        L_row[e * D + d] = tab.L(src, d);
        A_row[e * D + d] = e == 0 ? 0 : lvk::act_from(tab, prev, d, D);
      }
    }
  }
  // the edit script the backtrace recovered (levels 1..e_max; -1 / 0 past
  // the final level, as ops/lv.py _recover_actions returns it)
  for (int e = 1; e <= e_max; ++e) {
    const bool on = e <= r.e_fin;
    acts_out[(size_t)i * e_max + e - 1] = on ? acts[e] : -1;
    matched_out[(size_t)i * e_max + e - 1] = on ? matched[e] : 0;
  }
  dist[i] = r.dist;
  e_fin[i] = r.e_fin;
  d_fin[i] = r.d_fin;
  logp[i] = r.logp;
  net[i] = r.net;
  start_run[i] = tab.L(0, e_max);
}

}  // namespace

// pattern (B, P) u8; text (B, T) u8; p_len, t_len, k (B,) i32; qlp (B, P)
// f32 or null (qconst everywhere); prio (D,) i32; dist, e_fin, d_fin, net,
// start_run (B,) i32, logp (B,) f32; L_out, A_out (B, e_max+1, D) i32, both
// or neither null (null: no tables written); acts_out, matched_out
// (B, e_max) i32.
extern "C" int lv_cigar_launch(const void* pattern, const void* p_len,
                               const void* text, const void* t_len,
                               const void* k, const void* qlp,
                               const void* prio, int B, int P, int T,
                               int e_max, float log_gap_open,
                               float log_gap_extend, float log_one_minus_snp,
                               float qconst, void* dist, void* e_fin,
                               void* d_fin, void* logp, void* net,
                               void* start_run, void* L_out, void* A_out,
                               void* acts_out, void* matched_out,
                               void* stream) {
  if (B <= 0) return 0;
  if (e_max < 1 || e_max > 31 || (L_out == nullptr) != (A_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const lvk::Consts cs{log_gap_open, log_gap_extend, log_one_minus_snp,
                       qconst};
  const int D = 2 * e_max + 1;
  const int row_bytes = lvk::round4(P + lvk::ROW_SLACK) +
                        lvk::round4(e_max + T + lvk::ROW_SLACK);
  int threads = 128;
  while (threads > 32 && threads * row_bytes > 160 * 1024) threads /= 2;
  const size_t smem = lvk::round4(D * 4) + (size_t)threads * row_bytes;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lv_cigar_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (B + threads - 1) / threads;
  lv_cigar_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pattern), static_cast<const int*>(p_len),
      static_cast<const uint8_t*>(text), static_cast<const int*>(t_len),
      static_cast<const int*>(k), static_cast<const float*>(qlp),
      static_cast<const int*>(prio), B, P, T, e_max, cs,
      static_cast<int*>(dist), static_cast<int*>(e_fin),
      static_cast<int*>(d_fin), static_cast<float*>(logp),
      static_cast<int*>(net), static_cast<int*>(start_run),
      static_cast<int*>(L_out), static_cast<int*>(A_out),
      static_cast<int*>(acts_out), static_cast<int*>(matched_out));
  return static_cast<int>(cudaGetLastError());
}
