// K1: LV-lanes — banded Landau-Vishkin distance with a per-row free
// prefix and the fused probability backtrace; five scalars out per row.
//
// Replaces the TPU kernel snap_rnaseq_tpu/ops/lv_pallas.py
// _lv_kernel_lanes_bits (reached through lv_distance_pallas_lanes), which
// score_phase (models/single.py) calls with both seed-split directions.
//
// What bounds it on an H100: neither bytes nor arithmetic throughput but
// latency.  A row reads ~P + T bytes and writes 20, so at the paired
// path's shapes (P = 100, T = 117, 2,048-16,384 rows) the bytes take about
// a microsecond of HBM time; the work is a data-dependent DP of up to
// e_max levels x D = 2 e_max + 1 diagonals with early exits.  Run serially
// by one thread per row (the first design), a row's D diagonals and their
// extensions queue one after another, and the kernel's time was the
// latency of the slowest row, flat from 2,048 to 16,384 rows.
//
// Design: one warp per row, lanes over diagonals, in the loop K3 and K5
// share (lv_warp.cuh): the rows are staged in the warp's shared memory, a
// level's D diagonals run on D lanes at once, neighbours come by
// __shfl_sync, the
// winner by __reduce_min_sync, and lane 0 runs the backtrace over the
// shared level table.  What is K1's own is the extension, the `bits`
// formulation of its TPU kernel (lvw::XorRun, which K3 shares): a lane
// runs its diagonal to the next mismatch four bytes at a time (XOR +
// __ffs, lvk::extend_run) over the staged rows.  K1 builds no mismatch
// masks: it saves K5's build of D x P/32 words per row and pays in
// divergence, since a level waits for its longest extension.
#include "lv_warp.cuh"

namespace {

template <int NS>
__global__ void lv_lanes_kernel(lvw::Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  lvw::lv_row<NS, lvw::XorRun>(a, smem);
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
  const lvw::Args a = lvw::make_args(
      pattern, p_len, text, t_len, k, qlp, free_len, prio, B, P, T, e_max,
      log_gap_open, log_gap_extend, log_one_minus_snp, qconst, dist, e_fin,
      d_fin, logp, net);
  if (!lvw::valid_shape(a)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(lvw::launch<lvw::XorRun>(
      2 * e_max + 1 <= 32 ? &lv_lanes_kernel<1> : &lv_lanes_kernel<2>, a,
      static_cast<cudaStream_t>(stream)));
}
