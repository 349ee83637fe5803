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
// What bounds it on an H100: neither bytes nor arithmetic throughput but
// latency.  A row reads ~210 bytes and writes ~270 (the scalars and 2 x 31
// script entries) against some thousands of DP operations, and a CIGAR
// flush holds 1-200 rows at e_max 31, all in one wave of blocks, so a
// call lasts as long as its slowest row: 8-15 levels of D = 63 diagonals
// on the aligning paths' flushes, all 30 for a row that never aligns
// within k = 30.  Run by one thread per row (the first design) those
// levels queued diagonal after diagonal over a 4 KB table in local
// memory, and a call took 0.12-0.25 ms whatever its row count.
//
// Design: the loop K1 and K5 share (lv_warp.cuh), one warp per row, lanes
// over diagonals (two slots a lane: diagonals l and l + 32, the centre 31
// on the border between them), K1's four-byte XOR extension, the level
// rows in the warp's shared memory.  What is K3's own is the Script output
// policy: lane 0's backtrace leaves the script in shared memory, the lanes
// store it coalesced, and with tables asked for they stream the L rows
// (levels past the row's last repeating it, as the TPU kernel's
// where(done, L, best)) and the action rows recomputed from the level
// before.  A block holds 4 warps: at the single path's 131-176 rows, 1,
// 2, 4 and 8 warps a block gave 0.01153, 0.01141, 0.01139 and 0.01164 ms
// a call (H100 80GB HBM3, 700 W; chip_smoke.py k3_warp_sweep), one row's
// latency plus the launch whatever the geometry.
#include "lv_warp.cuh"

namespace {

constexpr int WARPS = 4;              // warps per block unless forced
int g_warps = WARPS;

template <int NS>
__global__ void lv_cigar_kernel(lvw::Args a, lvw::Script s) {
  extern __shared__ __align__(16) uint8_t smem[];
  lvw::lv_row<NS, lvw::XorRun, lvw::Script>(a, smem, s);
}

}  // namespace

// For measurement: force `warps` warps per block (1..8), or 0 for the
// default; returns the previous setting.
extern "C" int lv_cigar_set_warps(int warps) {
  const int prev = g_warps;
  g_warps = warps >= 1 && warps <= lvw::MAX_WARPS ? warps : WARPS;
  return prev;
}

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
  const lvw::Args a = lvw::make_args(
      pattern, p_len, text, t_len, k, qlp, nullptr, prio, B, P, T, e_max,
      log_gap_open, log_gap_extend, log_one_minus_snp, qconst, dist, e_fin,
      d_fin, logp, net);
  if (!lvw::valid_shape(a) || (L_out == nullptr) != (A_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const lvw::Script s{static_cast<int*>(start_run),
                      static_cast<int*>(acts_out),
                      static_cast<int*>(matched_out), static_cast<int*>(L_out),
                      static_cast<int*>(A_out)};
  return static_cast<int>(lvw::launch<lvw::XorRun, lvw::Script>(
      2 * e_max + 1 <= 32 ? &lv_cigar_kernel<1> : &lv_cigar_kernel<2>, a,
      static_cast<cudaStream_t>(stream), g_warps, s));
}
