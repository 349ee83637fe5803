// K5: LV-lanes, next-mismatch-table form — the same function as K1
// (lv_lanes.cu): banded Landau-Vishkin distance up to min(k, e_max) with a
// per-row free prefix, priority-ordered diagonal ties and the fused
// probability backtrace; five scalars out per row (dist, e_fin, d_fin,
// logp, net).
//
// Replaces the TPU kernel snap_rnaseq_tpu/ops/lv_pallas.py _lv_kernel_lanes
// (impl="onehot" of lv_distance_pallas_lanes), which the JAX package runs
// in place of K1 when SNAP_TPU_LV_LANES is not "bits"; ops/lv.py makes the
// same choice.  The TPU kernel builds, per diagonal, a next-mismatch table
// by a suffix-min over the pattern, so that extending a diagonal is one
// lookup instead of a scan.
//
// What bounds it on an H100: as for K1, latency, not bytes or arithmetic
// throughput (a row reads ~P + T bytes and writes 20).  Design: one warp
// per row, lanes over diagonals, in the loop K1 shares (lv_warp.cuh).
// What is K5's own is the extension: each lane first builds the
// next-mismatch rows of its diagonals, int16, in the warp's scratch by one
// backward scan over the pattern (positions below the free prefix always
// match; the row stride is an odd number of words, so the 32 lanes' writes
// of one column hit 32 banks); a level then extends with one shared-memory
// load clipped to end_d.  The table (D x P int16, ~7 KB a warp at P = 100,
// e_max 17) is what fewer warps per SM pay for the single lookup.
#include "lv_warp.cuh"

namespace {

// next-mismatch row stride in int16 entries: >= P, even, and an odd number
// of 4-byte words
__host__ __device__ inline int nm_stride(int P) {
  int s = (P + 1) & ~1;
  if ((s / 2) % 2 == 0) s += 2;
  return s;
}

// nm[d][p] = the first q >= p with q >= free and txt[q + d] != pat[q],
// else P; built by each lane for its diagonals
struct NextMismatch {
  const int16_t* nm;
  int stride;

  __host__ __device__ static int scratch_bytes(int P, int e_max) {
    return (2 * e_max + 1) * nm_stride(P) * 2;
  }

  __device__ NextMismatch(const uint8_t* pat, const uint8_t* txt,
                          uint8_t* scratch, int P, int e_max, int free_len,
                          int lane)
      : nm(reinterpret_cast<const int16_t*>(scratch)), stride(nm_stride(P)) {
    int16_t* tab = reinterpret_cast<int16_t*>(scratch);
    for (int d = lane; d < 2 * e_max + 1; d += 32) {
      int16_t* nrow = tab + d * stride;
      int cur = P;
      for (int p = P - 1; p >= 0; --p) {
        if (p >= free_len && txt[p + d] != pat[p]) cur = p;
        nrow[p] = static_cast<int16_t>(cur);
      }
    }
  }

  __device__ int operator()(int d, int p, int end) const {
    return min(static_cast<int>(nm[d * stride + p]), end);
  }
};

template <int NS>
__global__ void lv_onehot_kernel(lvw::Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  lvw::lv_row<NS, NextMismatch>(a, smem);
}

}  // namespace

// The same arguments as lv_lanes_launch (lv_lanes.cu); see lvw::make_args.
extern "C" int lv_onehot_launch(const void* pattern, const void* p_len,
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
  return static_cast<int>(lvw::launch<NextMismatch>(
      2 * e_max + 1 <= 32 ? &lv_onehot_kernel<1> : &lv_onehot_kernel<2>, a,
      static_cast<cudaStream_t>(stream)));
}
