// K5: LV-lanes, mismatch-mask form — the same function as K1
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
// per row, lanes over diagonals, in the loop K1 and K3 share
// (lv_warp.cuh).  What is K5's own is the extension, the TPU kernel's
// suffix-min expressed in the SM's bit operations: the warp first builds,
// in its scratch, one 32-bit mismatch mask per diagonal and 32 pattern
// positions (bit b of word w on diagonal d: p = 32 w + b < P, p >= free,
// pat[p] != txt[p + d]; the sentinels and the text past t_len are 255, so
// they mismatch), and a level extends to the first set bit at or after p
// (__ffs of the word shifted by p & 31, then the following words), clipped
// to end_d.  The masks take D x ceil(P/32) words, 560 bytes a warp at P =
// 100 and e_max 17.  They are built by ballots: for each (word, diagonal)
// lane b compares position 32 w + b and __ballot_sync gathers the word.
// A second build, each lane assembling words from eight four-byte XORs
// (lvk::load4), was slower at every measured shape: 0.0364-0.0368 against
// 0.0301-0.0303 ms at RNA single's 8,192 rows, 0.0195 against 0.0190 at
// 2,048 (H100 80GB HBM3, 700 W; chip_smoke.py), its build loop 117 SASS
// instructions to the ballot build's 33.
#include "lv_warp.cuh"

namespace {

__host__ __device__ inline int mask_words(int P) { return (P + 31) >> 5; }

// the mismatch masks, word-major (word w of diagonal d at w * D + d, so
// lanes on the same word read distinct banks)
struct MismatchMasks {
  const uint32_t* m;
  int D;

  __host__ __device__ static int scratch_bytes(int P, int e_max) {
    return (2 * e_max + 1) * mask_words(P) * 4;
  }

  __device__ MismatchMasks(const uint8_t* pat, const uint8_t* txt,
                           uint8_t* scratch, int P, int e_max, int free_len,
                           int lane)
      : m(reinterpret_cast<const uint32_t*>(scratch)), D(2 * e_max + 1) {
    uint32_t* out = reinterpret_cast<uint32_t*>(scratch);
    const int NW = mask_words(P);
    for (int w = 0; w < NW; ++w) {
      const int p = 32 * w + lane;
      const bool live = p < P && p >= free_len;
      const uint8_t c = live ? pat[p] : 0;
      for (int d = 0; d < D; ++d) {
        const uint32_t bits =
            __ballot_sync(lvw::FULL, live && txt[p + d] != c);
        if (lane == (d & 31)) out[w * D + d] = bits;
      }
    }
  }

  __device__ int operator()(int d, int p, int end) const {
    int w = p >> 5, q = p;
    uint32_t x = m[w * D + d] >> (p & 31);
    while (x == 0) {
      q = 32 * ++w;
      if (q >= end) return end;
      x = m[w * D + d];
    }
    return min(q + __ffs(x) - 1, end);
  }
};

template <int NS>
__global__ void lv_onehot_kernel(lvw::Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  lvw::lv_row<NS, MismatchMasks>(a, smem);
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
  return static_cast<int>(lvw::launch<MismatchMasks>(
      2 * e_max + 1 <= 32 ? &lv_onehot_kernel<1> : &lv_onehot_kernel<2>, a,
      static_cast<cudaStream_t>(stream)));
}
