// The bit-parallel (Myers/Hyyro) column step shared by K2 (packed text,
// bitpar_packed.cu) and K4 (byte code rows, bitpar_rows.cu), so the two
// kernels cannot drift apart.  Both replace forms of the TPU kernel
// snap_rnaseq_tpu/ops/bitpar.py _bitpar_kernel.
//
// Per text column j with code c (codes >= 4 match nothing):
//   EQ = Peq[c]; Xv = EQ | MV; Xh = (((EQ & PV) + PV) ^ PV) | EQ
//   Ph = MV | ~(Xh | PV); Mh = PV & Xh; score += Ph[P-1] - Mh[P-1]
//   Ph' = Ph << 1 | fill; Mh' = Mh << 1; PV = Mh' | ~(Xv | Ph'); MV = Ph' & Xv
// fill is 1 for a global start (a prefix deletion per column) and 0 for a
// free start (semi-global search).  The answer is the minimum over columns
// j < t_len of score, or with track_pos of score * 4096 + j (the earliest
// best column wins ties; columns past t_len offer 0x7FFFFFF0).  The 12-bit
// column field is the TPU kernel's: past 4095 columns it runs into the
// score field, as it does there.
//
// W = ceil(P / 32) is a template parameter, so Peq, PV and MV stay in
// registers with static word indices; the multi-word add ripples its carry
// with unsigned compares.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bpk {

constexpr int kNoColumn = 0x7FFFFFF0;

template <int W>
struct State {
  uint32_t peq[4][W];
  uint32_t PV[W], MV[W];
  int hb_word;
  uint32_t hb_bit;
  int score;
};

// Peq masks from a pattern row of P <= 32 * W codes; PV = ~0, MV = 0.
template <int W>
__device__ __forceinline__ void init(State<W>& s, const uint8_t* pr, int P) {
#pragma unroll
  for (int w = 0; w < W; ++w) {
    uint32_t m0 = 0, m1 = 0, m2 = 0, m3 = 0;
    const uint8_t* pw = pr + w * 32;
    const int n = P - w * 32 < 32 ? P - w * 32 : 32;
    for (int b = 0; b < n; ++b) {
      const uint32_t c = pw[b], bit = 1u << b;
      m0 |= c == 0 ? bit : 0u;
      m1 |= c == 1 ? bit : 0u;
      m2 |= c == 2 ? bit : 0u;
      m3 |= c == 3 ? bit : 0u;
    }
    s.peq[0][w] = m0;
    s.peq[1][w] = m1;
    s.peq[2][w] = m2;
    s.peq[3][w] = m3;
    s.PV[w] = 0xFFFFFFFFu;
    s.MV[w] = 0u;
  }
  s.hb_word = (P - 1) >> 5;
  s.hb_bit = 1u << ((P - 1) & 31);
  s.score = P;
}

// One text column with code c; updates PV, MV and the running score.
template <int W, bool FREE_START>
__device__ __forceinline__ void step(State<W>& s, uint32_t c) {
  uint32_t carry = 0, cp = FREE_START ? 0u : 1u, cm = 0u;
  int ph_hi = 0, mh_hi = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const uint32_t eq = c == 0 ? s.peq[0][w]
                      : c == 1 ? s.peq[1][w]
                      : c == 2 ? s.peq[2][w]
                      : c == 3 ? s.peq[3][w] : 0u;
    const uint32_t pv = s.PV[w], mv = s.MV[w];
    const uint32_t a = eq & pv;
    const uint32_t sum = a + pv;
    const uint32_t sum1 = sum + carry;
    carry = (sum < a) | (sum1 < sum);
    const uint32_t xh = (sum1 ^ pv) | eq;
    const uint32_t xv = eq | mv;
    const uint32_t ph = mv | ~(xh | pv);
    const uint32_t mh = pv & xh;
    if (w == s.hb_word) {
      ph_hi = (ph & s.hb_bit) != 0;
      mh_hi = (mh & s.hb_bit) != 0;
    }
    const uint32_t phs = (ph << 1) | cp;
    const uint32_t mhs = (mh << 1) | cm;
    cp = ph >> 31;
    cm = mh >> 31;
    s.PV[w] = mhs | ~(xv | phs);
    s.MV[w] = phs & xv;
  }
  s.score += ph_hi - mh_hi;
}

template <bool TRACK_POS>
__device__ __forceinline__ int start_best(int P) {
  return TRACK_POS ? P * 4096 + 4095 : P;
}

// Column j's offer to the running minimum (strict: the earliest wins).
template <bool TRACK_POS>
__device__ __forceinline__ void offer(int& best, int score, int j, int t_len) {
  const int enc = TRACK_POS ? score * 4096 + j : score;
  const int cand = j < t_len ? enc : kNoColumn;
  if (cand < best) best = cand;
}

}  // namespace bpk
