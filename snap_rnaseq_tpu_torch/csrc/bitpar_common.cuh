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
// What bounds the step on an H100: the integer instruction rate, for
// W = ceil(P / 32) words of boolean work per text column and row at the
// SM's 64 INT32 lanes.
// The step is written for the fewest instructions per word (the
// recurrence itself is 10: the carried add and three-input LOP3s):
//   * Peq[c] is one shared-memory load per column for all W words: each
//     thread keeps its Peq rows in a table tab[code][thread] (codes 0-3,
//     and a zero row that codes >= 4 read), so a warp's 32 loads of one
//     column fall in 32 distinct bank slots whatever the codes are; the
//     first design selected Peq[c] with four compares and selects per word;
//   * W is a template parameter, so PV and MV stay in registers with
//     static word indices, and the score bit is always in word W - 1 (only
//     its position, (P - 1) & 31, is a run-time shift);
//   * the multi-word add ripples its carry through the carry flag (one
//     add.cc / addc.cc chain in PTX) instead of two compares and an OR;
//   * each shifted word (Ph << 1 | carry-in) is one funnel shift from the
//     previous word.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bpk {

constexpr int kNoColumn = 0x7FFFFFF0;
constexpr int kThreads = 128;   // threads per block of K2 and K4
constexpr int kCodes = 5;       // Peq rows: codes 0-3, then the zero row

// a Peq row of W words, loaded from shared memory in one instruction
template <int W> struct PeqVec { using T = uint4; };   // W = 3 padded
template <> struct PeqVec<1> { using T = uint32_t; };
template <> struct PeqVec<2> { using T = uint2; };

__device__ __forceinline__ void to_words(uint32_t v, uint32_t (&e)[1]) {
  e[0] = v;
}
__device__ __forceinline__ void to_words(uint2 v, uint32_t (&e)[2]) {
  e[0] = v.x;
  e[1] = v.y;
}
__device__ __forceinline__ void to_words(uint4 v, uint32_t (&e)[3]) {
  e[0] = v.x;
  e[1] = v.y;
  e[2] = v.z;
}
__device__ __forceinline__ void to_words(uint4 v, uint32_t (&e)[4]) {
  e[0] = v.x;
  e[1] = v.y;
  e[2] = v.z;
  e[3] = v.w;
}

template <int W>
__device__ __forceinline__ typename PeqVec<W>::T from_words(
    const uint32_t (&e)[W]) {
  if constexpr (W == 1) return e[0];
  else if constexpr (W == 2) return make_uint2(e[0], e[1]);
  else if constexpr (W == 3) return make_uint4(e[0], e[1], e[2], 0u);
  else return make_uint4(e[0], e[1], e[2], e[3]);
}

// A thread's Peq rows in the block's shared table, declared by the kernel
// as  __shared__ typename bpk::PeqVec<W>::T tab[bpk::kCodes][bpk::kThreads]
template <int W>
struct Peq {
  using V = typename PeqVec<W>::T;
  const V* col;   // &tab[0][threadIdx.x]

  // bit 0 of each byte of x, as four consecutive bits (one multiply puts
  // bits 0, 8, 16 and 24 at 21-24, with no carries)
  static __device__ __forceinline__ uint32_t gather4(uint32_t x) {
    return (((x & 0x01010101u) * 0x00204081u) >> 21) & 15u;
  }

  // Builds the rows from a pattern row of P <= 32 * W codes: the code's
  // two low bits and "code >= 4" as bit planes, four positions at a time
  // (one 32-bit load where the row is 4-byte aligned, as at P = 100), then
  // combined per code.
  __device__ Peq(V (*tab)[kThreads], const uint8_t* pr, int P)
      : col(&tab[0][threadIdx.x]) {
    uint32_t m[4][W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint8_t* pw = pr + w * 32;
      const int n = P - w * 32 < 32 ? P - w * 32 : 32;
      uint32_t b0 = 0, b1 = 0, other = 0;
      auto add4 = [&](uint32_t x, int b) {   // codes b..b+3, one per byte
        b0 |= gather4(x) << b;
        b1 |= gather4(x >> 1) << b;
        if (x & 0xFCFCFCFCu)              // a code >= 4 among them (rare)
          for (int k = 0; k < 4; ++k)
            other |= (((x >> (8 * k)) & 0xFFu) > 3u ? 1u : 0u) << (b + k);
      };
      int b = 0;
      if ((reinterpret_cast<uintptr_t>(pw) & 3) == 0) {   // word loads
        for (; b + 4 <= n; b += 4)
          add4(*reinterpret_cast<const uint32_t*>(pw + b), b);
      } else {
        for (; b + 4 <= n; b += 4)
          add4(pw[b] | (pw[b + 1] << 8) | (pw[b + 2] << 16) |
                   (static_cast<uint32_t>(pw[b + 3]) << 24),
               b);
      }
      for (; b < n; ++b) {
        const uint32_t c = pw[b];
        b0 |= (c & 1u) << b;
        b1 |= ((c >> 1) & 1u) << b;
        other |= (c > 3u ? 1u : 0u) << b;
      }
      const uint32_t used = n >= 32 ? 0xFFFFFFFFu : (1u << n) - 1u;
      const uint32_t base = used & ~other;
      m[0][w] = base & ~b0 & ~b1;
      m[1][w] = base & b0 & ~b1;
      m[2][w] = base & ~b0 & b1;
      m[3][w] = base & b0 & b1;
    }
    V* own = &tab[0][threadIdx.x];
#pragma unroll
    for (int c = 0; c < 4; ++c) own[c * kThreads] = from_words<W>(m[c]);
    uint32_t zero[W] = {};
    own[4 * kThreads] = from_words<W>(zero);
  }

  // Peq[c] for a text code (codes >= 4 read the zero row)
  __device__ __forceinline__ void lookup(uint32_t c, uint32_t (&eq)[W]) const {
    to_words(col[(c < 4u ? c : 4u) * kThreads], eq);
  }
};

template <int W>
struct State {
  uint32_t PV[W], MV[W];
  uint32_t hb_shift;   // the score bit, (P - 1) & 31, of word W - 1
  int score;
};

// PV = ~0, MV = 0, score = P (a fresh scan)
template <int W>
__device__ __forceinline__ void init(State<W>& s, int P) {
#pragma unroll
  for (int w = 0; w < W; ++w) {
    s.PV[w] = 0xFFFFFFFFu;
    s.MV[w] = 0u;
  }
  s.hb_shift = static_cast<uint32_t>(P - 1) & 31u;
  s.score = P;
}

// sum = x + y over W words, the carry rippled through the carry flag
template <int W>
__device__ __forceinline__ void add_words(uint32_t (&sum)[W],
                                          const uint32_t (&x)[W],
                                          const uint32_t (&y)[W]) {
  static_assert(W >= 1 && W <= 4, "1 <= W <= 4");
  if constexpr (W == 1) {
    sum[0] = x[0] + y[0];
  } else if constexpr (W == 2) {
    asm("add.cc.u32 %0, %2, %4;\n\t"
        "addc.u32 %1, %3, %5;"
        : "=r"(sum[0]), "=r"(sum[1])
        : "r"(x[0]), "r"(x[1]), "r"(y[0]), "r"(y[1]));
  } else if constexpr (W == 3) {
    asm("add.cc.u32 %0, %3, %6;\n\t"
        "addc.cc.u32 %1, %4, %7;\n\t"
        "addc.u32 %2, %5, %8;"
        : "=r"(sum[0]), "=r"(sum[1]), "=r"(sum[2])
        : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(y[0]), "r"(y[1]),
          "r"(y[2]));
  } else {
    asm("add.cc.u32 %0, %4, %8;\n\t"
        "addc.cc.u32 %1, %5, %9;\n\t"
        "addc.cc.u32 %2, %6, %10;\n\t"
        "addc.u32 %3, %7, %11;"
        : "=r"(sum[0]), "=r"(sum[1]), "=r"(sum[2]), "=r"(sum[3])
        : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(y[0]),
          "r"(y[1]), "r"(y[2]), "r"(y[3]));
  }
}

// One text column with Peq row eq; updates PV, MV and the running score.
template <int W, bool FREE_START>
__device__ __forceinline__ void step(State<W>& s, const uint32_t (&eq)[W]) {
  uint32_t a[W], sum[W];
#pragma unroll
  for (int w = 0; w < W; ++w) a[w] = eq[w] & s.PV[w];
  add_words<W>(sum, a, s.PV);
  uint32_t ph_prev = 0u, mh_prev = 0u;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const uint32_t pv = s.PV[w], mv = s.MV[w];
    const uint32_t xh = (sum[w] ^ pv) | eq[w];
    const uint32_t ph = mv | ~(xh | pv);
    const uint32_t mh = pv & xh;
    if (w == W - 1)
      s.score += static_cast<int>((ph >> s.hb_shift) & 1u) -
                 static_cast<int>((mh >> s.hb_shift) & 1u);
    // the bit shifted into word 0 is the fill
    const uint32_t phs = w == 0 ? (ph << 1) | (FREE_START ? 0u : 1u)
                                : __funnelshift_l(ph_prev, ph, 1);
    const uint32_t mhs = w == 0 ? mh << 1 : __funnelshift_l(mh_prev, mh, 1);
    ph_prev = ph;
    mh_prev = mh;
    const uint32_t xv = eq[w] | mv;
    s.PV[w] = mhs | ~(xv | phs);
    s.MV[w] = phs & xv;
  }
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
