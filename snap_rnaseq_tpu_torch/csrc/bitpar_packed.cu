// K2: bit-parallel (Myers/Hyyro) semi-global edit distance over 4-bit
// packed genome words — the whole-read prefilter.
//
// Replaces the TPU kernel snap_rnaseq_tpu/ops/bitpar.py _bitpar_kernel in
// its packed-text form (reached through bitpar_distance_packed /
// bitpar_distance_words), called by rowwise_score_phase
// (models/single.py) on every candidate.  This slice takes the forward,
// global-start form without track_pos; the mate-rescue flags are refused
// by the wrapper.
//
// Recurrence per text column j with code c (nibble packed_off + j):
//   EQ = Peq[c]; Xv = EQ | MV; Xh = (((EQ & PV) + PV) ^ PV) | EQ
//   Ph = MV | ~(Xh | PV); Mh = PV & Xh; score += Ph[P-1] - Mh[P-1]
//   Ph' = Ph << 1 | 1; Mh' = Mh << 1; PV = Mh' | ~(Xv | Ph'); MV = Ph' & Xv
// and the answer is the minimum score over columns j < t_len.
//
// What bounds it on an H100: integer issue.  A row reads its P-byte
// pattern and n_w packed words (~170 bytes) and writes 4, while it runs
// ~20 W-word operations for each of TXT columns (~9,000 32-bit operations
// at P = 100, TXT = 116): some 50 operations per byte, above the card's
// int32 ridge.  Design: one candidate per thread, the W = ceil(P/32)
// words of Peq, PV and MV in registers (W a template parameter, so every
// word index is static), a rippled 4-word add-with-carry, and each text
// code taken from its nibble of the packed word row (no unpacked text is
// ever written).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <int W>
__global__ void bitpar_packed_kernel(const uint8_t* __restrict__ pattern,
                                     int P, const uint32_t* __restrict__ words,
                                     int NW, const int* __restrict__ t_len,
                                     int TXT, int packed_off, int B,
                                     int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  uint32_t peq[4][W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    uint32_t m0 = 0, m1 = 0, m2 = 0, m3 = 0;
    const uint8_t* pr = pattern + (size_t)i * P + w * 32;
    const int n = P - w * 32 < 32 ? P - w * 32 : 32;
    for (int b = 0; b < n; ++b) {
      const uint32_t c = pr[b], bit = 1u << b;
      m0 |= c == 0 ? bit : 0u;
      m1 |= c == 1 ? bit : 0u;
      m2 |= c == 2 ? bit : 0u;
      m3 |= c == 3 ? bit : 0u;
    }
    peq[0][w] = m0;
    peq[1][w] = m1;
    peq[2][w] = m2;
    peq[3][w] = m3;
  }
  uint32_t PV[W], MV[W];
#pragma unroll
  for (int w = 0; w < W; ++w) { PV[w] = 0xFFFFFFFFu; MV[w] = 0u; }
  const int hb_word = (P - 1) >> 5;
  const uint32_t hb_bit = 1u << ((P - 1) & 31);
  const int tl = t_len[i];
  const uint32_t* wr = words + (size_t)i * NW;
  int score = P, best = P;
  int p = packed_off;
  uint32_t cur = wr[p >> 3] >> (4 * (p & 7));
  for (int j = 0; j < TXT; ++j, ++p) {
    if ((p & 7) == 0) cur = wr[p >> 3];
    const uint32_t c = cur & 15u;
    cur >>= 4;
    uint32_t eq[W];
#pragma unroll
    for (int w = 0; w < W; ++w)
      eq[w] = c == 0 ? peq[0][w]
            : c == 1 ? peq[1][w]
            : c == 2 ? peq[2][w]
            : c == 3 ? peq[3][w] : 0u;
    uint32_t carry = 0, cp = 1u, cm = 0u;
    int ph_hi = 0, mh_hi = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint32_t a = eq[w] & PV[w];
      const uint32_t s = a + PV[w];
      const uint32_t s1 = s + carry;
      carry = (s < a) | (s1 < s);
      const uint32_t xh = (s1 ^ PV[w]) | eq[w];
      const uint32_t xv = eq[w] | MV[w];
      const uint32_t ph = MV[w] | ~(xh | PV[w]);
      const uint32_t mh = PV[w] & xh;
      if (w == hb_word) {
        ph_hi = (ph & hb_bit) != 0;
        mh_hi = (mh & hb_bit) != 0;
      }
      const uint32_t phs = (ph << 1) | cp;
      const uint32_t mhs = (mh << 1) | cm;
      cp = ph >> 31;
      cm = mh >> 31;
      PV[w] = mhs | ~(xv | phs);
      MV[w] = phs & xv;
    }
    score += ph_hi - mh_hi;
    if (j < tl && score < best) best = score;
  }
  out[i] = best;
}

template <int W>
cudaError_t launch(const void* pattern, int P, const void* words, int NW,
                   const void* t_len, int TXT, int packed_off, int B,
                   void* out, cudaStream_t stream) {
  const int threads = 128;
  bitpar_packed_kernel<W><<<(B + threads - 1) / threads, threads, 0, stream>>>(
      static_cast<const uint8_t*>(pattern), P,
      static_cast<const uint32_t*>(words), NW,
      static_cast<const int*>(t_len), TXT, packed_off, B,
      static_cast<int*>(out));
  return cudaGetLastError();
}

}  // namespace

// pattern (B, P) u8 codes; words (B, NW) packed u32 (int32 bits); t_len
// (B,) i32; out (B,) i32.  Needs P <= 128 and packed_off + TXT <= 8 * NW.
extern "C" int bitpar_packed_launch(const void* pattern, int P,
                                    const void* words, int NW,
                                    const void* t_len, int TXT,
                                    int packed_off, int B, void* out,
                                    void* stream) {
  if (B <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  switch ((P + 31) / 32) {
    case 1: return launch<1>(pattern, P, words, NW, t_len, TXT, packed_off, B, out, s);
    case 2: return launch<2>(pattern, P, words, NW, t_len, TXT, packed_off, B, out, s);
    case 3: return launch<3>(pattern, P, words, NW, t_len, TXT, packed_off, B, out, s);
    case 4: return launch<4>(pattern, P, words, NW, t_len, TXT, packed_off, B, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
