// K2: bit-parallel (Myers/Hyyro) semi-global edit distance over 4-bit
// packed genome words.
//
// Replaces the TPU kernel snap_rnaseq_tpu/ops/bitpar.py _bitpar_kernel in
// its packed-text form (reached through bitpar_distance_packed /
// bitpar_distance_words).  Two callers:
//   * the whole-read prefilter of rowwise_score_phase (models/single.py):
//     forward, global start, minimum distance;
//   * the paired mate rescue (models/paired.py _mate_rescue_end): the
//     window scanned back to front (REVERSE: column j reads nibble
//     packed_off + TXT - 1 - j), a free start, and the best column kept
//     (TRACK_POS: score * 4096 + column).
// The three flags are template parameters, so the column loop carries no
// branch on them.  The column step itself is bitpar_common.cuh's, shared
// with K4.
//
// What bounds it on an H100: integer issue.  A row reads its P-byte
// pattern and n_w packed words and writes 4 bytes, while it runs ~20
// W-word operations for each of TXT columns: at the prefilter's P = 100,
// TXT = 116 some 9,000 32-bit operations for ~170 bytes, and at the
// rescue's TXT = 1,084 ten times that for ~650 bytes.  Design: one
// candidate per thread, Peq/PV/MV in registers, each text code shifted out
// of its nibble of the packed word row (forward: low nibble first; reverse:
// high nibble first, the words walked downward), so no unpacked or reversed
// text is ever written.
#include "bitpar_common.cuh"

namespace {

template <int W, bool REVERSE, bool FREE_START, bool TRACK_POS>
__global__ void bitpar_packed_kernel(const uint8_t* __restrict__ pattern,
                                     int P, const uint32_t* __restrict__ words,
                                     int NW, const int* __restrict__ t_len,
                                     int TXT, int packed_off, int B,
                                     int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  bpk::State<W> s;
  bpk::init(s, pattern + (size_t)i * P, P);
  const int tl = t_len[i];
  const uint32_t* wr = words + (size_t)i * NW;
  int best = bpk::start_best<TRACK_POS>(P);
  if (TXT > 0) {
    if constexpr (REVERSE) {
      int p = packed_off + TXT - 1;
      // nibble p in the top four bits
      uint32_t cur = wr[p >> 3] << (4 * (7 - (p & 7)));
      for (int j = 0; j < TXT; ++j, --p) {
        if ((p & 7) == 7) cur = wr[p >> 3];
        const uint32_t c = cur >> 28;
        cur <<= 4;
        bpk::step<W, FREE_START>(s, c);
        bpk::offer<TRACK_POS>(best, s.score, j, tl);
      }
    } else {
      int p = packed_off;
      uint32_t cur = wr[p >> 3] >> (4 * (p & 7));
      for (int j = 0; j < TXT; ++j, ++p) {
        if ((p & 7) == 0) cur = wr[p >> 3];
        const uint32_t c = cur & 15u;
        cur >>= 4;
        bpk::step<W, FREE_START>(s, c);
        bpk::offer<TRACK_POS>(best, s.score, j, tl);
      }
    }
  }
  out[i] = best;
}

template <int W, bool REVERSE, bool FREE_START, bool TRACK_POS>
cudaError_t launch(const void* pattern, int P, const void* words, int NW,
                   const void* t_len, int TXT, int packed_off, int B,
                   void* out, cudaStream_t stream) {
  const int threads = 128;
  bitpar_packed_kernel<W, REVERSE, FREE_START, TRACK_POS>
      <<<(B + threads - 1) / threads, threads, 0, stream>>>(
          static_cast<const uint8_t*>(pattern), P,
          static_cast<const uint32_t*>(words), NW,
          static_cast<const int*>(t_len), TXT, packed_off, B,
          static_cast<int*>(out));
  return cudaGetLastError();
}

template <int W>
cudaError_t by_flags(int flags, const void* pattern, int P, const void* words,
                     int NW, const void* t_len, int TXT, int packed_off,
                     int B, void* out, cudaStream_t s) {
#define BP_CASE(F, R, FS, T)                                                \
  case F:                                                                   \
    return launch<W, R, FS, T>(pattern, P, words, NW, t_len, TXT,           \
                               packed_off, B, out, s);
  switch (flags) {
    BP_CASE(0, false, false, false)
    BP_CASE(1, true, false, false)
    BP_CASE(2, false, true, false)
    BP_CASE(3, true, true, false)
    BP_CASE(4, false, false, true)
    BP_CASE(5, true, false, true)
    BP_CASE(6, false, true, true)
    BP_CASE(7, true, true, true)
    default: return cudaErrorInvalidValue;
  }
#undef BP_CASE
}

}  // namespace

// pattern (B, P) u8 codes; words (B, NW) packed u32 (int32 bits); t_len
// (B,) i32; out (B,) i32.  Needs P <= 128 and packed_off + TXT <= 8 * NW.
// reverse, free_start, track_pos: 0 or 1.
extern "C" int bitpar_packed_launch(const void* pattern, int P,
                                    const void* words, int NW,
                                    const void* t_len, int TXT,
                                    int packed_off, int reverse,
                                    int free_start, int track_pos, int B,
                                    void* out, void* stream) {
  if (B <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const int flags = (reverse ? 1 : 0) | (free_start ? 2 : 0) |
                    (track_pos ? 4 : 0);
  switch ((P + 31) / 32) {
    case 1: return by_flags<1>(flags, pattern, P, words, NW, t_len, TXT, packed_off, B, out, s);
    case 2: return by_flags<2>(flags, pattern, P, words, NW, t_len, TXT, packed_off, B, out, s);
    case 3: return by_flags<3>(flags, pattern, P, words, NW, t_len, TXT, packed_off, B, out, s);
    case 4: return by_flags<4>(flags, pattern, P, words, NW, t_len, TXT, packed_off, B, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
