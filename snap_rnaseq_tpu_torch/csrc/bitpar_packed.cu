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
// branch on them.  The column step is bitpar_common.cuh's, shared with K4.
//
// What bounds it on an H100: the integer instruction rate, and for the
// rescue form also latency.  A row reads its P-byte pattern and n_w
// packed words and writes 4 bytes, while it runs W words of boolean work
// for each of TXT columns:
// at the prefilter's P = 100, TXT = 117 some 5,000 32-bit operations for
// ~170 bytes.  The prefilter's 262,144 rows fill the card, one row per
// thread, so its time is the column step's instruction count
// (bitpar_common.cuh: Peq from a shared table, one load per column) and
// the column's own overhead (the next nibble, the score bit, the offer):
// the walk takes a packed word's 8 columns per loop iteration, so nibble
// loads and loop counters are paid once a word.  The rescue's 4,096 rows
// of TXT = 1,084 do not fill the card: one thread per row is about one
// warp per SM, each walking 1,084 dependent column steps.
//
// Design of the rescue form: with a free start the scan splits without
// changing a bit of its answer.  An optimal alignment of the P-base
// pattern costs at most P, so it spans at most 2P text columns, and a scan
// restarted with fresh state (PV = ~0, MV = 0, score = P) 2P columns
// before a chunk gives the serial scan's score at every column of that
// chunk.  So a row's columns are cut into n_chunks chunks of chunk_len;
// the thread of chunk q warms up over the `warm` (>= 2P) columns before
// it without offering, then offers score * 4096 + j at its own global
// columns j under the same rule and t_len mask.  A row's chunks are
// adjacent lanes (n_chunks a power of two <= 32), and the row's answer is
// their minimum by __shfl_xor_sync: the minimum of the encodings is the
// serial minimum, the earliest column winning ties, the 12-bit wrap
// unchanged.  ops/bitpar.py scan_chunks picks the geometry from the rows
// and TXT; the global-start forms cannot be split and run n_chunks = 1,
// one row per thread, as does the prefilter.  Each text code is shifted
// out of its nibble of the packed word row (forward: low nibble first;
// reverse: high nibble first, the words walked downward), so no unpacked
// or reversed text is ever written.
#include "bitpar_common.cuh"

namespace {

// the codes of a packed word row from nibble p on, upward or downward; a
// word is loaded when the walk enters it
template <bool REVERSE>
struct Nibbles {
  const uint32_t* wp;   // the next word to load
  int p;
  uint32_t cur;

  __device__ Nibbles(const uint32_t* wr, int p_) : wp(wr + (p_ >> 3)), p(p_) {
    // nibble p in the top (reverse) or bottom (forward) four bits, unless
    // it starts its word (then next() loads it)
    const int q = p & 7;
    if constexpr (REVERSE)
      cur = q != 7 ? *wp-- << (4 * (7 - q)) : 0u;
    else
      cur = q != 0 ? *wp++ >> (4 * q) : 0u;
  }

  // the walk stands at the first nibble of a word
  __device__ __forceinline__ bool word_start() const {
    return (p & 7) == (REVERSE ? 7 : 0);
  }

  __device__ __forceinline__ uint32_t next() {
    uint32_t c;
    if constexpr (REVERSE) {
      if ((p & 7) == 7) cur = *wp--;
      c = cur >> 28;
      cur <<= 4;
      --p;
    } else {
      if ((p & 7) == 0) cur = *wp++;
      c = cur & 15u;
      cur >>= 4;
      ++p;
    }
    return c;
  }

  // at a word start: the whole word, its 8 codes in walk order by code()
  __device__ __forceinline__ uint32_t next_word() {
    p += REVERSE ? -8 : 8;
    return REVERSE ? *wp-- : *wp++;
  }

  static __device__ __forceinline__ uint32_t code(uint32_t w, int q) {
    return (REVERSE ? w >> (28 - 4 * q) : w >> (4 * q)) & 15u;
  }
};

// One row's (or chunk's) walk over its columns: Peq lookup, column step
// and, where OFFER, the offer of each column.
template <int W, bool REVERSE, bool FREE_START, bool TRACK_POS>
struct Scan {
  const bpk::Peq<W>& peq;
  bpk::State<W>& s;
  Nibbles<REVERSE>& nib;
  int& best;
  int tl;

  template <bool OFFER>
  __device__ __forceinline__ void column(uint32_t c, int j) {
    uint32_t eq[W];
    peq.lookup(c, eq);
    bpk::step<W, FREE_START>(s, eq);
    if constexpr (OFFER) bpk::offer<TRACK_POS>(best, s.score, j, tl);
  }

  // columns [j, end): single columns up to a word boundary, then whole
  // words of 8 columns (unrolled: no per-column load test or loop
  // counter), then the rest
  template <bool OFFER>
  __device__ __forceinline__ void run(int j, int end) {
#pragma unroll 1
    for (; j < end && !nib.word_start(); ++j) column<OFFER>(nib.next(), j);
#pragma unroll 1
    for (; j + 8 <= end; j += 8) {
      const uint32_t w = nib.next_word();
#pragma unroll
      for (int q = 0; q < 8; ++q)
        column<OFFER>(Nibbles<REVERSE>::code(w, q), j + q);
    }
#pragma unroll 1
    for (; j < end; ++j) column<OFFER>(nib.next(), j);
  }
};

template <int W, bool REVERSE, bool FREE_START, bool TRACK_POS>
__global__ void bitpar_packed_kernel(const uint8_t* __restrict__ pattern,
                                     int P, const uint32_t* __restrict__ words,
                                     int NW, const int* __restrict__ t_len,
                                     int TXT, int packed_off, int B,
                                     int chunk_len, int warm, int chunk_shift,
                                     int* __restrict__ out) {
  using V = typename bpk::PeqVec<W>::T;
  extern __shared__ __align__(16) uint8_t smem[];
  V (*tab)[bpk::kThreads] = reinterpret_cast<V (*)[bpk::kThreads]>(smem);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = t >> chunk_shift;                 // the row
  const int chunk = t & ((1 << chunk_shift) - 1);
  int best = bpk::start_best<TRACK_POS>(P);
  if (i < B) {
    const int c0 = chunk * chunk_len;
    const int c1 = min(TXT, c0 + chunk_len);
    if (c0 < c1) {
      const bpk::Peq<W> peq(tab, pattern + (size_t)i * P, P);
      bpk::State<W> s;
      bpk::init(s, P);
      const int j = max(0, c0 - warm);
      Nibbles<REVERSE> nib(words + (size_t)i * NW,
                           REVERSE ? packed_off + TXT - 1 - j
                                   : packed_off + j);
      Scan<W, REVERSE, FREE_START, TRACK_POS> scan{peq, s, nib, best,
                                                   t_len[i]};
      scan.template run<false>(j, c0);      // the warm-up: no offers
      scan.template run<true>(c0, c1);
    }
  }
  // the row's answer: the minimum over its chunks, on adjacent lanes
  for (int o = (1 << chunk_shift) >> 1; o > 0; o >>= 1)
    best = min(best, __shfl_xor_sync(0xFFFFFFFFu, best, o));
  if (i < B && chunk == 0) out[i] = best;
}

template <int W, bool REVERSE, bool FREE_START, bool TRACK_POS>
cudaError_t launch(const void* pattern, int P, const void* words, int NW,
                   const void* t_len, int TXT, int packed_off, int B,
                   int chunk_len, int warm, int chunk_shift, void* out,
                   cudaStream_t stream) {
  const int threads = bpk::kThreads;
  const long long n = (long long)B << chunk_shift;
  // at most 40 KB (W = 16), within the 48 KB a block has without opting in
  constexpr int smem = bpk::table_bytes<W>(bpk::kThreads);
  static_assert(smem <= 48 * 1024, "K2's Peq table fits 48 KB");
  bitpar_packed_kernel<W, REVERSE, FREE_START, TRACK_POS>
      <<<(unsigned)((n + threads - 1) / threads), threads, smem, stream>>>(
          static_cast<const uint8_t*>(pattern), P,
          static_cast<const uint32_t*>(words), NW,
          static_cast<const int*>(t_len), TXT, packed_off, B, chunk_len,
          warm, chunk_shift, static_cast<int*>(out));
  return cudaGetLastError();
}

template <int W>
cudaError_t by_flags(int flags, const void* pattern, int P, const void* words,
                     int NW, const void* t_len, int TXT, int packed_off,
                     int B, int chunk_len, int warm, int chunk_shift,
                     void* out, cudaStream_t s) {
#define BP_CASE(F, R, FS, T)                                                \
  case F:                                                                   \
    return launch<W, R, FS, T>(pattern, P, words, NW, t_len, TXT,           \
                               packed_off, B, chunk_len, warm, chunk_shift, \
                               out, s);
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
// (B,) i32; out (B,) i32.  Needs P <= 128 (W = 1-4), or with BPK_WORDS
// defined W = ceil(P / 32) = BPK_WORDS (P = 129-512 over 12 libraries,
// ops/kernels.py); and packed_off + TXT <= 8 * NW.
// reverse, free_start, track_pos: 0 or 1.  The scan geometry (ops/bitpar.py
// scan_chunks): n_chunks a power of two <= 32, chunk_len * n_chunks >=
// TXT, and n_chunks = 1 unless free_start with warm >= 2P.
extern "C" int bitpar_packed_launch(const void* pattern, int P,
                                    const void* words, int NW,
                                    const void* t_len, int TXT,
                                    int packed_off, int reverse,
                                    int free_start, int track_pos,
                                    int chunk_len, int warm, int n_chunks,
                                    int B, void* out, void* stream) {
  if (B <= 0) return 0;
  const bool pow2 = n_chunks >= 1 && n_chunks <= 32 &&
                    (n_chunks & (n_chunks - 1)) == 0;
  if (!pow2 || (long long)chunk_len * n_chunks < TXT ||
      (n_chunks > 1 && !(free_start && warm >= 2 * P)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunk_shift = __builtin_ctz(static_cast<unsigned>(n_chunks));
  auto s = static_cast<cudaStream_t>(stream);
  const int flags = (reverse ? 1 : 0) | (free_start ? 2 : 0) |
                    (track_pos ? 4 : 0);
#ifdef BPK_WORDS   // a library for one word count, 5-16
  if ((P + 31) / 32 != BPK_WORDS)
    return static_cast<int>(cudaErrorInvalidValue);
  return by_flags<BPK_WORDS>(flags, pattern, P, words, NW, t_len, TXT,
                             packed_off, B, chunk_len, warm, chunk_shift, out,
                             s);
#else              // 1-4 words, P <= 128
  switch ((P + 31) / 32) {
    case 1: return by_flags<1>(flags, pattern, P, words, NW, t_len, TXT, packed_off, B, chunk_len, warm, chunk_shift, out, s);
    case 2: return by_flags<2>(flags, pattern, P, words, NW, t_len, TXT, packed_off, B, chunk_len, warm, chunk_shift, out, s);
    case 3: return by_flags<3>(flags, pattern, P, words, NW, t_len, TXT, packed_off, B, chunk_len, warm, chunk_shift, out, s);
    case 4: return by_flags<4>(flags, pattern, P, words, NW, t_len, TXT, packed_off, B, chunk_len, warm, chunk_shift, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#endif
}
