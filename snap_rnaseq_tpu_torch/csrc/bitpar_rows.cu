// K4: bit-parallel (Myers/Hyyro) semi-global edit distance over byte code
// rows.
//
// Replaces the TPU kernel snap_rnaseq_tpu/ops/bitpar.py _bitpar_kernel in
// its unpacked form (i32 text rows, reached through bitpar_distance_pallas
// / bitpar_distance), which the stringz tool (tools/stringz.py) times.  The
// text here is the (B, TXT) u8 code rows the caller holds: codes >= 4
// match nothing (the padding byte is 255).  Flags: free_start and
// track_pos as in K2 (template parameters); the column step is
// bitpar_common.cuh's, shared with K2.
//
// What bounds it on an H100: on paper the integer instruction rate, as K2
// (W words of boolean work per column against TXT + P bytes per row).  In
// practice a global start cannot be split over columns, so each row is one
// serial chain of TXT column steps, and at stringz's 16,384 rows one thread
// a row gives about one warp per scheduler: nothing hides a latency that
// sits on that chain.  The first design (one row per thread, 128 a block)
// read its text a byte a column from its own global row, rows TXT bytes
// apart (a warp's load touched ~32 lines), and built Peq from 100-byte
// pattern rows the same way; it ran at ~460 cycles a column.
//
// Design: make the step's dependent chain the only thing on the critical
// path.
//   * Staging: a block's kRows rows are one contiguous span of the pattern
//     and of the text.  The block copies them with aligned, coalesced
//     16-byte loads into shared memory as column-major words (stage():
//     word q of row r at [q * kStride + r] holds columns 4q..4q+3), so one
//     32-bit load gives a thread four columns of its row, and a warp's 32
//     loads hit 32 banks (kStride = kRows + 1 also keeps the staging
//     stores spread).  Peq is built from the staged pattern words, then the
//     text is staged in tiles of up to kTileQuads words a row into the
//     same space.
//   * The column loop walks four columns per staged word.  The next word
//     is loaded before the current word's four steps, and each column's
//     Peq row (one shared load for W <= 4) a step ahead of its use, so no
//     load waits in the chain.
//   * Geometry: kRows = 32 rows, one warp, a block: stringz's 16,384 rows
//     make 512 blocks, all resident on the 132 SMs at once (the first
//     design's 128 blocks left four SMs idle).  Measured (bitpar_ab.py,
//     PERF.md): 32, 64 and 128 rows tie at P = 100; at P = 150 and 250, 32
//     is 15-16% faster than 64 or 128.
// Output, tie rule and t_len mask are the first design's, bit for bit.
#include "bitpar_common.cuh"

namespace {

constexpr int kRows = 32;            // rows a block, one a thread
constexpr int kStride = kRows + 1;   // words from one staged row to the next
constexpr int kTileQuads = 128;      // staged words a row a pass: 512 columns

// Copies columns [c0, c0 + 4 nq) of rows [0, nr) of a (rows, ld) byte
// matrix at src to dst[q * kStride + r] = columns c0 + 4q .. c0 + 4q + 3 of
// row r, the first in the low byte.  Each thread takes aligned 16-byte
// chunks that hold a row's bytes (adjacent threads, adjacent chunks) and
// cuts the row's words out of them with funnel shifts.  A chunk is loaded
// only if it holds a byte of the row's columns [c0, min(ld, c0 + 4 nq)),
// so no load leaves the matrix; the bytes of a word past that end are
// unspecified.
__device__ __forceinline__ void stage(uint32_t* dst, const uint8_t* src,
                                      int ld, int nr, int c0, int nq) {
  const int cpr = nq / 4 + 2;   // chunks a row's 4 nq bytes can touch
  for (int i = threadIdx.x; i < nr * cpr; i += blockDim.x) {
    const int r = i / cpr;
    const int l = i - r * cpr;
    const uintptr_t row = reinterpret_cast<uintptr_t>(src) + (size_t)r * ld;
    const uintptr_t a = row + c0;
    const uintptr_t e = row + min(ld, c0 + 4 * nq);
    const uintptr_t base = (a & ~uintptr_t(15)) + 16 * l;
    if (base >= e) continue;
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(base));
    const uint32_t w[5] = {
        v.x, v.y, v.z, v.w,
        base + 16 < e ? __ldg(reinterpret_cast<const uint32_t*>(base + 16))
                      : 0u};
    const int delta = static_cast<int>(a & 15);
    const int q0 = 4 * l - (delta >> 2);   // the word starting in w[0]
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int q = q0 + m;
      if (q >= 0 && q < nq)
        dst[q * kStride + r] = __funnelshift_r(w[m], w[m + 1], 8 * (delta & 3));
    }
  }
}

// the Peq table, then the staged words: the pattern's, or a text tile's
template <int W>
int smem_bytes(int P, int TXT) {
  const int tile = (TXT + 3) / 4 < kTileQuads ? (TXT + 3) / 4 : kTileQuads;
  const int quads = (P + 3) / 4 > tile ? (P + 3) / 4 : tile;
  return bpk::table_bytes<W>(kRows) + quads * kStride * 4;
}

template <int W, bool FREE_START, bool TRACK_POS>
__global__ void __launch_bounds__(kRows)
    bitpar_rows_kernel(const uint8_t* __restrict__ pattern, int P,
                       const uint8_t* __restrict__ text, int TXT,
                       const int* __restrict__ t_len, int B,
                       int* __restrict__ out) {
  using V = typename bpk::PeqVec<W>::T;
  extern __shared__ __align__(16) uint8_t smem[];
  V (*tab)[kRows] = reinterpret_cast<V (*)[kRows]>(smem);
  uint32_t* staged =
      reinterpret_cast<uint32_t*>(smem + bpk::table_bytes<W>(kRows));
  const int r0 = blockIdx.x * kRows;
  const int nr = min(kRows, B - r0);
  const int t = threadIdx.x;
  const uint32_t* own = staged + t;

  stage(staged, pattern + (size_t)r0 * P, P, nr, 0, (P + 3) >> 2);
  __syncthreads();
  const bpk::Peq<W, kRows> peq(tab, own, kStride, P);
  bpk::State<W> s;
  bpk::init(s, P);
  const int tl = t < nr ? min(t_len[r0 + t], TXT) : 0;
  int best = bpk::start_best<TRACK_POS>(P);

  for (int c0 = 0; c0 < TXT; c0 += 4 * kTileQuads) {
    const int nq = min(kTileQuads, (TXT - c0 + 3) >> 2);
    __syncthreads();                    // every staged word has been read
    stage(staged, text + (size_t)r0 * TXT, TXT, nr, c0, nq);
    __syncthreads();
    uint32_t cur = own[0];
    uint32_t eq[W];
    peq.lookup(cur & 0xFFu, eq);
#pragma unroll 1
    for (int q = 0; q < nq; ++q) {
      const uint32_t nxt = q + 1 < nq ? own[(q + 1) * kStride] : 0u;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        uint32_t ahead[W];   // the next column's Peq row
        peq.lookup(((k < 3 ? cur >> (8 * (k + 1)) : nxt)) & 0xFFu, ahead);
        bpk::step<W, FREE_START>(s, eq);
        bpk::offer<TRACK_POS>(best, s.score, c0 + 4 * q + k, tl);
#pragma unroll
        for (int w = 0; w < W; ++w) eq[w] = ahead[w];
      }
      cur = nxt;
    }
  }
  if (t < nr) out[r0 + t] = best;
}

template <int W, bool FREE_START, bool TRACK_POS>
cudaError_t launch(const void* pattern, int P, const void* text, int TXT,
                   const void* t_len, int B, void* out, cudaStream_t stream) {
  // at most 27,136 bytes (W = 16), within the 48 KB a block has without
  // opting in
  const int smem = smem_bytes<W>(P, TXT);
  bitpar_rows_kernel<W, FREE_START, TRACK_POS>
      <<<(B + kRows - 1) / kRows, kRows, smem, stream>>>(
      static_cast<const uint8_t*>(pattern), P,
      static_cast<const uint8_t*>(text), TXT,
      static_cast<const int*>(t_len), B, static_cast<int*>(out));
  return cudaGetLastError();
}

template <int W>
cudaError_t by_flags(int flags, const void* pattern, int P, const void* text,
                     int TXT, const void* t_len, int B, void* out,
                     cudaStream_t s) {
  switch (flags) {
    case 0: return launch<W, false, false>(pattern, P, text, TXT, t_len, B, out, s);
    case 1: return launch<W, true, false>(pattern, P, text, TXT, t_len, B, out, s);
    case 2: return launch<W, false, true>(pattern, P, text, TXT, t_len, B, out, s);
    case 3: return launch<W, true, true>(pattern, P, text, TXT, t_len, B, out, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// pattern (B, P) u8 codes; text (B, TXT) u8 codes; t_len (B,) i32; out
// (B,) i32.  Needs 1 <= P <= 512.  free_start, track_pos: 0 or 1.
extern "C" int bitpar_rows_launch(const void* pattern, int P,
                                  const void* text, int TXT,
                                  const void* t_len, int free_start,
                                  int track_pos, int B, void* out,
                                  void* stream) {
  if (B <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const int flags = (free_start ? 1 : 0) | (track_pos ? 2 : 0);
#define BR_W(W)                                                         \
  case W:                                                               \
    return by_flags<W>(flags, pattern, P, text, TXT, t_len, B, out, s);
  switch ((P + 31) / 32) {
    BR_W(1) BR_W(2) BR_W(3) BR_W(4) BR_W(5) BR_W(6) BR_W(7) BR_W(8)
    BR_W(9) BR_W(10) BR_W(11) BR_W(12) BR_W(13) BR_W(14) BR_W(15) BR_W(16)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BR_W
}
