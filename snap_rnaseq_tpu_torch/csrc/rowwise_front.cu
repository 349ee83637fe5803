// K6: the whole-slot front of the rowwise score — every candidate slot's
// genome window, its read in the slot's orientation, and the anchored
// substitution closed form (mismatch count and log-probability), in one
// pass.
//
// Replaces no TPU kernel: the JAX package's rowwise_score_phase
// (snap_rnaseq_tpu/models/single.py) leaves this front to XLA, which fuses
// it.  Eager torch does not: the port's chain (ops/rowwise_front.py
// rowwise_front_plain, the plain version) writes (slots, n_w, 8) int32
// nibbles, (slots, 100) float rows and a dozen more slot-sized
// intermediates, some 74 GB of traffic a batch of 8.4 M slots.
//
// For slot (r, w) of the (R, W) candidate table, with start
// s = (live ? loc : 0) - M (u32 wrap under BIG, else clamped at 0):
//   win[slot]  (n_w,) words: nibble i is base s + i of the genome (words
//              past the table are padding when pad_past_end, else the last
//              word again; the word after the row's last is padding), the
//              funnel shift of each pair of genome words by s & 7 nibbles;
//   sel[slot]  (P,) codes: the read, or where dir == 1 its reverse
//              complement (comp[code & 7] of the reversed read);
//   ham[slot]  positions i < P where sel[i] differs from window base M + i;
//   logp[slot] the sum over those positions of qlp[r, dir == 1, i], in
//              position order in fp32, plus (P - ham) * log(1 - SNP); only
//              where ham <= M (elsewhere the caller never reads it: -inf).
//
// What bounds it on an H100: bytes.  A slot reads n_w genome words (72
// bytes at P = 100, M = 17; the 64 Mb genome's 32 MB of words stay in L2),
// writes them back aligned plus P bytes of sel and 8 bytes of scalars; the
// compare is 13 words of XOR and popcount.
//
// Design: one block per read row.  The row's forward and reverse-
// complement codes are staged in shared memory once, as bytes (for sel)
// and as packed nibble words (for the compare), so the W slots of the row
// read their pattern from shared memory.  The slots go in tiles of kTile:
//   1. one thread per slot: start word and nibble shift;
//   2. threads over the tile's n_w * ntile output words, neighbouring
//      threads on neighbouring words: two genome loads and one
//      __funnelshift_r per word, stored to win coalesced and kept in
//      shared memory;
//   3. one thread per slot: the text from window nibble M on, a word at a
//      time (one more funnel shift), XOR with the staged pattern, nonzero
//      nibbles counted with __popc; then, only where ham <= M, the
//      mismatched positions' qlp summed in order;
//   4. threads over the tile's sel bytes, four at a time: the tile's sel
//      rows are one contiguous run, stored as coalesced 32-bit words.
// A read code of 16 or more (comp's 255) is a forced mismatch, so the
// nibble compare equals the byte compare for every input.
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;                 // slots staged at a time
constexpr int kMaxP = 512;
constexpr int kMaxPW = kMaxP / 8;         // packed pattern words
constexpr uint32_t kPad = 0x55555555u;    // eight padding nibbles (code 5)

struct Args {
  const uint32_t* genome;
  int n_words;
  int pad_past_end;
  const int* loc;
  const int* dir;
  const uint8_t* live;
  const uint8_t* reads;
  const uint8_t* comp;
  const float* qlp;
  int W, P, M, n_w;
  float log_one_minus_snp;
  uint32_t* win;
  uint8_t* sel;
  int* ham;
  float* logp;
};

__device__ __forceinline__ uint32_t genome_word(const Args& a, int j) {
  if (j < a.n_words) return __ldg(a.genome + j);
  return a.pad_past_end ? kPad : __ldg(a.genome + (a.n_words - 1));
}

// nonzero nibbles of x as one bit each (bit 4k for nibble k)
__device__ __forceinline__ uint32_t nonzero_nibbles(uint32_t x) {
  x |= x >> 1;
  x |= x >> 2;
  return x & 0x11111111u;
}

template <bool BIG>
__global__ void __launch_bounds__(kThreads)
rowwise_front_kernel(Args a) {
  extern __shared__ __align__(16) uint32_t s_win[];   // kTile * n_w words
  __shared__ __align__(4) uint8_t s_codes[2][kMaxP];  // forward, RC
  __shared__ uint32_t s_nib[2][kMaxPW];               // packed codes
  __shared__ uint32_t s_force[2][kMaxPW];             // codes >= 16
  __shared__ int s_wstart[kTile];
  __shared__ int s_shift[kTile];
  __shared__ int s_rc[kTile];

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int P = a.P, W = a.W, M = a.M, n_w = a.n_w;
  const int PW = (P + 7) >> 3;

  const uint8_t* read = a.reads + (size_t)r * P;
  for (int i = tid; i < P; i += kThreads) {
    const uint8_t c = read[i];
    s_codes[0][i] = c;
    s_codes[1][P - 1 - i] = a.comp[c & 7];
  }
  __syncthreads();
  for (int q = tid; q < 2 * PW; q += kThreads) {
    const int d = q >= PW, qq = q - d * PW;
    uint32_t nib = 0, force = 0;
    for (int k = 0; k < 8 && 8 * qq + k < P; ++k) {
      const uint32_t c = s_codes[d][8 * qq + k];
      nib |= (c & 15u) << (4 * k);
      force |= (c >= 16u ? 1u : 0u) << (4 * k);
    }
    s_nib[d][qq] = nib;
    s_force[d][qq] = force;
  }
  // positions past P in the last pattern word count nothing
  const uint32_t last_mask =
      (P & 7) ? 0x11111111u >> (4 * (8 - (P & 7))) : 0x11111111u;
  const int q0 = M >> 3, text_shift = 4 * (M & 7);

  for (int s0 = 0; s0 < W; s0 += kTile) {
    const int nt = min(kTile, W - s0);
    const size_t slot0 = (size_t)r * W + s0;
    if (tid < nt) {
      const size_t slot = slot0 + tid;
      const int l = a.live[slot] ? a.loc[slot] : 0;
      uint32_t start;
      if constexpr (BIG)
        start = (uint32_t)l - (uint32_t)M;      // u32 wrap
      else
        start = (uint32_t)max(l - M, 0);
      s_wstart[tid] = (int)(start >> 3);
      s_shift[tid] = (int)(4 * (start & 7));
      s_rc[tid] = a.dir[slot] == 1;
    }
    __syncthreads();

    // 2. the windows' words
    const int n_out = nt * n_w;
    uint32_t* win = a.win + slot0 * n_w;
    for (int f = tid; f < n_out; f += kThreads) {
      const int t = f / n_w, k = f - t * n_w;
      const int j = s_wstart[t] + k;
      const uint32_t lo = genome_word(a, j);
      const uint32_t hi = k + 1 < n_w ? genome_word(a, j + 1) : kPad;
      const uint32_t w = __funnelshift_r(lo, hi, s_shift[t]);
      s_win[f] = w;
      win[f] = w;
    }
    __syncthreads();

    // 3. the closed form
    if (tid < nt) {
      const uint32_t* wrow = s_win + tid * n_w;
      const int d = s_rc[tid];
      int h = 0;
      for (int q = 0; q < PW; ++q) {
        const int c = q0 + q;
        const uint32_t hi = c + 1 < n_w ? wrow[c + 1] : kPad;
        const uint32_t text = __funnelshift_r(wrow[c], hi, text_shift);
        uint32_t mm = nonzero_nibbles(text ^ s_nib[d][q]) | s_force[d][q];
        if (q == PW - 1) mm &= last_mask;
        h += __popc(mm);
      }
      float lp = -CUDART_INF_F;
      if (h <= M) {
        const float* q_row = a.qlp + ((size_t)r * 2 + d) * P;
        float sum = 0.0f;
        for (int q = 0; q < PW; ++q) {
          const int c = q0 + q;
          const uint32_t hi = c + 1 < n_w ? wrow[c + 1] : kPad;
          const uint32_t text = __funnelshift_r(wrow[c], hi, text_shift);
          uint32_t mm = nonzero_nibbles(text ^ s_nib[d][q]) | s_force[d][q];
          if (q == PW - 1) mm &= last_mask;
          while (mm) {
            const int b = __ffs(mm) - 1;
            sum = __fadd_rn(sum, __ldg(q_row + 8 * q + (b >> 2)));
            mm &= mm - 1;
          }
        }
        lp = __fadd_rn(sum, __fmul_rn((float)(P - h), a.log_one_minus_snp));
      }
      a.ham[slot0 + tid] = h;
      a.logp[slot0 + tid] = lp;
    }

    // 4. sel: the tile's nt * P bytes from byte offset slot0 * P, as
    // aligned 32-bit words with single bytes at the two ends
    uint8_t* out = a.sel + slot0 * P;
    const int n_bytes = nt * P;
    const int head = min(n_bytes, (int)((4 - (slot0 * P & 3)) & 3));
    const int n_words4 = (n_bytes - head) >> 2;
    for (int e = tid; e < head; e += kThreads) {
      const int t = e / P;
      out[e] = s_codes[s_rc[t]][e - t * P];
    }
    uint32_t* out4 = reinterpret_cast<uint32_t*>(out + head);
    for (int v = tid; v < n_words4; v += kThreads) {
      const int e = head + 4 * v;
      int t = e / P, i = e - t * P;
      uint32_t word;
      if (i + 4 <= P && (i & 3) == 0) {
        word = *reinterpret_cast<const uint32_t*>(&s_codes[s_rc[t]][i]);
      } else {
        word = 0;
        for (int b = 0; b < 4; ++b) {
          word |= (uint32_t)s_codes[s_rc[t]][i] << (8 * b);
          if (++i == P) { i = 0; ++t; }
        }
      }
      out4[v] = word;
    }
    for (int e = head + 4 * n_words4 + tid; e < n_bytes; e += kThreads) {
      const int t = e / P;
      out[e] = s_codes[s_rc[t]][e - t * P];
    }
    __syncthreads();      // the next tile reuses the slot arrays
  }
}

}  // namespace

// genome (n_words,) packed u32 words; loc, dir (R, W) i32; live (R, W)
// bool; reads (R, P) u8 codes below 8; comp (8,) u8; qlp (R, 2, P) f32;
// n_w = ceil((P + 2M) / 8) + 1.  Outputs: win (R * W, n_w) u32 (int32
// bits), sel (R * W, P) u8, ham (R * W,) i32, logp (R * W,) f32.
extern "C" int rowwise_front_launch(
    const void* genome, int n_words, int pad_past_end, const void* loc,
    const void* dir, const void* live, const void* reads, const void* comp,
    const void* qlp, int R, int W, int P, int M, int n_w, int big,
    float log_one_minus_snp, void* win, void* sel, void* ham, void* logp,
    void* stream) {
  if (R <= 0 || W <= 0) return 0;
  if (P < 1 || P > kMaxP || M < 0 || n_words < 1 ||
      n_w != (P + 2 * M + 7) / 8 + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)kTile * n_w * sizeof(uint32_t);
  if (smem > 40 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const uint32_t*>(genome), n_words, pad_past_end,
               static_cast<const int*>(loc), static_cast<const int*>(dir),
               static_cast<const uint8_t*>(live),
               static_cast<const uint8_t*>(reads),
               static_cast<const uint8_t*>(comp),
               static_cast<const float*>(qlp), W, P, M, n_w,
               log_one_minus_snp, static_cast<uint32_t*>(win),
               static_cast<uint8_t*>(sel), static_cast<int*>(ham),
               static_cast<float*>(logp)};
  auto s = static_cast<cudaStream_t>(stream);
  if (big)
    rowwise_front_kernel<true><<<R, kThreads, smem, s>>>(a);
  else
    rowwise_front_kernel<false><<<R, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
