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
// What bounds it on an H100: the integer instruction rate, as K2 (the
// column step's W words of boolean work per column, bitpar_common.cuh,
// against TXT + P bytes per row).  Design: one row per thread, PV/MV in registers, the
// Peq rows in the block's shared table (bitpar_common.cuh); each thread
// reads its own text row a byte at a time (a warp's loads touch 32 rows,
// which L1 then serves for the next columns).
#include "bitpar_common.cuh"

namespace {

template <int W, bool FREE_START, bool TRACK_POS>
__global__ void bitpar_rows_kernel(const uint8_t* __restrict__ pattern,
                                   int P, const uint8_t* __restrict__ text,
                                   int TXT, const int* __restrict__ t_len,
                                   int B, int* __restrict__ out) {
  __shared__ typename bpk::PeqVec<W>::T tab[bpk::kCodes][bpk::kThreads];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const bpk::Peq<W> peq(tab, pattern + (size_t)i * P, P);
  bpk::State<W> s;
  bpk::init(s, P);
  const int tl = t_len[i];
  const uint8_t* tr = text + (size_t)i * TXT;
  int best = bpk::start_best<TRACK_POS>(P);
  uint32_t eq[W];
  for (int j = 0; j < TXT; ++j) {
    peq.lookup(tr[j], eq);
    bpk::step<W, FREE_START>(s, eq);
    bpk::offer<TRACK_POS>(best, s.score, j, tl);
  }
  out[i] = best;
}

template <int W, bool FREE_START, bool TRACK_POS>
cudaError_t launch(const void* pattern, int P, const void* text, int TXT,
                   const void* t_len, int B, void* out, cudaStream_t stream) {
  const int threads = bpk::kThreads;
  bitpar_rows_kernel<W, FREE_START, TRACK_POS>
      <<<(B + threads - 1) / threads, threads, 0, stream>>>(
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
// (B,) i32.  Needs 1 <= P <= 128.  free_start, track_pos: 0 or 1.
extern "C" int bitpar_rows_launch(const void* pattern, int P,
                                  const void* text, int TXT,
                                  const void* t_len, int free_start,
                                  int track_pos, int B, void* out,
                                  void* stream) {
  if (B <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const int flags = (free_start ? 1 : 0) | (track_pos ? 2 : 0);
  switch ((P + 31) / 32) {
    case 1: return by_flags<1>(flags, pattern, P, text, TXT, t_len, B, out, s);
    case 2: return by_flags<2>(flags, pattern, P, text, TXT, t_len, B, out, s);
    case 3: return by_flags<3>(flags, pattern, P, text, TXT, t_len, B, out, s);
    case 4: return by_flags<4>(flags, pattern, P, text, TXT, t_len, B, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
