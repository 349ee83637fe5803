// The warp-per-row banded Landau-Vishkin loop shared by K1 (lv_lanes.cu),
// K3 (lv_cigar.cu) and K5 (lv_onehot.cu): one warp per candidate row,
// lanes over diagonals.  The kernels differ in two compile-time policies.
//
// How a lane extends its diagonal to the next mismatch, the `Ext` type:
//   * XorRun (below; K1 and K3) compares four bytes at a time (XOR +
//     __ffs, lvk::extend_run) over the staged rows and needs no scratch;
//   * K5's MismatchMasks (lv_onehot.cu) first builds one 32-bit mismatch
//     mask per diagonal and 32 positions in the warp's scratch, then
//     extends by __ffs over them.
// An Ext is constructed by every lane of the warp after the rows are
// staged (so it can build its tables, lane-strided) and provides
//   static int scratch_bytes(int P, int e_max)   bytes of its scratch
//   int operator()(int d, int p, int end) const  first q in [p, end) with
//       q >= free and pat[q] != txt[q + d], else end (d = diagonal index,
//       0..D-1; txt holds e_max leading sentinels).
//
// What a row writes, the `Out` type: NoScript (K1, K5) the five scalars;
// Script (K3) also the start run and the edit script the backtrace
// recovered and, when asked, the whole L and action tables.  NoScript
// compiles to the loop and lane-0 store of the scalar kernels alone.
//
// Semantics are lv_common.cuh's (snap_rnaseq_tpu/ops/lv.py
// _lv_distance_jax).  Per row:
//   * the pattern and the text (e_max sentinels, the text masked to t_len,
//     sentinels) are staged in the warp's slice of shared memory, with
//     slack after each row for four-byte loads;
//   * a lane owns diagonal `lane` and, where D = 2 e_max + 1 > 32, also
//     `lane + 32`; a level reads its neighbours' L by __shfl_sync (diagonal
//     31 borders 32 across the two slots: at K3's e_max 31 that is the
//     centre and its right neighbour), extends in band, and finds its
//     winner as the warp's minimum of prio[d] * D + d (__reduce_min_sync:
//     the lowest rank, as the plain version's first argmin);
//   * every level's int16 L row goes to shared memory; the row stops at
//     its winning level (or k), and lane 0 runs lvk::backtrace over the
//     level rows, adding logp in the plain version's order.
// Warps per block are sized from the shapes (at most the caller's cap,
// MAX_WARPS unless given, within SMEM_BUDGET); a shape whose one row does
// not fit is refused at launch.
#pragma once

#include "lv_common.cuh"

namespace lvw {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int MAX_WARPS = 8;
constexpr int SMEM_BUDGET = 160 * 1024;
constexpr int SMEM_MAX = 227 * 1024;

// the launch arguments of K1, K3 and K5 (K3's C signature adds its
// Script outputs)
struct Args {
  const uint8_t* pattern;
  const int* p_len;
  const uint8_t* text;
  const int* t_len;
  const int* k;
  const float* qlp;
  const int* free_len;
  const int* prio;
  int B, P, T, e_max;
  lvk::Consts cs;
  int* dist;
  int* e_fin;
  int* d_fin;
  float* logp;
  int* net;
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

// byte offsets within a warp's slice of shared memory: the level table,
// the staged pattern and text rows, the extension's scratch, the output
// policy's scratch; its size
struct Layout {
  int lt, pat, txt, ext, out, warp;
};

__host__ __device__ inline int pat_bytes(int P) {
  return lvk::round4(P + lvk::ROW_SLACK);
}

__host__ __device__ inline int txt_bytes(int P, int e_max) {
  return lvk::round4(P + 2 * e_max + lvk::ROW_SLACK);
}

__host__ __device__ inline Layout layout(int P, int e_max, int ext_bytes,
                                         int out_bytes) {
  const int D = 2 * e_max + 1;
  Layout l;
  l.lt = 0;
  l.pat = lvk::round4((e_max + 1) * D * 2);
  l.txt = l.pat + pat_bytes(P);
  l.ext = align16(l.txt + txt_bytes(P, e_max));
  l.out = l.ext + ext_bytes;
  l.warp = align16(l.out + out_bytes);
  return l;
}

// the level table in shared memory, for lvk::backtrace
struct SharedTab {
  const int16_t* l;
  int D;
  __device__ int L(int e, int d) const { return l[e * D + d]; }
};

// K1's and K3's extension: the four-byte XOR run over the staged rows
// (the `bits` formulation of the TPU kernels)
struct XorRun {
  const uint8_t* pat;
  const uint8_t* txt;
  int free_len;

  __host__ __device__ static int scratch_bytes(int, int) { return 0; }

  __device__ XorRun(const uint8_t* pat_, const uint8_t* txt_, uint8_t*, int,
                    int, int free_len_, int)
      : pat(pat_), txt(txt_), free_len(free_len_) {}

  // diagonal d's text row starts at txt + d (txt + e_max + (d - e_max))
  __device__ int operator()(int d, int p, int end) const {
    return lvk::extend_run(pat, txt + d, p, end, free_len);
  }
};

// K1 and K5 write the five scalars alone
struct NoScript {
  static constexpr bool SCRIPT = false;
  static constexpr int BYTES = 0;
};

// K3's outputs besides the scalars: start_run (B,); acts, matched
// (B, e_max), -1 / 0 past the final level; L, A (B, e_max+1, D), both
// null unless asked for.  BYTES: the warp's shared copy of the script
// (int8 acts[32], int16 matched[32]) that lane 0's backtrace fills.
struct Script {
  static constexpr bool SCRIPT = true;
  static constexpr int BYTES = 32 + 2 * 32;
  int* start_run;
  int* acts;
  int* matched;
  int* L;
  int* A;
};

template <int NS, class Ext, class Out = NoScript>
__device__ void lv_row(const Args& a, uint8_t* smem, const Out& out = Out()) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= a.B) return;               // whole warps; no block barrier below

  const int P = a.P, e_max = a.e_max;
  const int D = 2 * e_max + 1;
  const int center = e_max;
  const Layout lay = layout(P, e_max, Ext::scratch_bytes(P, e_max),
                            Out::BYTES);
  uint8_t* base = smem + warp * lay.warp;
  int16_t* lt = reinterpret_cast<int16_t*>(base + lay.lt);
  uint8_t* pat = base + lay.pat;
  uint8_t* txt = base + lay.txt;

  const int p_len = a.p_len[row];
  const int t_len = a.t_len[row];
  const int k = min(a.k[row], e_max);
  const int free_len = a.free_len ? a.free_len[row] : 0;

  // stage the pattern (zeros after P) and the sentinel-padded, masked text
  // (txt[j] is text position j - e_max, as the TPU kernel's textp)
  const int tl = min(t_len, a.T);
  for (int j = lane; j < pat_bytes(P); j += 32)
    pat[j] = j < P ? a.pattern[(size_t)row * P + j] : 0;
  for (int j = lane; j < txt_bytes(P, e_max); j += 32) {
    const int t = j - e_max;
    txt[j] = (t >= 0 && t < tl) ? a.text[(size_t)row * a.T + t] : 255;
  }
  __syncwarp();
  const Ext ext(pat, txt, base + lay.ext, P, e_max, free_len, lane);
  __syncwarp();

  // level 0: only the centre diagonal, run to its first mismatch
  const int end0 = min(p_len, t_len);
  const int first_mm = ext(center, 0, end0);
  int Lv[NS], prio[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int d = lane + 32 * s;
    prio[s] = d < D ? a.prio[d] : 0;
    Lv[s] = d == center ? first_mm : -2;
    if (d < D) lt[d] = static_cast<int16_t>(Lv[s]);
  }
  const bool perfect = first_mm >= end0;
  const int perfect_dist = max(p_len - end0, 0);
  const bool perfect_ok = perfect && perfect_dist <= k;
  bool done = perfect;
  int dist = perfect_ok ? perfect_dist : -1, e_fin = 0, d_fin = 0;

  for (int e = 1; e <= e_max && !done; ++e) {
    // neighbours of the previous level: left = L[d-1], right = L[d+1]
    int left[NS], right[NS];
    const int up0 = __shfl_up_sync(FULL, Lv[0], 1);
    const int dn0 = __shfl_down_sync(FULL, Lv[0], 1);
    left[0] = lane == 0 ? -2 : up0;
    if constexpr (NS == 1) {
      right[0] = dn0 + 1;
    } else {
      // diagonal 31 (lane 31, slot 0) borders diagonal 32 (lane 0, slot 1)
      const int up1 = __shfl_up_sync(FULL, Lv[1], 1);
      const int dn1 = __shfl_down_sync(FULL, Lv[1], 1);
      const int last0 = __shfl_sync(FULL, Lv[0], 31);
      const int first1 = __shfl_sync(FULL, Lv[1], 0);
      right[0] = (lane == 31 ? first1 : dn0) + 1;
      left[1] = lane == 0 ? last0 : up1;
      right[1] = dn1 + 1;
    }
    int key = 0x7FFFFFFF;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int d = lane + 32 * s;
      if (d >= D) continue;
      const int r = d == D - 1 ? -1 : right[s];
      int best = max(max(Lv[s] + 1, left[s]), r);
      const int dd = d - center;
      const bool in_band = abs(dd) <= e;
      if (!in_band) {
        best = -2;
      } else if (best >= 0) {
        const int end_d = min(p_len, t_len - dd);
        if (best < end_d) best = ext(d, best, end_d);
      }
      if (in_band && best >= p_len && e <= k)
        key = min(key, prio[s] * D + d);
      Lv[s] = best;
      lt[e * D + d] = static_cast<int16_t>(best);
    }
    key = __reduce_min_sync(FULL, key);
    if (key != 0x7FFFFFFF) {
      dist = e;
      e_fin = e;
      d_fin = key % D - center;
    }
    done = key != 0x7FFFFFFF || e >= k;
  }
  __syncwarp();

  if constexpr (Out::SCRIPT) {
    // K3: lane 0's backtrace leaves the script in the warp's shared memory
    // and the scalars in global memory; then the lanes store the script
    // and, when asked, the tables
    int8_t* acts = reinterpret_cast<int8_t*>(base + lay.out);
    int16_t* matched = reinterpret_cast<int16_t*>(base + lay.out + 32);
    const SharedTab tab{lt, D};
    if (lane == 0) {
      float logp;
      int net;
      lvk::backtrace(tab, D, e_max, p_len, free_len, dist, e_fin, d_fin,
                     perfect, perfect_ok,
                     a.qlp ? a.qlp + (size_t)row * P : nullptr, a.cs, acts,
                     matched, &logp, &net);
      a.dist[row] = dist;
      a.e_fin[row] = e_fin;
      a.d_fin[row] = d_fin;
      a.logp[row] = logp;
      a.net[row] = net;
      out.start_run[row] = first_mm;
    }
    __syncwarp();
    // levels 1..e_max; -1 / 0 past the final level, as ops/lv.py
    // _recover_actions returns them
    for (int e = lane + 1; e <= e_max; e += 32) {
      const bool on = e <= e_fin;
      out.acts[(size_t)row * e_max + e - 1] = on ? acts[e] : -1;
      out.matched[(size_t)row * e_max + e - 1] = on ? matched[e] : 0;
    }
    if (out.L != nullptr) {
      // the row's last level: where it won, or k (at least 1) when none
      // won, or 0 for the level-0 early-out; later levels repeat it, as
      // the TPU kernel's where(done, L, best), and a level's actions are
      // taken from the level before it (itself repeated past the last)
      const int last = perfect ? 0 : (e_fin > 0 ? e_fin : max(k, 1));
      const int n = (e_max + 1) * D;
      int* L_row = out.L + (size_t)row * n;
      int* A_row = out.A + (size_t)row * n;
      for (int i = lane; i < n; i += 32) {
        const int e = i / D, d = i - e * D;
        L_row[i] = tab.L(min(e, last), d);
        A_row[i] = e == 0 ? 0 : lvk::act_from(tab, min(e - 1, last), d, D);
      }
    }
  } else if (lane == 0) {
    const SharedTab tab{lt, D};
    int8_t acts[32];
    int16_t matched[32];
    float logp;
    int net;
    lvk::backtrace(tab, D, e_max, p_len, free_len, dist, e_fin, d_fin,
                   perfect, perfect_ok,
                   a.qlp ? a.qlp + (size_t)row * P : nullptr, a.cs, acts,
                   matched, &logp, &net);
    a.dist[row] = dist;
    a.e_fin[row] = e_fin;
    a.d_fin[row] = d_fin;
    a.logp[row] = logp;
    a.net[row] = net;
  }
}

// The launch arguments from the C interface the three kernels export:
// pattern (B, P) u8; text (B, T) u8 (unpadded, masked to t_len in-kernel);
// p_len, t_len, k, free (B,) i32 (free may be null); qlp (B, P) f32 or
// null (then every quality is qconst); prio (D,) i32.
inline Args make_args(const void* pattern, const void* p_len,
                      const void* text, const void* t_len, const void* k,
                      const void* qlp, const void* free_len,
                      const void* prio, int B, int P, int T, int e_max,
                      float log_gap_open, float log_gap_extend,
                      float log_one_minus_snp, float qconst, void* dist,
                      void* e_fin, void* d_fin, void* logp, void* net) {
  return Args{static_cast<const uint8_t*>(pattern),
              static_cast<const int*>(p_len),
              static_cast<const uint8_t*>(text),
              static_cast<const int*>(t_len),
              static_cast<const int*>(k),
              static_cast<const float*>(qlp),
              static_cast<const int*>(free_len),
              static_cast<const int*>(prio),
              B, P, T, e_max,
              lvk::Consts{log_gap_open, log_gap_extend, log_one_minus_snp,
                          qconst},
              static_cast<int*>(dist), static_cast<int*>(e_fin),
              static_cast<int*>(d_fin), static_cast<float*>(logp),
              static_cast<int*>(net)};
}

inline bool valid_shape(const Args& a) {
  return a.e_max >= 1 && a.e_max <= 31 && a.P >= 1 && a.P <= 32767;
}

// Launches `kernel` (a __global__ taking Args and then `extra`,
// instantiated for the number of diagonal slots D needs) with whole warps
// per row, up to `max_warps` rows a block within SMEM_BUDGET; raises the
// kernel's dynamic shared memory limit where it needs more than 48 KB.
template <class Ext, class Out = NoScript, class... Extra>
cudaError_t launch(void (*kernel)(Args, Extra...), const Args& a,
                   cudaStream_t stream, int max_warps = MAX_WARPS,
                   Extra... extra) {
  const int per_warp = layout(a.P, a.e_max, Ext::scratch_bytes(a.P, a.e_max),
                              Out::BYTES).warp;
  if (per_warp > SMEM_MAX) return cudaErrorInvalidValue;
  int warps = max_warps < 1 ? 1 : max_warps;
  while (warps > 1 && warps * per_warp > SMEM_BUDGET) --warps;
  const size_t smem = (size_t)warps * per_warp;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (a.B + warps - 1) / warps;
  Args arg = a;
  void* params[] = {&arg, &extra...};
  return cudaLaunchKernel(reinterpret_cast<const void*>(kernel),
                          dim3(blocks), dim3(warps * 32), params, smem,
                          stream);
}

}  // namespace lvw
