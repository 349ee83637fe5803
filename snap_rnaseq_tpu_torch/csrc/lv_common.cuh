// Banded Landau-Vishkin pieces shared by the LV kernels, which all run
// one warp per row over the level loop of lv_warp.cuh:
//   * `backtrace` (over any table with L(e, d)) serves K1 (lv_lanes.cu),
//     K3 (lv_cigar.cu) and K5 (lv_onehot.cu): lane 0 runs it over the
//     level rows its warp wrote to shared memory; `act_from` also gives K3
//     its action table;
//   * `extend_run` (the four-byte XOR run) is the extension of K1 and K3;
//     K5 extends over its per-diagonal mismatch masks instead.
//
// Semantics follow snap_rnaseq_tpu/ops/lv.py _lv_distance_jax exactly:
//   * L[e][d] = furthest pattern index reached with e edits on diagonal d
//     (text index = pattern index + d - e_max), level 0 only on the centre;
//   * each level takes the best of up (X), left (D) and right (I) in that
//     order of precedence, then extends along the diagonal to the next
//     mismatch, capped at end_d = min(p_len, t_len - (d - e_max));
//   * pattern positions below the per-row free prefix match any text byte;
//   * the first level where some in-band diagonal reaches p_len (and e <= k)
//     wins, the diagonal chosen by the lowest rank in `prio` (_d_order);
//   * the perfect-match early-out at level 0, k clamped to e_max;
//   * the probability backtrace: actions and matched runs recovered in
//     reverse, then a forward walk adding the phred log-probability at each
//     substitution offset (the index clamped to [0, p_len-1], the
//     reference's BUGBUG clamp) and gap open/extend log-probabilities, in
//     the same order of float additions as the plain version.
//
// Mismatches are found four bytes at a time (K1, K3): the pattern row and
// the text row (with e_max leading sentinels, as the TPU kernel's textp)
// sit in shared memory, a 32-bit XOR of the two compares four positions,
// and __ffs of the XOR gives the first mismatching byte.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lvk {

constexpr int ACT_X = 0;
constexpr int ACT_D = 1;
constexpr int ACT_I = 2;
constexpr float NEG_INF = -1e30f;
constexpr int ROW_SLACK = 8;   // bytes after each shared row for word loads

struct Consts {
  float log_gap_open, log_gap_extend, log_one_minus_snp, qconst;
};

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// four bytes starting at s (any alignment) from shared memory
__device__ __forceinline__ uint32_t load4(const uint8_t* s) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(s);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
  return __funnelshift_r(w[0], w[1], static_cast<uint32_t>(a & 3) * 8u);
}

// First q in [p, end) with pat[q] != txt_d[q] and q >= free, else end.
__device__ __forceinline__ int extend_run(const uint8_t* pat,
                                          const uint8_t* txt_d, int p,
                                          int end, int free_len) {
  for (int q = p; q < end; q += 4) {
    uint32_t x = load4(pat + q) ^ load4(txt_d + q);
    const int nf = free_len - q;
    if (nf > 0) x = nf >= 4 ? 0u : (x & (0xFFFFFFFFu << (8 * nf)));
    if (x) {
      const int r = q + ((__ffs(x) - 1) >> 3);
      return r < end ? r : end;
    }
  }
  return end;
}

// The action a level takes at diagonal d, from the previous level `prev`
// alone: the best of up (X), left (D), right (I), first wins ties.  Tab is
// any table with L(e, d).
template <class Tab>
__device__ __forceinline__ int act_from(const Tab& tab, int prev, int d,
                                        int D) {
  const int up = tab.L(prev, d) + 1;
  const int left = d > 0 ? tab.L(prev, d - 1) : -2;
  const int right = d < D - 1 ? tab.L(prev, d + 1) + 1 : -1;
  int act = ACT_X, best = up;
  if (left > best) { best = left; act = ACT_D; }
  if (right > best) act = ACT_I;
  return act;
}

// The probability backtrace over a finished table (levels 0..e_fin of any
// Tab with L(e, d)): phase 1 recovers, in reverse, the action and matched
// run of each level 1..e_fin into acts/matched; phase 2 walks them forward
// for the log probability and the net indel; then the free-prefix,
// perfect-match and failure rules of the plain version.
template <class Tab>
__device__ void backtrace(const Tab& tab, int D, int e_max, int p_len,
                          int free_len, int dist, int e_fin, int d_fin,
                          bool perfect, bool perfect_ok, const float* qlp,
                          const Consts& cs, int8_t* acts, int16_t* matched,
                          float* logp_out, int* net_out) {
  const int center = e_max;
  // phase 1: reverse over levels, recovering action + matched run; the
  // action at (e, d) is a function of level e-1, recomputed here
  auto clip = [D](int x) { return x < 0 ? 0 : (x > D - 1 ? D - 1 : x); };
  int cur_d = d_fin;
  for (int e = e_fin; e >= 1; --e) {
    const int dd = clip(cur_d + center);
    const int act = act_from(tab, e - 1, dd, D);
    const int l_here = tab.L(e, dd);
    int m;
    if (act == ACT_I) m = l_here - tab.L(e - 1, clip(cur_d + 1 + center)) - 1;
    else if (act == ACT_D) m = l_here - tab.L(e - 1, clip(cur_d - 1 + center));
    else m = l_here - tab.L(e - 1, dd) - 1;
    cur_d += act == ACT_I ? 1 : (act == ACT_D ? -1 : 0);
    acts[e] = static_cast<int8_t>(act);
    matched[e] = static_cast<int16_t>(m);
  }

  // phase 2: forward walk, log probability + net indel
  const int qmax = p_len - 1 > 0 ? p_len - 1 : 0;
  int offset = tab.L(0, center);
  float logp = 0.f;
  int net = 0, prev_act = -1;
  bool run_open = false;
  for (int e = 1; e <= e_fin; ++e) {
    const int act = acts[e];
    const int m = matched[e];
    const bool cont = run_open && act == prev_act;
    const bool is_indel = act == ACT_I || act == ACT_D;
    float add;
    if (is_indel) {
      add = cont ? cs.log_gap_extend : cs.log_gap_open;
    } else {
      const int qi = offset < 0 ? 0 : (offset > qmax ? qmax : offset);
      add = qlp ? qlp[qi] : cs.qconst;
    }
    logp = __fadd_rn(logp, add);
    offset += act == ACT_D ? -1 : 1;
    net += act == ACT_I ? 1 : (act == ACT_D ? -1 : 0);
    offset += m;
    run_open = m == 0;
    prev_act = act;
  }
  logp = __fadd_rn(logp, __fmul_rn(static_cast<float>(p_len - e_fin),
                                   cs.log_one_minus_snp));
  logp = __fsub_rn(logp, __fmul_rn(static_cast<float>(free_len),
                                   cs.log_one_minus_snp));
  if (perfect) {
    logp = perfect_ok ? __fmul_rn(static_cast<float>(p_len - free_len),
                                  cs.log_one_minus_snp)
                      : NEG_INF;
    net = 0;
  }
  if (dist < 0) logp = NEG_INF;
  *logp_out = logp;
  *net_out = net;
}

}  // namespace lvk
