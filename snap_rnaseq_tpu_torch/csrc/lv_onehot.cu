// K5: LV-lanes, next-mismatch-table form — the same function as K1
// (lv_lanes.cu): banded Landau-Vishkin distance up to min(k, e_max) with a
// per-row free prefix, priority-ordered diagonal ties and the fused
// probability backtrace; five scalars out per row (dist, e_fin, d_fin,
// logp, net).
//
// Replaces the TPU kernel snap_rnaseq_tpu/ops/lv_pallas.py _lv_kernel_lanes
// (impl="onehot" of lv_distance_pallas_lanes), which the JAX package runs
// in place of K1 when SNAP_TPU_LV_LANES is not "bits"; ops/lv.py makes the
// same choice.  The TPU kernel builds, per diagonal, a next-mismatch table
// by a suffix-min over the pattern, so that extending a diagonal is one
// lookup instead of a scan.
//
// What bounds it on an H100: as for K1, latency, not bytes or arithmetic
// throughput (a row reads ~P + T bytes and writes 20).  Design, one warp
// per row, lanes over diagonals (D = 2 e_max + 1 <= 63, so a lane owns one
// or two diagonals):
//   * the row's pattern and its text (e_max sentinels, the text masked to
//     t_len, sentinels) are staged in the warp's shared memory;
//   * each lane builds the next-mismatch rows of its diagonals, int16, in
//     shared memory by one backward scan over the pattern (positions below
//     the free prefix always match); the row stride is an odd number of
//     words, so the 32 lanes' writes of one column hit 32 banks;
//   * a level reads its neighbours' L by __shfl_sync, extends with one
//     shared-memory load clipped to end_d, and finds its winner as the
//     warp's minimum of prio[d] * D + d (__reduce_min_sync);
//   * every level's L row goes to shared memory; one lane then runs the
//     backtrace (lv_common.cuh) on it and sums logp in the plain order.
// Warps per block are sized from the shapes so the tables fit; a shape
// whose one row does not fit is refused at launch, never spilled.
#include "lv_common.cuh"

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int MAX_WARPS = 8;
constexpr int SMEM_BUDGET = 160 * 1024;
constexpr int SMEM_MAX = 227 * 1024;

// next-mismatch row stride in int16 entries: >= P, even, and an odd number
// of 4-byte words
__host__ __device__ inline int nm_stride(int P) {
  int s = (P + 1) & ~1;
  if ((s / 2) % 2 == 0) s += 2;
  return s;
}

struct Layout {
  int nm, lt, pat, txt, warp;   // byte offsets within a warp's slice, size
};

__host__ __device__ inline Layout layout(int P, int e_max) {
  const int D = 2 * e_max + 1;
  Layout l;
  l.nm = 0;
  l.lt = l.nm + D * nm_stride(P) * 2;
  l.pat = l.lt + lvk::round4((e_max + 1) * D * 2);
  l.txt = l.pat + lvk::round4(P);
  l.warp = l.txt + lvk::round4(P + 2 * e_max);
  l.warp = (l.warp + 15) & ~15;
  return l;
}

// the level table in shared memory, for lvk::backtrace
struct SharedTab {
  const int16_t* l;
  int D;
  __device__ int L(int e, int d) const { return l[e * D + d]; }
};

template <int NS>
__global__ void lv_onehot_kernel(const uint8_t* __restrict__ pattern,
                                 const int* __restrict__ p_len_g,
                                 const uint8_t* __restrict__ text,
                                 const int* __restrict__ t_len_g,
                                 const int* __restrict__ k_g,
                                 const float* __restrict__ qlp,
                                 const int* __restrict__ free_g,
                                 const int* __restrict__ prio_g, int B, int P,
                                 int T, int e_max, lvk::Consts cs,
                                 int* __restrict__ dist_out,
                                 int* __restrict__ e_fin_out,
                                 int* __restrict__ d_fin_out,
                                 float* __restrict__ logp_out,
                                 int* __restrict__ net_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= B) return;                 // whole warps; no block barrier below

  const int D = 2 * e_max + 1;
  const int center = e_max;
  const Layout lay = layout(P, e_max);
  uint8_t* base = smem + warp * lay.warp;
  int16_t* nm = reinterpret_cast<int16_t*>(base + lay.nm);
  int16_t* lt = reinterpret_cast<int16_t*>(base + lay.lt);
  uint8_t* pat = base + lay.pat;
  uint8_t* txt = base + lay.txt;
  const int NMS = nm_stride(P);

  const int p_len = p_len_g[row];
  const int t_len = t_len_g[row];
  const int k = min(k_g[row], e_max);
  const int free_len = free_g ? free_g[row] : 0;

  // stage the pattern and the sentinel-padded, masked text (txt[j] is text
  // position j - e_max, as the TPU kernel's textp)
  const int tl = min(t_len, T);
  for (int j = lane; j < P; j += 32) pat[j] = pattern[(size_t)row * P + j];
  for (int j = lane; j < P + 2 * e_max; j += 32) {
    const int t = j - e_max;
    txt[j] = (t >= 0 && t < tl) ? text[(size_t)row * T + t] : 255;
  }
  __syncwarp();

  // next-mismatch rows: nm[d][p] = the first q >= p with q >= free and
  // txt[q + d] != pat[q], else P
  int prio[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int d = lane + 32 * s;
    prio[s] = d < D ? prio_g[d] : 0;
    if (d >= D) continue;
    int16_t* nrow = nm + d * NMS;
    int cur = P;
    for (int p = P - 1; p >= 0; --p) {
      if (p >= free_len && txt[p + d] != pat[p]) cur = p;
      nrow[p] = static_cast<int16_t>(cur);
    }
  }
  __syncwarp();

  // level 0: only the centre diagonal, run to its first mismatch
  const int end0 = min(p_len, t_len);
  const int first_mm = min(static_cast<int>(nm[center * NMS]), end0);
  int Lv[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int d = lane + 32 * s;
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
        if (best < end_d) best = min(static_cast<int>(nm[d * NMS + best]),
                                     end_d);
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

  if (lane == 0) {
    const SharedTab tab{lt, D};
    int8_t acts[32];
    int16_t matched[32];
    float logp;
    int net;
    lvk::backtrace(tab, D, e_max, p_len, free_len, dist, e_fin, d_fin,
                   perfect, perfect_ok, qlp ? qlp + (size_t)row * P : nullptr,
                   cs, acts, matched, &logp, &net);
    dist_out[row] = dist;
    e_fin_out[row] = e_fin;
    d_fin_out[row] = d_fin;
    logp_out[row] = logp;
    net_out[row] = net;
  }
}

template <int NS>
cudaError_t launch(const void* pattern, const void* p_len, const void* text,
                   const void* t_len, const void* k, const void* qlp,
                   const void* free_len, const void* prio, int B, int P,
                   int T, int e_max, lvk::Consts cs, void* dist, void* e_fin,
                   void* d_fin, void* logp, void* net, cudaStream_t stream) {
  const int per_warp = layout(P, e_max).warp;
  if (per_warp > SMEM_MAX) return cudaErrorInvalidValue;
  int warps = MAX_WARPS;
  while (warps > 1 && warps * per_warp > SMEM_BUDGET) --warps;
  const size_t smem = (size_t)warps * per_warp;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lv_onehot_kernel<NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (B + warps - 1) / warps;
  lv_onehot_kernel<NS><<<blocks, warps * 32, smem, stream>>>(
      static_cast<const uint8_t*>(pattern), static_cast<const int*>(p_len),
      static_cast<const uint8_t*>(text), static_cast<const int*>(t_len),
      static_cast<const int*>(k), static_cast<const float*>(qlp),
      static_cast<const int*>(free_len), static_cast<const int*>(prio), B, P,
      T, e_max, cs, static_cast<int*>(dist), static_cast<int*>(e_fin),
      static_cast<int*>(d_fin), static_cast<float*>(logp),
      static_cast<int*>(net));
  return cudaGetLastError();
}

}  // namespace

// The same arguments as lv_lanes_launch (lv_lanes.cu): pattern (B, P) u8;
// text (B, T) u8 (unpadded, masked to t_len in-kernel); p_len, t_len, k,
// free (B,) i32 (free may be null); qlp (B, P) f32 or null (then every
// quality is qconst); prio (D,) i32.
extern "C" int lv_onehot_launch(const void* pattern, const void* p_len,
                                const void* text, const void* t_len,
                                const void* k, const void* qlp,
                                const void* free_len, const void* prio, int B,
                                int P, int T, int e_max, float log_gap_open,
                                float log_gap_extend, float log_one_minus_snp,
                                float qconst, void* dist, void* e_fin,
                                void* d_fin, void* logp, void* net,
                                void* stream) {
  if (B <= 0) return 0;
  if (e_max < 1 || e_max > 31 || P < 1 || P > 32767)
    return static_cast<int>(cudaErrorInvalidValue);
  const lvk::Consts cs{log_gap_open, log_gap_extend, log_one_minus_snp,
                       qconst};
  auto s = static_cast<cudaStream_t>(stream);
  if (2 * e_max + 1 <= 32)
    return launch<1>(pattern, p_len, text, t_len, k, qlp, free_len, prio, B,
                     P, T, e_max, cs, dist, e_fin, d_fin, logp, net, s);
  return launch<2>(pattern, p_len, text, t_len, k, qlp, free_len, prio, B, P,
                   T, e_max, cs, dist, e_fin, d_fin, logp, net, s);
}
