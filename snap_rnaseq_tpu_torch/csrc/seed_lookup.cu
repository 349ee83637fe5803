// K7: the cuckoo seed phase — pack every scheduled seed of a read batch,
// optionally keep only each read's first N valid positions, canonicalise
// and hash each seed, look it up in the two-level bucket layout and its
// stash, and decode both value halves into hit counts and list bases, in
// one pass.
//
// Replaces no TPU kernel: the JAX package's seed phase
// (snap_rnaseq_tpu/models/single.py seed_phase, ops/lookup.py pack_seeds
// and lookup_seeds_cuckoo) is left to XLA, which fuses it.  Eager torch
// does not: the port's chain (models/single.py seed_phase_plain, the plain
// version) writes (reads, seeds, 20) int32 windows, two (reads, seeds, 32)
// bucket-row copies and (reads, seeds, 128) stash compares, two of them
// int64: tens of GB of traffic a batch of 6.3 M seeds.
//
// For read r and output column c (c = schedule index s when N == 0; else
// the c-th valid schedule index s in schedule order, sel_pos[r, c] = s, or
// a dead column with sel_pos 0 where the read has fewer valid positions):
//   valid  the seed's bases reads[r, min(pos[s] + i, L - 1)], i < seed_len,
//          are all below 4;
//   f, rc  the 2-bit packs, first base most significant, and the reverse
//          complement's (lo = low 32 bits, hi = shard = the rest);
//   key    the smaller of f and rc (the palindrome: f == rc);
//   h1, h2 murmur3's finalizer of key ^ shard * S1 and of (key + S2) ^
//          shard * S2, range-reduced as (h * n_buckets) >> 32;
//   found  the entry of (key, shard): the last match in the h1 row of
//          ck_buckets; else the last in the h2 row of ck_buckets2; else
//          the stash, where several matches give the u32 max of each half.
//          A layout holds each (key, shard) in one of the three places
//          (index/hash_index.py build_cuckoo_layout), so stopping at the
//          first place that holds it gives the plain version's answer;
//   vals   (fwd, rc) = the halves swapped where rc is the smaller pack, rc
//          = fwd for a palindrome, both UNUSED where not found or invalid;
//   counts, bases  expand_counts of each half: 0 / -1 (unused), 1 / -1 (a
//          location below genome_size, u32 compare), else overflow[off]
//          (off = val - genome_size as int32, clamped into the table) /
//          off + 1.
//
// What bounds it on an H100: bytes, and those are random.  A present seed
// reads one 128-byte bucket row, an absent one two; the reads (13 MB a
// batch) stay in L1/L2, the outputs are 26 bytes a column.
//
// Design: one warp per read, lanes over schedule positions in chunks of
// 32.  A lane packs its seed from the read's bytes (L1 hits after the
// first), the warp ranks the valid seeds with a ballot and popc (N > 0),
// and each selected lane hashes and loads its whole h1 row as eight 16-
// byte loads at once (one round trip; the value words share the row's
// sectors).  The h2 row is read only where h1 missed, the stash only where
// both missed.  Each block keeps the stash entries that a seed of this
// length can match (shard < 4^(seed_len - 16)) in shared memory, so the
// stash search is as long as the stash is full.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                  // reads a block
constexpr int kThreads = 32 * kWarps;
constexpr int kStash = 128;                // index/hash_index.py CUCKOO_STASH
constexpr int kRowWords = 32;              // [klo x8 | khi x8 | v1 x8 | v2 x8]
constexpr uint32_t kUnused = 0xFFFFFFFEu;  // UNUSED_HASH_VALUE
constexpr uint32_t kSalt1 = 0x9E3779B1u;
constexpr uint32_t kSalt2 = 0x85EBCA77u;

struct Args {
  const uint8_t* reads;
  int B, L;
  const int* pos;
  int S, seed_len, N, n_out;
  const uint4* b1;
  uint32_t nb1;
  const uint4* b2;
  uint32_t nb2;
  const uint4* stash;
  const int* overflow;
  int n_ovf;
  uint32_t genome_size;
  uint8_t* valid;
  uint8_t* found;
  int2* counts;
  int2* bases;
  int2* vals;
  int* sel_pos;
};

__device__ __forceinline__ uint32_t murmur(uint32_t k) {
  k ^= k >> 16;
  k *= 0x85EBCA6Bu;
  k ^= k >> 13;
  k *= 0xC2B2AE35u;
  return k ^ (k >> 16);
}

// the last entry of a bucket row holding (key, shard): its two value
// words; false where none does
__device__ __forceinline__ bool row_lookup(const uint4* row, uint32_t key,
                                           uint32_t shard, uint32_t& v1,
                                           uint32_t& v2) {
  uint4 q[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) q[i] = __ldg(row + i);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(q);
  int j = -1;
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (w[e] == key && w[8 + e] == shard) j = e;
  if (j < 0) return false;
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (e == j) {
      v1 = w[16 + e];
      v2 = w[24 + e];
    }
  return true;
}

__device__ __forceinline__ int2 decode(const Args& a, uint32_t val) {
  if (val == kUnused) return make_int2(0, -1);
  if (val < a.genome_size) return make_int2(1, -1);
  const uint32_t off = val - a.genome_size;
  const int ci = min(max((int)off, 0), a.n_ovf - 1);
  const int cnt = a.n_ovf > 0 ? __ldg(a.overflow + ci) : 0;
  return make_int2(cnt, (int)(off + 1u));
}

__device__ __forceinline__ void write_dead(const Args& a, size_t o) {
  a.valid[o] = 0;
  a.found[o] = 0;
  a.counts[o] = make_int2(0, 0);
  a.bases[o] = make_int2(-1, -1);
  a.vals[o] = make_int2((int)kUnused, (int)kUnused);
}

__global__ void __launch_bounds__(kThreads)
seed_lookup_kernel(Args a) {
  __shared__ uint4 s_stash[kStash];
  __shared__ int s_n;
  const int tid = threadIdx.x, lane = tid & 31;
  const int shard_bits = 2 * max(a.seed_len - 16, 0);
  if (tid == 0) s_n = 0;
  __syncthreads();
  for (int t = tid; t < kStash; t += kThreads) {
    const uint4 e = __ldg(a.stash + t);
    if ((e.y >> shard_bits) == 0u) s_stash[atomicAdd(&s_n, 1)] = e;
  }
  __syncthreads();
  const int n_st = s_n;

  const int r = blockIdx.x * kWarps + (tid >> 5);
  if (r >= a.B) return;
  const uint8_t* rd = a.reads + (size_t)r * a.L;
  const size_t row0 = (size_t)r * a.n_out;
  const unsigned lt = (1u << lane) - 1u;
  int n_sel = 0;
  for (int c0 = 0; c0 < a.S; c0 += 32) {
    const int s = c0 + lane;
    const bool in = s < a.S;
    uint64_t f = 0, rc = 0;
    bool ok = in;
    if (in) {
      const int p = max(__ldg(a.pos + s), 0);
      for (int i = 0; i < a.seed_len; ++i) {
        const uint32_t c = rd[min(p + i, a.L - 1)];
        ok = ok && c < 4u;
        f = (f << 2) | (c & 3u);
        rc |= (uint64_t)((c & 3u) ^ 3u) << (2 * i);
      }
    }
    int col = s;
    bool take = in;
    if (a.N > 0) {
      const unsigned m = __ballot_sync(0xFFFFFFFFu, ok);
      col = n_sel + __popc(m & lt);
      take = ok && col < a.N;
      n_sel += __popc(m);
      if (take) a.sel_pos[row0 + col] = s;
    }
    if (take) {
      const size_t o = row0 + col;
      if (!ok) {
        write_dead(a, o);
      } else {
        const bool fwd_smaller = f <= rc;
        const uint64_t k = fwd_smaller ? f : rc;
        const uint32_t key = (uint32_t)k, shard = (uint32_t)(k >> 32);
        uint32_t v1 = 0, v2 = 0;
        const uint32_t h1 = __umulhi(murmur(key ^ (shard * kSalt1)), a.nb1);
        bool hit = row_lookup(a.b1 + (size_t)h1 * (kRowWords / 4), key,
                              shard, v1, v2);
        if (!hit) {
          const uint32_t h2 =
              __umulhi(murmur((key + kSalt2) ^ (shard * kSalt2)), a.nb2);
          hit = row_lookup(a.b2 + (size_t)h2 * (kRowWords / 4), key, shard,
                           v1, v2);
        }
        if (!hit) {
          for (int t = 0; t < n_st; ++t) {
            const uint4 e = s_stash[t];
            if (e.x == key && e.y == shard) {
              v1 = hit ? max(v1, e.z) : e.z;
              v2 = hit ? max(v2, e.w) : e.w;
              hit = true;
            }
          }
        }
        uint32_t fv = kUnused, rv = kUnused;
        if (hit) {
          fv = fwd_smaller ? v1 : v2;
          rv = f == rc ? fv : (fwd_smaller ? v2 : v1);
        }
        const int2 df = decode(a, fv), dr = decode(a, rv);
        a.valid[o] = 1;
        a.found[o] = hit;
        a.counts[o] = make_int2(df.x, dr.x);
        a.bases[o] = make_int2(df.y, dr.y);
        a.vals[o] = make_int2((int)fv, (int)rv);
      }
    }
    if (a.N > 0 && n_sel >= a.N) break;         // warp-uniform
  }
  if (a.N > 0)
    for (int c = min(n_sel, a.N) + lane; c < a.N; c += 32) {
      a.sel_pos[row0 + c] = 0;
      write_dead(a, row0 + c);
    }
}

}  // namespace

// reads (B, L) u8; pos (S,) i32, read as 0 where < 0; 16 <= seed_len <=
// 25; N = 0 (every position) or 1 <= N <= S; b1 (nb1, 32) and b2 (nb2,
// 32) u32 bucket rows; stash (n_stash = kStash, 4) u32; overflow (n_ovf,)
// i32.  Outputs at
// n_out = N or S columns: valid, found (B, n_out) bool; counts, bases, vals
// (B, n_out, 2) i32; sel_pos (B, N) i32 when N > 0 (else unused).
extern "C" int seed_lookup_launch(
    const void* reads, int B, int L, const void* pos, int S, int seed_len,
    int N, const void* b1, int nb1, const void* b2, int nb2,
    const void* stash, int n_stash, const void* overflow, int n_ovf,
    unsigned int genome_size, void* valid, void* found, void* counts,
    void* bases, void* vals, void* sel_pos, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (L < 1 || seed_len < 16 || seed_len > 25 || N < 0 || N > S ||
      nb1 < 1 || nb2 < 1 || n_stash != kStash ||
      n_ovf < 0 || (N > 0 && sel_pos == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const uint8_t*>(reads), B, L,
               static_cast<const int*>(pos), S, seed_len, N, N > 0 ? N : S,
               static_cast<const uint4*>(b1), (uint32_t)nb1,
               static_cast<const uint4*>(b2), (uint32_t)nb2,
               static_cast<const uint4*>(stash),
               static_cast<const int*>(overflow), n_ovf, genome_size,
               static_cast<uint8_t*>(valid), static_cast<uint8_t*>(found),
               static_cast<int2*>(counts), static_cast<int2*>(bases),
               static_cast<int2*>(vals), static_cast<int*>(sel_pos)};
  const int grid = (B + kWarps - 1) / kWarps;
  seed_lookup_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
