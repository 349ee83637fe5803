"""Per-op parity of the PyTorch port against the JAX package, on the CPU.

The same numpy inputs (made from a seed) go through the JAX function and
its port; integer outputs must be bit-identical, log-probabilities agree
to rtol/atol 1e-5 (f32 reduction order, the bar of test_lv_pallas.py).
On the CPU the JAX side runs its plain path (_lv_backend() is "jax")."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snap_rnaseq_tpu.index.genome import genome_from_codes
from snap_rnaseq_tpu.index.hash_index import build_cuckoo_layout, build_index
from snap_rnaseq_tpu.ops import bitpar as jbp
from snap_rnaseq_tpu.ops import cigar as jcg
from snap_rnaseq_tpu.ops import genome_gather as jgg
from snap_rnaseq_tpu.ops import lookup as jlk
from snap_rnaseq_tpu.ops import lv as jlv
from snap_rnaseq_tpu.ops import rowscan as jrs
from snap_rnaseq_tpu_torch.ops import bitpar as tbp
from snap_rnaseq_tpu_torch.ops import cigar as tcg
from snap_rnaseq_tpu_torch.ops import genome_gather as tgg
from snap_rnaseq_tpu_torch.ops import lookup as tlk
from snap_rnaseq_tpu_torch.ops import lv as tlv
from snap_rnaseq_tpu_torch.ops import rowscan as trs
from snap_rnaseq_tpu_torch.ops import u32


def t(x):
    """JAX/numpy array -> torch tensor (uint32 as int32 bits)."""
    a = np.array(x)
    if a.dtype == np.uint32:
        return u32.from_numpy(a)
    return torch.from_numpy(a)


def same(got, want):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    if w.dtype == np.uint32:
        g = g.astype(np.int32).view(np.uint32)
    np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------- lookup

@pytest.fixture(scope="module")
def repeat_index():
    rng = np.random.default_rng(3)
    unit = rng.integers(0, 4, 2000, dtype=np.uint8)
    parts = []
    for i in range(20):
        u = unit.copy()
        for _ in range(i):
            p = rng.integers(0, u.size)
            u[p] = (u[p] + 1) % 4
        parts.append(u)
    parts.append(rng.integers(0, 4, 20000, dtype=np.uint8))
    codes = np.concatenate(parts)
    index = build_index(genome_from_codes(codes), seed_len=20)
    layout = build_cuckoo_layout(index.ht_keys, index.ht_val1,
                                 index.ht_val2, index.shard_starts)
    return index, layout


def _reads(genome, rng, B=48, L=100):
    starts = rng.integers(0, genome.num_bases - L, B)
    reads = np.asarray(genome.codes)[starts[:, None] + np.arange(L)].copy()
    for i in range(B):
        for _ in range(rng.integers(0, 4)):
            reads[i, rng.integers(0, L)] = rng.integers(0, 5)
    return np.minimum(reads, 4).astype(np.uint8)


def test_murmur32():
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 1 << 32, 5000, dtype=np.uint64).astype(np.uint32)
    same(tlk.murmur32(t(keys)), jlk.murmur32(jnp.asarray(keys)))


@pytest.mark.parametrize("seed_len", [16, 20, 24])
def test_pack_seeds(seed_len):
    rng = np.random.default_rng(seed_len)
    reads = rng.integers(0, 5, (32, 100)).astype(np.uint8)
    positions = tuple(range(0, 100 - seed_len, 7))
    pj = jlk.pack_seeds(jnp.asarray(reads), positions, seed_len)
    pt = tlk.pack_seeds(t(reads), positions, seed_len)
    for k in ("lo_f", "hi_f", "lo_r", "hi_r", "valid"):
        same(pt[k], pj[k])


def test_lookup_seeds_cuckoo(repeat_index):
    index, layout = repeat_index
    reads = _reads(index.genome, np.random.default_rng(11))
    positions = tuple(range(0, 80, 5))
    pj = jlk.pack_seeds(jnp.asarray(reads), positions, 20)
    pt = tlk.pack_seeds(t(reads), positions, 20)
    fj, fvj, rvj = jlk.lookup_seeds_cuckoo(
        pj, jnp.asarray(layout["ck_buckets"]),
        jnp.asarray(layout["ck_buckets2"]), jnp.asarray(layout["ck_stash"]))
    ft, fvt, rvt = tlk.lookup_seeds_cuckoo(
        pt, t(layout["ck_buckets"]), t(layout["ck_buckets2"]),
        t(layout["ck_stash"]))
    assert np.asarray(fj).any()
    same(ft, fj)
    same(fvt, fvj)
    same(rvt, rvj)
    # count decode + hit gather against the same overflow table
    ovf = index.device_arrays()["overflow"]
    gs = index.genome_size
    for vj, vt in ((fvj, fvt), (rvj, rvt)):
        cj, bj = jlk.expand_counts(vj, jnp.asarray(ovf), gs)
        ct, bt = tlk.expand_counts(vt, t(ovf), gs)
        same(ct, cj)
        same(bt, bj)
        slot = np.minimum(np.asarray(cj), 3).astype(np.int32)
        same(tlk.gather_hit(t(slot), None, bt, vt, t(ovf)),
             jlk.gather_hit(jnp.asarray(slot), None, bj, vj, jnp.asarray(ovf)))


# ---------------------------------------------------------------- gather

@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("width", [132, 37])
def test_gather_windows(big, width):
    rng = np.random.default_rng(width)
    codes = rng.integers(0, 6, 9000).astype(np.uint8)
    p4 = jgg.pack_genome_4bit(codes)
    np.testing.assert_array_equal(tgg.pack_genome_4bit(codes), p4)
    locs = rng.integers(-40, 9100, 300).astype(np.int32)
    if big:   # int32-wrapped uint32 starts, including wrapped-below-zero
        locs[:20] = np.array([-1, -16, -2000] * 7, np.int32)[:20]
    cj, wj = jgg.gather_windows(jnp.asarray(p4), jnp.asarray(locs),
                                width=width, big=big, return_packed=True)
    ct, wt = tgg.gather_windows(t(p4), t(locs), width=width, big=big,
                                return_packed=True)
    same(ct, cj)
    same(wt, wj)


# ---------------------------------------------------------------- rowscan

@pytest.mark.parametrize("which", ["add", "min", "max", "first"])
def test_rowscan(which):
    rng = np.random.default_rng(len(which))
    val = rng.integers(-50, 50, (6, 128)).astype(np.int32)
    boundary = rng.random((6, 128)) < 0.2
    boundary[:, 0] = True
    vj, bj, vt, bt = jnp.asarray(val), jnp.asarray(boundary), t(val), t(boundary)
    if which == "first":
        same(trs.seg_first(vt, bt), jrs.seg_first(vj, bj))
        return
    jop, top, ident = {"add": (jnp.add, torch.add, 0),
                       "min": (jnp.minimum, torch.minimum, 1 << 30),
                       "max": (jnp.maximum, torch.maximum, -(1 << 30))}[which]
    same(trs.seg_scan(vt, bt, top, ident), jrs.seg_scan(vj, bj, jop, ident))
    same(trs.seg_broadcast(vt, bt, top, ident),
         jrs.seg_broadcast(vj, bj, jop, ident))


# ---------------------------------------------------------------- LV

def _lv_cases(rng, B, P, e_max, free_prefix):
    """tests/test_lv_pallas.py's random edit cases (+ optional free)."""
    pats = rng.integers(0, 4, (B, P), dtype=np.uint8)
    texts = np.zeros((B, P + 2 * e_max), np.uint8)
    p_len = np.zeros(B, np.int32)
    t_len = np.zeros(B, np.int32)
    for i in range(B):
        n = int(rng.integers(P // 2, P + 1))
        p_len[i] = n
        tt = list(pats[i, :n])
        for _ in range(int(rng.integers(0, e_max + 2))):
            op = rng.integers(0, 3)
            pos = int(rng.integers(0, max(len(tt), 1)))
            if op == 0 and tt:
                tt[pos] = (tt[pos] + 1) % 4
            elif op == 1 and tt:
                del tt[pos]
            else:
                tt.insert(pos, int(rng.integers(0, 4)))
        tt = tt[:texts.shape[1]]
        t_len[i] = len(tt)
        texts[i, :len(tt)] = tt
    k = rng.integers(0, e_max + 1, B).astype(np.int32)
    quals = rng.integers(33, 74, (B, P)).astype(np.uint8)
    free = (rng.integers(0, P // 3, B).astype(np.int32) if free_prefix
            else None)
    return pats, p_len, texts, t_len, k, quals, free


def _lv_compare(got, ref, tables):
    for f in ("distance", "e_final", "d_final", "net_indel", "start_run"):
        same(getattr(got, f), getattr(ref, f))
    np.testing.assert_allclose(got.log_prob.numpy(), np.asarray(ref.log_prob),
                               rtol=1e-5, atol=1e-5)
    if tables:
        for f in ("L", "A", "acts", "matched"):
            same(getattr(got, f), getattr(ref, f))


@pytest.mark.parametrize("cigar_order,keep_tables,free_prefix,e_max,P", [
    (False, False, True, 16, 100),    # K1's main-path form
    (False, True, True, 5, 32),
    (True, True, False, 5, 32),       # K3's form
    (True, True, False, 31, 48),
    (False, False, False, 4, 16),
])
def test_lv_plain_matches_jax(cigar_order, keep_tables, free_prefix, e_max,
                              P):
    rng = np.random.default_rng(7 + e_max + P)
    pats, p_len, texts, t_len, k, quals, free = _lv_cases(
        rng, 40, P, e_max, free_prefix)
    jargs = [jnp.asarray(a) for a in (pats, p_len, texts, t_len, k, quals)]
    ref = jlv._lv_distance_jax(
        *jargs, None if free is None else jnp.asarray(free), e_max=e_max,
        cigar_order=cigar_order, keep_tables=keep_tables)
    got = tlv.lv_distance(*[t(a) for a in (pats, p_len, texts, t_len, k,
                                           quals)],
                          None if free is None else t(free), e_max=e_max,
                          cigar_order=cigar_order, keep_tables=keep_tables)
    _lv_compare(got, ref, keep_tables)
    assert (got.distance.numpy() >= 0).any() and (got.distance.numpy() < 0).any()


def test_lv_f32_quality_and_none():
    rng = np.random.default_rng(3)
    pats, p_len, texts, t_len, k, quals, free = _lv_cases(rng, 24, 40, 6, True)
    qlp = np.asarray(jlv.phred_log_prob_device(jnp.asarray(quals)))
    np.testing.assert_allclose(
        tlv.phred_log_prob_device(t(quals)).numpy(), qlp, rtol=1e-6,
        atol=1e-6)
    for q in (qlp, None):
        ref = jlv._lv_distance_jax(
            *[jnp.asarray(a) for a in (pats, p_len, texts, t_len, k)],
            None if q is None else jnp.asarray(q), jnp.asarray(free),
            e_max=6)
        got = tlv.lv_distance(*[t(a) for a in (pats, p_len, texts, t_len, k)],
                              None if q is None else t(q), t(free), e_max=6)
        _lv_compare(got, ref, False)


# ---------------------------------------------------------------- bitpar

@pytest.mark.parametrize("P,packed_off", [(100, 16), (40, 3), (64, 0),
                                          (150, 16), (250, 5)])
def test_bitpar_words_matches_jax(P, packed_off):
    rng = np.random.default_rng(P)
    B = 96
    TXT = P + 16
    n_w = (packed_off + TXT + 7) // 8 + 1
    pats = rng.integers(0, 4, (B, P)).astype(np.uint8)
    pats[rng.random((B, P)) < 0.02] = 4            # a few read Ns
    codes = rng.integers(0, 6, (B, n_w * 8)).astype(np.uint8)
    # half the rows: the pattern with a few edits planted in the text
    for i in range(0, B, 2):
        seg = pats[i].copy()
        for _ in range(rng.integers(0, 6)):
            seg[rng.integers(0, P)] = rng.integers(0, 4)
        codes[i, packed_off + 5:packed_off + 5 + P] = seg
    words = jgg.pack_genome_4bit(codes.reshape(-1))[:B * n_w].reshape(B, n_w)
    t_len = rng.integers(P // 2, TXT + 1, B).astype(np.int32)
    ref = jbp.bitpar_distance_words(jnp.asarray(pats), jnp.asarray(words),
                                    jnp.asarray(t_len), P=P, TXT=TXT,
                                    packed_off=packed_off)
    got = tbp.bitpar_distance_words(t(pats), t(words), t(t_len), P=P,
                                    TXT=TXT, packed_off=packed_off)
    same(got, ref)
    assert (np.asarray(ref) <= 8).any()


_FORMS = [(tp, fs, rv) for tp in (False, True) for fs in (False, True)
          for rv in (False, True)]


@pytest.mark.parametrize("track_pos,free_start,reverse,P", [
    pytest.param(True, True, True, 70, id="True-True-True"),
    pytest.param(True, False, False, 70, id="True-False-False"),
    pytest.param(False, True, False, 70, id="False-True-False")] + [
    # reads past four pattern words, in every flag form
    pytest.param(*f, P, id="-".join(map(str, f + (P,))))
    for P in (150, 250) for f in _FORMS])
def test_bitpar_rescue_forms_match_jax(track_pos, free_start, reverse, P):
    rng = np.random.default_rng(5)
    B, TXT = 32, P + 20
    n_w = max(14, (4 + TXT + 7) // 8 + 1)
    pats = rng.integers(0, 4, (B, P)).astype(np.uint8)
    words = rng.integers(0, 1 << 32, (B, n_w), dtype=np.uint64).astype(
        np.uint32) & np.uint32(0x33333333)
    t_len = np.full(B, TXT, np.int32)
    kw = dict(P=P, TXT=TXT, packed_off=4, track_pos=track_pos,
              free_start=free_start, reverse=reverse)
    same(tbp.bitpar_distance_words(t(pats), t(words), t(t_len), **kw),
         jbp.bitpar_distance_words(jnp.asarray(pats), jnp.asarray(words),
                                   jnp.asarray(t_len), **kw))


# ---------------------------------------------------------------- cigar

@pytest.mark.parametrize("use_m", [False, True])
def test_compute_cigars_tokens(use_m):
    rng = np.random.default_rng(17)
    pats, p_len, texts, t_len, _, _, _ = _lv_cases(rng, 30, 64, 8, False)
    B = pats.shape[0]
    pat = np.zeros((B, 128), np.uint8)
    txt = np.zeros((B, 128), np.uint8)
    pat[:, :64] = pats
    txt[:, :texts.shape[1]] = texts
    dj, tj = jcg.compute_cigars(pat, p_len, txt, t_len, use_m=use_m)
    dt, tt = tcg.compute_cigars(pat, p_len, txt, t_len, use_m=use_m,
                                device="cpu")
    same(dt, dj)
    assert tt == tj
    assert any(tok and any(op in "ID" for _, op in tok) for tok in tt)


# ---------------------------------------------------------------- split scan

def _split_scan(pat, text, tl, P, track_pos, rows):
    """K2's split scan replayed with the plain version: each chunk of
    scan_chunks' geometry for a call of `rows` rows scanned from its
    warm-up start, offering only its own columns under their global
    numbers.  Returns the per-chunk results, (chunks, B)."""
    TXT = text.shape[1]
    L, warm, n = tbp.scan_chunks(rows, P, TXT, True)
    out = []
    for q in range(n):
        c0, c1 = q * L, min(TXT, (q + 1) * L)
        if c0 >= c1:
            continue
        lo = max(0, c0 - warm)
        out.append(tbp.bitpar_distance_plain(
            pat, text[:, lo:c1], tl, P=P, track_pos=track_pos,
            free_start=True, first_col=lo, warm=c0 - lo))
    return torch.stack(out)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("P,TXT,rows,track_pos", [
    (100, 1084, 4096, True),   # the mate rescue's call: 8 chunks of 136
    (100, 1084, 24, True),     # few rows: 32 chunks of 34 columns
    (250, 1234, 4096, True),   # P = 250: SCAN_COLUMNS stops at 4 chunks
    (12, 300, 24, True), (12, 300, 24, False)])
def test_split_scan_equals_full_scan(P, TXT, rows, track_pos, reverse):
    """The free-start scan cut into scan_chunks' chunks, each warmed up
    over the 2P columns before it, gives the full scan's answer exactly:
    on random, tandem-repeat and planted rows where the same copy of the
    pattern ends in several chunks (ties: the earliest column wins)."""
    rng = np.random.default_rng(P + TXT + 2 * reverse + track_pos)
    B, off = 24, 3
    L, warm, n = tbp.scan_chunks(rows, P, TXT, True)
    assert warm == 2 * P and n * L >= TXT > (n - 1) * L
    pats = rng.integers(0, 4, (B, P)).astype(np.uint8)
    cols = rng.integers(0, 4, (B, TXT)).astype(np.uint8)
    for i in range(B):
        if i % 3 == 0:         # one edited copy, ending just past borders
            seg = pats[i].copy()
            seg[rng.integers(0, P, 2)] ^= 1
            last = -P
            for b in range(L, TXT, L):
                s0 = b + int(rng.integers(1, 9)) - P
                if s0 >= last + P and s0 + P <= TXT:
                    cols[i, s0:s0 + P] = seg
                    last = s0
        elif i % 3 == 1:       # a tandem repeat, the pattern one of its runs
            unit = rng.integers(0, 4, int(rng.integers(2, 7)))
            rep = np.resize(unit, TXT + P).astype(np.uint8)
            cols[i] = rep[:TXT]
            pats[i] = rep[5:5 + P]
            pats[i, rng.integers(0, P)] ^= 2
    cols[rng.random(cols.shape) < 0.003] = 5
    pats[rng.random(pats.shape) < 0.003] = 4
    n_w = (off + TXT + 7) // 8 + 1
    codes = np.zeros((B, n_w * 8), np.uint8)
    codes[:, off:off + TXT] = cols[:, ::-1] if reverse else cols
    words = jgg.pack_genome_4bit(codes.reshape(-1))[:B * n_w].reshape(B, n_w)
    t_len = np.where(rng.random(B) < 0.3, rng.integers(TXT // 2, TXT, B),
                     TXT).astype(np.int32)
    kw = dict(P=P, TXT=TXT, packed_off=off, track_pos=track_pos,
              free_start=True, reverse=reverse)
    full = tbp.bitpar_distance_words(t(pats), t(words), t(t_len), **kw)
    same(full, jbp.bitpar_distance_words(jnp.asarray(pats),
                                         jnp.asarray(words),
                                         jnp.asarray(t_len), **kw))
    per_chunk = _split_scan(t(pats), t(cols), t(t_len), P, track_pos,
                            rows)
    same(per_chunk.min(dim=0).values, full)
    if track_pos:              # the best score reached in two chunks
        score = lambda x: x >> 12
        ties = (score(per_chunk) == score(full)[None]).sum(dim=0)
        assert (ties >= 2).any()
