"""Hand-written CUDA kernels of the port against their plain PyTorch
versions, on an NVIDIA card.  Every test here needs the card and skips
without one; on the CPU the wrappers' plain versions are tested against the
JAX package by test_torch_ops.py instead.

This file imports neither jax nor the JAX package, so it runs on a machine
that has only PyTorch (the repository's conftest imports jax; skip it):

    python -m pytest -o addopts="" --noconftest tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from snap_rnaseq_tpu_torch.index.genome import genome_from_codes
from snap_rnaseq_tpu_torch.index.hash_index import build_index
from snap_rnaseq_tpu_torch.models.single import SingleAligner
from snap_rnaseq_tpu_torch.ops import bitpar, cigar, kernels, lv, lv_cuda
from snap_rnaseq_tpu_torch.ops.genome_gather import pack_genome_4bit
from snap_rnaseq_tpu_torch.ops import u32
from snap_rnaseq_tpu_torch.utils.synth_genome import hg_like_genome
from snap_rnaseq_tpu_torch.tools.cigar_cases import (E_MAX_CIGAR, cigar_rows,
                                                   max_path_diagonal)

pytestmark = pytest.mark.cuda

# K3's outputs besides the tables: the scalars and the edit script
K3_SCRIPT = ("distance", "e_final", "d_final", "net_indel", "acts",
             "matched", "start_run")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _edit_cases(rng, B, P, T, e_max):
    pats = rng.integers(0, 4, (B, P), dtype=np.uint8)
    texts = rng.integers(0, 4, (B, T), dtype=np.uint8)
    p_len = rng.integers(P // 2, P + 1, B).astype(np.int32)
    t_len = np.zeros(B, np.int32)
    for i in range(B):
        t = list(pats[i, :p_len[i]])
        for _ in range(int(rng.integers(0, e_max + 2))):
            op, pos = rng.integers(0, 3), int(rng.integers(0, len(t)))
            if op == 0:
                t[pos] = (t[pos] + 1) % 4
            elif op == 1:
                del t[pos]
            else:
                t.insert(pos, int(rng.integers(0, 4)))
        t = t[:T]
        texts[i, :len(t)] = t
        t_len[i] = len(t) if rng.random() < 0.5 else T
    return pats, p_len, texts, t_len


def _same_lv(got, want, fields):
    for f in fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    torch.testing.assert_close(got.log_prob, want.log_prob, rtol=1e-5,
                               atol=1e-5)


def _tie_cases(rng, B, P, T, e_max):
    """Rows full of ties: pattern and text one tandem repeat of a 1-2 base
    unit, the text with a few substitutions, so that many diagonals reach
    p_len at the winning level and the diagonal priority decides."""
    pats = np.zeros((B, P), np.uint8)
    texts = np.zeros((B, T), np.uint8)
    for i in range(B):
        rep = np.resize(rng.integers(0, 4, int(rng.integers(1, 3))), T)
        pats[i] = rep[:P]
        texts[i] = rep
        n_sub = int(rng.integers(1, e_max // 2 + 1))
        pos = rng.integers(0, P, n_sub)
        texts[i, pos] = (texts[i, pos] + rng.integers(1, 4, n_sub)) % 4
    return pats, np.full(B, P, np.int32), texts, np.full(B, T, np.int32)


@pytest.mark.parametrize("e_max,P,free,qual,ties", [
    pytest.param(16, 100, True, "f32", False, id="16-100-True-f32"),
    pytest.param(16, 100, False, "u8", False, id="16-100-False-u8"),
    pytest.param(5, 32, True, None, False, id="5-32-True-None"),
    pytest.param(31, 128, True, "f32", False, id="31-128-True-f32"),
    # distance_hist's call: e_max 31, no quality, text P + 31, rows of
    # mixed pattern length padded to the longest
    pytest.param(31, 100, False, None, False, id="31-100-False-None"),
    pytest.param(8, 64, False, None, False, id="8-64-False-None"),
    # D = 35: diagonals 32-34 in each lane's second slot
    pytest.param(17, 100, True, "f32", False, id="17-100-True-f32"),
    pytest.param(17, 100, False, "f32", True, id="17-100-ties"),
    pytest.param(16, 100, False, None, True, id="16-100-ties")])
def test_k1_matches_plain(card, e_max, P, free, qual, ties):
    """K1 (one warp per row) through lv_distance's default switch against
    the plain version; K5 does not launch."""
    rng = np.random.default_rng(e_max * P + ties)
    B = 3000
    pats, p_len, texts, t_len = (_tie_cases if ties else _edit_cases)(
        rng, B, P, P + e_max, e_max)
    to = lambda a: torch.from_numpy(a).to(card)
    quals = to(rng.integers(33, 74, (B, P)).astype(np.uint8))
    q = {"f32": lv.phred_log_prob_device(quals), "u8": quals, None: None}[qual]
    fr = to(rng.integers(0, P // 2, B).astype(np.int32)) if free else None
    k = rng.integers(0, e_max + 1, B).astype(np.int32)
    if ties:
        k[:] = e_max
    args = (to(pats), to(p_len), to(texts), to(t_len), to(k), q)
    before = dict(kernels.LAUNCHES)
    got = lv.lv_distance(*args, fr, e_max=e_max)
    assert kernels.LAUNCHES["K1_lv_lanes"] == before["K1_lv_lanes"] + 1
    assert kernels.LAUNCHES["K5_lv_onehot"] == before["K5_lv_onehot"]
    want = lv._lv_distance_plain(*args, fr, e_max=e_max, keep_tables=ties)
    _same_lv(got, want, ("distance", "e_final", "d_final", "net_indel"))
    if not ties:
        assert (want.distance >= 0).any() and (want.distance < 0).any()
        return
    # at the winning level, how many in-band diagonals reached p_len
    D, e_fin = 2 * e_max + 1, want.e_final.long()
    at_win = want.L[torch.arange(B, device=card), e_fin]          # (B, D)
    band = (torch.arange(D, device=card)[None] - e_max).abs() <= e_fin[:, None]
    reached = ((at_win >= to(p_len)[:, None]) & band).sum(dim=1)
    found = want.distance > 0
    assert found.float().mean() > 0.5
    assert (reached[found] >= 2).float().mean() > 0.5


@pytest.mark.parametrize("e_max", [16, 17, 31])
@pytest.mark.parametrize("free", ["zero", "read"])
def test_k5_matches_plain_and_k1(card, e_max, free, monkeypatch):
    """K5 through lv_distance's switch (SNAP_TPU_LV_LANES=onehot) against
    the plain version and, bit for bit, against K1 on the same rows; free
    prefix 0 or the read length, random k, f32 quality rows."""
    rng = np.random.default_rng(300 + e_max + (free == "read"))
    B, P = 3000, 100
    pats, p_len, texts, t_len = _edit_cases(rng, B, P, P + e_max, e_max)
    to = lambda a: torch.from_numpy(a).to(card)
    fr = to(p_len if free == "read" else np.zeros(B, np.int32))
    q = lv.phred_log_prob_device(
        to(rng.integers(33, 74, (B, P)).astype(np.uint8)))
    k = rng.integers(0, e_max + 1, B).astype(np.int32)
    k[:B // 2] = e_max
    args = (to(pats), to(p_len), to(texts), to(t_len), to(k), q)
    monkeypatch.setenv("SNAP_TPU_LV_LANES", "onehot")
    before = dict(kernels.LAUNCHES)
    got = lv.lv_distance(*args, fr, e_max=e_max)
    assert kernels.LAUNCHES["K5_lv_onehot"] == before["K5_lv_onehot"] + 1
    assert kernels.LAUNCHES["K1_lv_lanes"] == before["K1_lv_lanes"]
    want = lv._lv_distance_plain(*args, fr, e_max=e_max)
    fields = ("distance", "e_final", "d_final", "net_indel")
    _same_lv(got, want, fields)
    k1 = lv_cuda.lv_lanes(*args, fr, e_max=e_max)
    for f in fields + ("log_prob",):
        assert torch.equal(getattr(got, f), getattr(k1, f)), f
    if free == "zero":
        assert (want.distance >= 0).any() and (want.distance < 0).any()
    else:                  # every base free: 0 wherever the text is long
        long_text = torch.from_numpy(t_len >= p_len).to(card)
        assert (want.distance[long_text] == 0).all()


@pytest.mark.parametrize("e_max", [16, 17])
@pytest.mark.parametrize("P", [31, 32, 33, 64, 100])
def test_k5_mask_boundaries(card, P, e_max, monkeypatch):
    """K5's mismatch masks at their edges: P on either side of a word
    boundary, free prefixes of 0, 31, 32, 33 and P, texts cut short of
    P + d (the sentinels mismatch); against the plain version and, bit for
    bit, K1."""
    rng = np.random.default_rng(700 + 2 * P + e_max)
    B = 2000
    pats, p_len, texts, t_len = _edit_cases(rng, B, P, P + e_max, e_max)
    p_len[:B // 2] = P
    short = rng.random(B) < 0.25
    t_len[short] = rng.integers(P // 2, P, int(short.sum()))
    free = np.resize(np.array([0, 31, 32, 33, P], np.int32).clip(0, P), B)
    to = lambda a: torch.from_numpy(a).to(card)
    q = lv.phred_log_prob_device(
        to(rng.integers(33, 74, (B, P)).astype(np.uint8)))
    k = np.full(B, e_max, np.int32)
    args = (to(pats), to(p_len), to(texts), to(t_len), to(k), q)
    fr = to(free)
    monkeypatch.setenv("SNAP_TPU_LV_LANES", "onehot")
    before = kernels.LAUNCHES["K5_lv_onehot"]
    got = lv.lv_distance(*args, fr, e_max=e_max)
    assert kernels.LAUNCHES["K5_lv_onehot"] == before + 1
    want = lv._lv_distance_plain(*args, fr, e_max=e_max)
    fields = ("distance", "e_final", "d_final", "net_indel")
    _same_lv(got, want, fields)
    k1 = lv_cuda.lv_lanes(*args, fr, e_max=e_max)
    for f in fields + ("log_prob",):
        assert torch.equal(getattr(got, f), getattr(k1, f)), f
    assert (want.distance >= 0).any() and (want.distance < 0).any()


@pytest.mark.parametrize("P,off", [(100, 16), (40, 3), (128, 0)])
def test_k2_matches_plain(card, P, off):
    rng = np.random.default_rng(P + off)
    B, TXT = 5000, P + 16
    NW = (off + TXT + 7) // 8 + 1
    codes = rng.integers(0, 6, (B, NW * 8), dtype=np.uint8)
    pats = rng.integers(0, 4, (B, P), dtype=np.uint8)
    pats[rng.random((B, P)) < 0.01] = 4
    half = rng.random(B) < 0.5
    seg = pats[half] % 4
    flip = rng.random(seg.shape) < 0.03
    seg[flip] = (seg[flip] + 1) % 4
    codes[half, off + 2:off + 2 + P] = seg
    words = pack_genome_4bit(codes.reshape(-1))[:B * NW].reshape(B, NW)
    t_len = rng.integers(P // 2, TXT + 1, B).astype(np.int32)
    pat, w = torch.from_numpy(pats).to(card), u32.from_numpy(words, card)
    tl = torch.from_numpy(t_len).to(card)
    kw = dict(P=P, TXT=TXT, packed_off=off)
    got = bitpar.bitpar_distance_words(pat, w, tl, **kw)
    want = bitpar.bitpar_distance_plain(
        pat, bitpar.unpack_words(w)[:, off:off + TXT], tl, P=P)
    assert torch.equal(got, want)
    assert (want <= 8).any()


FLAGS = [(r, f, tr) for r in (False, True) for f in (False, True)
         for tr in (False, True)]


@pytest.mark.parametrize("P,TXT,off", [
    (100, 1084, 0), (37, 300, 5),
    # 4,096 rows: 8 chunks, 1,088 = 8 x 136 columns, and either side
    (100, 1087, 0), (100, 1088, 0), (100, 1089, 0),
    # reads past four pattern words, over the mate rescue's window WLEN =
    # 950 + P + 34 at the default spacing (P = 129: five words, one bit in
    # the fifth)
    (129, 1113, 3), (150, 1134, 0), (250, 1234, 5), (512, 1496, 0)])
@pytest.mark.parametrize("reverse,free_start,track_pos", FLAGS)
def test_k2_every_form_matches_plain(card, P, TXT, off, reverse, free_start,
                                     track_pos):
    """K2 in each (reverse, free_start, track_pos) form, the mate rescue's
    shape first, against the plain version on the scanned columns.  With a
    free start (the split scan) every fourth row holds the same copy
    ending in chunks 1 and 3: the earliest best column must win."""
    rng = np.random.default_rng(P + 8 * reverse + 4 * free_start + track_pos)
    B = 4096
    NW = (off + TXT + 7) // 8 + 1
    codes = rng.integers(0, 4, (B, NW * 8), dtype=np.uint8)
    codes[rng.random(codes.shape) < 0.002] = 5
    pats = rng.integers(0, 4, (B, P), dtype=np.uint8)
    pats[rng.random((B, P)) < 0.01] = 4
    chunk_len = bitpar.scan_chunks(B, P, TXT, True)[0]
    for i in range(0, B, 2):                   # the pattern planted, edited
        seg = pats[i] % 4
        flip = rng.random(P) < 0.04
        seg[flip] = (seg[flip] + 1) % 4
        if free_start and i % 4 == 0:          # scanned columns' ends
            starts = [off + TXT - e if reverse else off + e - P
                      for e in (chunk_len + 3, 3 * chunk_len + 5)]
        else:
            starts = [off + int(rng.integers(0, TXT - P)) if free_start
                      else off + TXT - P if reverse else off]
        for s in starts:
            if off <= s <= off + TXT - P:
                codes[i, s:s + P] = seg[::-1] if reverse else seg
    words = pack_genome_4bit(codes.reshape(-1))[:B * NW].reshape(B, NW)
    t_len = rng.integers(TXT // 2, TXT + 1, B).astype(np.int32)
    pat, w = torch.from_numpy(pats).to(card), u32.from_numpy(words, card)
    tl = torch.from_numpy(t_len).to(card)
    flags = dict(free_start=free_start, track_pos=track_pos)
    name = ("K2_bitpar_rescue" if reverse or free_start or track_pos
            else "K2_bitpar_packed")
    before = kernels.LAUNCHES[name]
    got = bitpar.bitpar_distance_words(pat, w, tl, P=P, TXT=TXT,
                                       packed_off=off, reverse=reverse,
                                       **flags)
    assert kernels.LAUNCHES[name] == before + 1
    text = bitpar.unpack_words(w)[:, off:off + TXT]
    want = bitpar.bitpar_distance_plain(
        pat, text.flip(1) if reverse else text, tl, P=P, **flags)
    assert torch.equal(got, want)
    dist = want >> 12 if track_pos else want
    assert (dist <= max(8, P // 12)).any() and (dist > 8).any()


@pytest.mark.parametrize("track_pos,free_start", [
    (False, False), (True, False), (False, True), (True, True)])
def test_k4_matches_plain(card, track_pos, free_start):
    """K4 at the stringz shape (P = 100, TXT = 131), codes >= 4 and the
    padding byte 255 included."""
    rng = np.random.default_rng(40 + 2 * track_pos + free_start)
    B, P, TXT = 16384, 100, 131
    pats = rng.integers(0, 4, (B, P), dtype=np.uint8)
    text = rng.integers(0, 4, (B, TXT), dtype=np.uint8)
    half = rng.random(B) < 0.5
    text[half, 7:7 + P] = pats[half]
    text[half, rng.integers(7, 7 + P, int(half.sum()))] ^= 1
    text[rng.random((B, TXT)) < 0.01] = 4
    text[:64, 120:] = 255
    t_len = rng.integers(P, TXT + 1, B).astype(np.int32)
    to = lambda a: torch.from_numpy(a).to(card)
    kw = dict(P=P, track_pos=track_pos, free_start=free_start)
    before = kernels.LAUNCHES["K4_bitpar_rows"]
    got = bitpar.bitpar_distance(to(pats), to(text), to(t_len), **kw)
    assert kernels.LAUNCHES["K4_bitpar_rows"] == before + 1
    want = bitpar.bitpar_distance_plain(to(pats), to(text), to(t_len), **kw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("track_pos,free_start", [
    (False, False), (True, False), (False, True), (True, True)])
@pytest.mark.parametrize("P,TXT", [(129, 160), (150, 181), (250, 281),
                                   (512, 543), (150, 1234)])
def test_k4_long_reads_match_plain(card, P, TXT, track_pos, free_start):
    """K4 past four pattern words (P = 129-512, stringz's TXT = P + 31, and
    a text of three staged tiles), codes >= 4, the padding byte 255 and
    t_len < TXT; a row count that leaves the last block part full, and
    row views that start one row into their tensors, so the staged spans
    start at every alignment."""
    rng = np.random.default_rng(P + TXT + 2 * track_pos + free_start)
    B = 4096 + 37
    pats = rng.integers(0, 4, (B + 1, P), dtype=np.uint8)
    text = rng.integers(0, 4, (B + 1, TXT), dtype=np.uint8)
    half = rng.random(B + 1) < 0.5
    # where a global start can reach it at no cost, else anywhere
    start = int(rng.integers(0, TXT - P + 1)) if free_start else 0
    seg = pats[half].copy()
    flip = rng.random(seg.shape) < 0.03
    seg[flip] ^= 1
    text[half, start:start + P] = seg
    text[rng.random((B + 1, TXT)) < 0.01] = 4
    text[:64, TXT - 9:] = 255
    t_len = rng.integers(TXT // 2, TXT + 1, B).astype(np.int32)
    to = lambda a: torch.from_numpy(a).to(card)
    pat, txt = to(pats)[1:], to(text)[1:]
    kw = dict(P=P, track_pos=track_pos, free_start=free_start)
    before = kernels.LAUNCHES["K4_bitpar_rows"]
    got = bitpar.bitpar_distance(pat, txt, to(t_len), **kw)
    assert kernels.LAUNCHES["K4_bitpar_rows"] == before + 1
    want = bitpar.bitpar_distance_plain(pat, txt, to(t_len), **kw)
    assert torch.equal(got, want)
    dist = want >> 12 if track_pos else want
    assert (dist <= P // 10).any()


@pytest.mark.parametrize("e_max,W,tables", [(31, 128, True), (5, 32, True),
                                            (5, 128, True), (31, 100, False)])
def test_k3_matches_plain(card, e_max, W, tables):
    rng = np.random.default_rng(e_max + W)
    B = 2048
    pats, p_len, texts, t_len = _edit_cases(rng, B, W - 8, W, min(e_max, 8))
    pat = np.zeros((B, W), np.uint8)
    pat[:, :W - 8] = pats
    to = lambda a: torch.from_numpy(a).to(card)
    args = (to(pat), to(p_len), to(texts), to(t_len),
            to(np.full(B, e_max - 1, np.int32)), None)
    got = lv_cuda.lv_cigar(*args, e_max=e_max, cigar_order=True,
                           tables=tables)
    want = lv._lv_distance_plain(*args, None, e_max=e_max, cigar_order=True,
                                 keep_tables=True)
    _same_lv(got, want, K3_SCRIPT + (("L", "A") if tables else ()))
    if not tables:
        assert got.L.shape == (B, 0, 2 * e_max + 1) == got.A.shape


@pytest.mark.parametrize("B", [1, 2, 150, 1000])
def test_k3_at_cigar_width(card, B):
    """K3 as the CIGAR paths call it (P = 100, e_max 31, k 30, no tables)
    at their flush sizes, none a multiple of the warps per block: rows with
    short indels, with 10-30 edits (winning levels up to 30) and unrelated
    rows (distance -1 after all 30 levels).  At e_max 31 the centre is
    diagonal 31, lane 31's first slot, so a path right of it crosses into
    the lanes' second slot and back.  Also under each forced warps per
    block, the same answer."""
    rng = np.random.default_rng(500 + B)
    pats, p_len, texts, t_len = cigar_rows(rng, B)
    to = lambda a: torch.from_numpy(a).to(card)
    args = (to(pats), to(p_len), to(texts), to(t_len),
            to(np.full(B, E_MAX_CIGAR - 1, np.int32)), None)
    before = kernels.LAUNCHES["K3_lv_cigar"]
    got = lv_cuda.lv_cigar(*args, e_max=E_MAX_CIGAR, cigar_order=True)
    assert kernels.LAUNCHES["K3_lv_cigar"] == before + 1
    want = lv._lv_distance_plain(*args, None, e_max=E_MAX_CIGAR,
                                 cigar_order=True, keep_tables=True)
    _same_lv(got, want, K3_SCRIPT)
    for w in (1, 2, 4, 8):
        prev = kernels.set_variant("lv_cigar", w)
        try:
            forced = lv_cuda.lv_cigar(*args, e_max=E_MAX_CIGAR,
                                      cigar_order=True)
        finally:
            kernels.set_variant("lv_cigar", prev)
        _same_lv(forced, want, K3_SCRIPT)
    if B >= 150:
        assert (want.distance < 0).any()
        assert int(want.e_final.max()) >= 25
        right = max_path_diagonal(want.acts.cpu(), want.e_final.cpu(),
                                  want.d_final.cpu())
        assert (right[want.distance.cpu().numpy() >= 0] > 0).any()
        assert (want.d_final < 0).any()


@pytest.mark.parametrize("P", [150, 250])
def test_lv_kernels_long_reads(card, P, monkeypatch):
    """K1 and K5 at the single and paired e_max (16, 17) with free
    prefixes, and K3 at the CIGAR paths' width (e_max 31, k 30, pattern and
    text of P bases, cigar_rows' kinds), on reads of 150 and 250 bases,
    against their plain versions; K5 also bit for bit against K1."""
    rng = np.random.default_rng(900 + P)
    B = 3000
    to = lambda a: torch.from_numpy(a).to(card)
    fields = ("distance", "e_final", "d_final", "net_indel")
    for e_max in (16, 17):
        pats, p_len, texts, t_len = _edit_cases(rng, B, P, P + e_max, e_max)
        q = lv.phred_log_prob_device(
            to(rng.integers(33, 74, (B, P)).astype(np.uint8)))
        k = rng.integers(0, e_max + 1, B).astype(np.int32)
        k[:B // 2] = e_max
        fr = to(np.where(rng.random(B) < 0.3, rng.integers(0, P + 1, B),
                         0).astype(np.int32))
        args = (to(pats), to(p_len), to(texts), to(t_len), to(k), q)
        want = lv._lv_distance_plain(*args, fr, e_max=e_max)
        k1 = lv_cuda.lv_lanes(*args, fr, e_max=e_max)
        _same_lv(k1, want, fields)
        monkeypatch.setenv("SNAP_TPU_LV_LANES", "onehot")
        before = kernels.LAUNCHES["K5_lv_onehot"]
        k5 = lv.lv_distance(*args, fr, e_max=e_max)
        assert kernels.LAUNCHES["K5_lv_onehot"] == before + 1
        monkeypatch.delenv("SNAP_TPU_LV_LANES")
        for f in fields + ("log_prob",):
            assert torch.equal(getattr(k5, f), getattr(k1, f)), f
        assert (want.distance >= 0).any() and (want.distance < 0).any()
    c_args = [to(a) for a in cigar_rows(rng, 600, P)]
    c_args += [to(np.full(600, E_MAX_CIGAR - 1, np.int32)), None]
    got = lv_cuda.lv_cigar(*c_args, e_max=E_MAX_CIGAR, cigar_order=True)
    want = lv._lv_distance_plain(*c_args, None, e_max=E_MAX_CIGAR,
                                 cigar_order=True, keep_tables=True)
    _same_lv(got, want, K3_SCRIPT)
    assert (want.distance < 0).any() and (want.net_indel != 0).any()


def test_cigars_on_card_equal_cpu(card):
    rng = np.random.default_rng(2)
    pats, p_len, texts, t_len = _edit_cases(rng, 256, 100, 128, 6)
    pat = np.zeros((256, 128), np.uint8)
    pat[:, :100] = pats
    d_gpu, t_gpu = cigar.compute_cigars(pat, p_len, texts, t_len,
                                        device=card)
    d_cpu, t_cpu = cigar.compute_cigars(pat, p_len, texts, t_len,
                                        device="cpu")
    np.testing.assert_array_equal(d_gpu, d_cpu)
    assert t_gpu == t_cpu


@pytest.mark.parametrize("L", [100, 150])
def test_aligner_on_card_equals_cpu(card, L):
    codes = hg_like_genome(300_000, seed=3)
    index = build_index(genome_from_codes(codes), seed_len=20)
    rng = np.random.default_rng(1)
    B = 256
    starts = rng.integers(0, codes.size - L - 4, B)
    reads = codes[starts[:, None] + np.arange(L)].copy()
    sub = rng.random((B, L)) < 0.02
    reads[sub] = (reads[sub] + 1) % 4
    for i in range(0, B, 5):                       # indel reads
        p = int(rng.integers(20, L - 20))
        reads[i, p:] = codes[starts[i] + p + 1:starts[i] + L + 1]
    quals = rng.integers(40, 74, (B, L)).astype(np.uint8)
    kernels.reset_launches()
    got = SingleAligner(index, device=card).align_batch(reads, quals)
    assert kernels.LAUNCHES["K1_lv_lanes"] > 0
    assert kernels.LAUNCHES["K2_bitpar_packed"] > 0
    want = SingleAligner(index, device="cpu").align_batch(reads, quals)
    for k, v in want.items():
        if v.dtype == np.float32:
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("L", [100, 150])
def test_paired_aligner_on_card_equals_cpu(card, L):
    """The paired engine on the card (K1, K2 in both forms) against the
    same engine on the CPU, with end 1 of some pairs seedless so the mate
    rescue places it."""
    from snap_rnaseq_tpu_torch.models.paired import PairedAligner
    from snap_rnaseq_tpu_torch.utils.synth_genome import wgsim_pairs
    codes = hg_like_genome(300_000, seed=4)
    index = build_index(genome_from_codes(codes), seed_len=20)
    r0, q0, r1, q1, _, _ = wgsim_pairs(codes, 256, L, seed=2)
    for i in range(0, 256, 8):                     # no exact 20-mer left
        r1[i, 5::17] = (r1[i, 5::17] + 1) % 4
    kernels.reset_launches()
    got = PairedAligner(index, device=card).align_batch(r0, q0, r1, q1)
    for name in ("K1_lv_lanes", "K2_bitpar_packed", "K2_bitpar_rescue"):
        assert kernels.LAUNCHES[name] > 0, name
    want = PairedAligner(index, device="cpu").align_batch(r0, q0, r1, q1)
    for k, v in want.items():
        if v.dtype == np.float32:
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert int(want["n_rescued1"]) > 0


def test_flat_phases_on_card_equal_cpu(card):
    """The flat back half (K4's whole-read prefilter, K1 in the distance
    buckets) on the card against the same phases on the CPU, fast path on
    and off; the segment sums keep a fixed order, so MAPQ matches too."""
    import os
    from snap_rnaseq_tpu_torch.models.single import flat_align_batch
    codes = hg_like_genome(300_000, seed=6)
    index = build_index(genome_from_codes(codes), seed_len=20)
    rng = np.random.default_rng(5)
    B, L = 256, 100
    starts = rng.integers(0, codes.size - L - 4, B)
    reads = codes[starts[:, None] + np.arange(L)].copy()
    sub = rng.random((B, L)) < 0.02
    reads[sub] = (reads[sub] + 1) % 4
    for i in range(0, B, 5):                       # indel reads
        p = int(rng.integers(20, L - 20))
        reads[i, p:] = codes[starts[i] + p + 1:starts[i] + L + 1]
    quals = rng.integers(40, 74, (B, L)).astype(np.uint8)
    r, q = torch.from_numpy(reads), torch.from_numpy(quals)
    for fast in ("1", "0"):
        os.environ["SNAP_TPU_FAST_SUB"] = fast
        try:
            kernels.reset_launches()
            u_g, sc_g, out_g = flat_align_batch(
                SingleAligner(index, device=card, max_hits_to_get=4), r, q)
            assert kernels.LAUNCHES["K4_bitpar_rows"] == 1
            assert kernels.LAUNCHES["K1_lv_lanes"] > 0
            u_c, sc_c, out_c = flat_align_batch(
                SingleAligner(index, device="cpu", max_hits_to_get=4), r, q)
        finally:
            os.environ.pop("SNAP_TPU_FAST_SUB")
        for got, want in ((u_g, u_c), (sc_g, sc_c), (out_g, out_c)):
            for k, v in want.items():
                g = got[k].cpu()
                if v.dtype == torch.float32:
                    np.testing.assert_allclose(g.numpy(), v.numpy(),
                                               rtol=1e-5, atol=1e-5,
                                               err_msg=k)
                else:
                    np.testing.assert_array_equal(g.numpy(), v.numpy(),
                                                  err_msg=k)
        assert (int(sc_c["n_fast"]) > 0) == (fast == "1")


@pytest.mark.parametrize("kind", ["single", "paired"])
def test_probe_lookup_aligner_on_card_equals_cpu(card, kind, monkeypatch):
    """Under SNAP_TPU_LOOKUP=probe the aligners ship the probe-chain table
    and walk it on the card; the results equal the CPU's (and the kernels
    still launch)."""
    from snap_rnaseq_tpu_torch.models.paired import PairedAligner
    from snap_rnaseq_tpu_torch.utils.synth_genome import wgsim_pairs
    monkeypatch.setenv("SNAP_TPU_LOOKUP", "probe")
    codes = hg_like_genome(300_000, seed=7)
    index = build_index(genome_from_codes(codes), seed_len=20,
                        load_factor=0.95)
    r0, q0, r1, q1, _, _ = wgsim_pairs(codes, 256, 100, seed=3)
    make, args = ((SingleAligner, (r0, q0)) if kind == "single"
                  else (PairedAligner, (r0, q0, r1, q1)))
    kernels.reset_launches()
    al = make(index, device=card)
    assert "ht_entries" in al.state and "ck_buckets" not in al.state
    got = al.align_batch(*args)
    assert kernels.LAUNCHES["K1_lv_lanes"] > 0
    want = make(index, device="cpu").align_batch(*args)
    for k, v in want.items():
        if v.dtype == np.float32:
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_launch_local_on_card_equals_one_process(card, tmp_path):
    """Two worker processes sharing the card (gloo for the stats) give the
    one-process run's SAM body and stats; each worker ran on the card and
    launched K1 and K2."""
    import contextlib
    import io
    import json
    from snap_rnaseq_tpu_torch.models.paired_pipeline import (
        PairedEndPipeline, PairedPipelineOptions)
    from snap_rnaseq_tpu_torch.parallel import multihost as mh
    from snap_rnaseq_tpu_torch.utils.synth_genome import wgsim_pairs
    from snap_rnaseq_tpu_torch.utils.tables import decode_bases
    codes = hg_like_genome(300_000, seed=8)
    index = build_index(genome_from_codes(codes), seed_len=20)
    index.save(str(tmp_path / "idx"))
    n = 600
    r0, q0, r1, q1, _, _ = wgsim_pairs(codes, n, 100, seed=4)
    fq = (str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq"))
    with open(fq[0], "wb") as f0, open(fq[1], "wb") as f1:
        for i in range(n):
            f0.write(b"@p%d/1\n%s\n+\n%s\n" % (i, decode_bases(r0[i]),
                                                 (q0[i] + 33).tobytes()))
            f1.write(b"@p%d/2\n%s\n+\n%s\n" % (i, decode_bases(r1[i]),
                                                 (q1[i] + 33).tobytes()))
    one = str(tmp_path / "one.sam")
    stats = PairedEndPipeline(
        index, options=PairedPipelineOptions(batch_size=256),
        device=card).run(*fq, one)
    out = str(tmp_path / "multi.sam")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        merged = mh.launch_local(2, str(tmp_path / "idx"), fq, out,
                                 paired=True, batch_size=256, timeout=600)
    body = lambda p: [l for l in open(p, "rb") if l[:1] != b"@"]
    assert body(out) == body(one)
    assert merged["total_reads"] == stats.total_reads == 2 * n
    assert merged["aligned_as_pairs"] == stats.aligned_as_pairs
    workers = [json.loads(l.split(":", 1)[1]) for l in
               err.getvalue().splitlines()
               if l.startswith("multihost worker:")]
    assert sorted(w["host_id"] for w in workers) == [0, 1]
    for w in workers:
        assert w["device"].startswith("cuda") and w["peak_device_bytes"] > 0
        assert w["launches"]["K1_lv_lanes"] > 0
        assert w["launches"]["K2_bitpar_packed"] > 0


@pytest.mark.parametrize("kind", ["single", "paired"])
def test_mesh_on_card_equals_cpu(card, kind):
    """A (2, 2) index-sharded mesh with every coordinate on the card (K1
    and K2 once per index shard and end; the paired mesh's mate rescue on
    K2's rescue form) against the same mesh on the CPU."""
    from snap_rnaseq_tpu_torch.parallel import sharded
    from snap_rnaseq_tpu_torch.utils.synth_genome import wgsim_pairs
    codes = hg_like_genome(300_000, seed=9)
    index = build_index(genome_from_codes(codes), seed_len=20)
    r0, q0, r1, q1, _, _ = wgsim_pairs(codes, 256, 100, seed=5)
    for i in range(0, 256, 8):                     # no exact 20-mer left
        r1[i, 5::17] = (r1[i, 5::17] + 1) % 4
    make, args, path = (
        (sharded.ShardedSingleAligner, (r0, q0 + 33),
         ("K1_lv_lanes", "K2_bitpar_packed")) if kind == "single" else
        (sharded.ShardedPairedAligner, (r0, q0 + 33, r1, q1 + 33),
         ("K1_lv_lanes", "K2_bitpar_packed", "K2_bitpar_rescue")))
    kernels.reset_launches()
    got = make(index, sharded.make_mesh(2, 2, device=card)).align_batch(
        *args)
    for name in path:
        assert kernels.LAUNCHES[name] > 0, name
    # the prefilter once per coordinate and end: 2 x 2 coordinates
    assert kernels.LAUNCHES["K2_bitpar_packed"] == 4 * (len(args) // 2)
    want = make(index, sharded.make_mesh(2, 2, device="cpu")).align_batch(
        *args)
    assert set(got) == set(want)
    for k, v in want.items():
        if v.dtype == np.float32:
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def _lift(index, base):
    """`index` with its sequence placed at `base` (a multiple of 512 bases;
    tests/test_torch_big_genome.py lift_index): hash values and overflow
    locations + base, the packed words lifted by whole rows."""
    from snap_rnaseq_tpu_torch.constants import (INVALID_GENOME_LOCATION,
                                                 UNUSED_HASH_VALUE)
    from snap_rnaseq_tpu_torch.index.genome import Genome
    from snap_rnaseq_tpu_torch.index.hash_index import GenomeIndex

    def values(v):
        v = np.asarray(v, np.uint32).copy()
        keep = (v == np.uint32(INVALID_GENOME_LOCATION)) | \
            (v == np.uint32(UNUSED_HASH_VALUE))
        v[~keep] += np.uint32(base)
        return v
    g, ovf = index.genome, np.asarray(index.overflow, np.uint32).copy()
    pos = 0
    while pos < ovf.size:
        ovf[pos + 1:pos + 1 + int(ovf[pos])] += np.uint32(base)
        pos += 1 + int(ovf[pos])
    p4 = pack_genome_4bit(np.asarray(g.codes))
    words = np.full(base // 8 + p4.size, 0x55555555, np.uint32)
    words[base // 8:] = p4
    codes = np.zeros(base + g.codes.size, np.uint8)   # zero pages, unread
    codes[base:] = g.codes
    return GenomeIndex(
        genome=Genome(codes=codes, piece_names=list(g.piece_names),
                      piece_offsets=g.piece_offsets + base, padding=g.padding,
                      packed_4bit=words),
        seed_len=index.seed_len, ht_keys=index.ht_keys,
        ht_val1=values(index.ht_val1), ht_val2=values(index.ht_val2),
        shard_starts=index.shard_starts, overflow=ovf,
        shard_ovf_starts=index.shard_ovf_starts)


@pytest.mark.parametrize("kind", ["single", "paired"])
def test_aligners_at_big_locations_on_card_equal_cpu(card, kind):
    """Both aligners on a 300 kb genome lifted so that its middle sits at
    2^31 (offset A; one batch holds locations of both int32 signs): the
    card's outputs equal the CPU's on the same lifted index, and the
    unlifted engine's with loc + BASE."""
    from snap_rnaseq_tpu_torch.models.paired import PairedAligner
    from snap_rnaseq_tpu_torch.utils.synth_genome import wgsim_pairs
    codes = hg_like_genome(300_000, seed=12)
    index = build_index(genome_from_codes(codes), seed_len=20)
    base = ((1 << 31) - index.genome_size // 2) // 512 * 512
    lifted = _lift(index, base)
    r0, q0, r1, q1, _, _ = wgsim_pairs(codes, 256, 100, seed=6)
    for i in range(0, 256, 8):                     # no exact 20-mer left
        r1[i, 5::17] = (r1[i, 5::17] + 1) % 4
    make, args, locs = (
        (SingleAligner, (r0, q0), {"loc": "result"}) if kind == "single"
        else (PairedAligner, (r0, q0, r1, q1),
              {"loc0": "result0", "loc1": "result1"}))
    kernels.reset_launches()
    got = make(lifted, device=card).align_batch(*args)
    assert kernels.LAUNCHES["K1_lv_lanes"] > 0
    assert kernels.LAUNCHES["K2_bitpar_packed"] > 0
    want = make(lifted, device="cpu").align_batch(*args)
    unlifted = make(index, device="cpu").align_batch(*args)
    for k, v in want.items():
        if v.dtype == np.float32:
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        if k in locs:
            m = unlifted[locs[k]] != 0
            u = got[k].astype(np.int32).view(np.uint32).astype(np.int64)
            np.testing.assert_array_equal(
                u[m], unlifted[k][m].astype(np.int64) + base)
            assert (u[m] < 1 << 31).any() and (u[m] >= 1 << 31).any()
        elif v.dtype != np.float32:
            np.testing.assert_array_equal(got[k], unlifted[k], err_msg=k)


@pytest.mark.parametrize("n_index", [1, 8])
def test_index_build_on_card_equals_cpu(card, n_index):
    """index/hash_index.py build_index_device on the card (default and
    small budgets: seeds cut across packing chunks, logical tables across
    sort groups and insert batches) equals the same build on CPU tensors,
    slice for slice; its host tables, assembled slice by slice, equal the
    numpy build_index."""
    from snap_rnaseq_tpu_torch.index.hash_index import build_index_device
    codes = hg_like_genome(1_500_000, seed=21)
    codes[700_000:700_040] = 5                   # a genome N run
    genome = genome_from_codes(codes)
    want = build_index_device(genome, 20, device="cpu", n_index=n_index)
    for budgets in ({}, dict(chunk=99_991, group_seeds=200_000,
                             insert_keys=50_000)):
        got = build_index_device(genome, 20, device=card, n_index=n_index,
                                 **budgets)
        for k in ("ht_entries", "overflow"):
            for g, w in zip(got.parts[k], want.parts[k]):
                assert g.device.type == "cuda"
                assert torch.equal(g.cpu(), w), k
        for k in ("shard_start", "shard_size"):
            assert torch.equal(got.parts[k].cpu(), want.parts[k]), k
        np.testing.assert_array_equal(got.shard_starts, want.shard_starts)
        np.testing.assert_array_equal(got.shard_ovf_starts,
                                      want.shard_ovf_starts)
    host = build_index(genome, seed_len=20)
    one = got.genome_index()
    for k in ("ht_keys", "ht_val1", "ht_val2", "shard_starts",
              "overflow", "shard_ovf_starts"):
        np.testing.assert_array_equal(getattr(one, k), getattr(host, k),
                                      err_msg=k)


def _same_outputs(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if v.dtype == np.float32:
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.fixture(scope="module")
def bench_world():
    """tools/bench.py's operating point at 1 Mb: the index at seed length
    20, one batch of 512 wgsim pairs over its body (numpy)."""
    from snap_rnaseq_tpu_torch.tools import measure
    index = build_index(genome_from_codes(hg_like_genome(1_000_000, seed=0)),
                        seed_len=20)
    batch = measure.pair_batches(index, 1_000_000, 512, "cpu", 1)[0]
    return index, [x.numpy() for x in batch]


def test_bench_batch_at_cand64_on_card_equals_cpu(card, bench_world):
    """The bench's paired engine (cand_per_read=64: K1, K2 forward and the
    rescue form at shapes of their own) on the card against the same engine
    with device cpu, and the single-end engine on the paired aligner's
    device copy of the index likewise."""
    from snap_rnaseq_tpu_torch.models.paired import PairedAligner
    from snap_rnaseq_tpu_torch.tools import measure
    index, b = bench_world
    kernels.reset_launches()
    gpu = PairedAligner(index, device=card, cand_per_read=64)
    got = gpu.align_batch(*b)
    for name in ("K1_lv_lanes", "K2_bitpar_packed", "K2_bitpar_rescue"):
        assert kernels.LAUNCHES[name] > 0, name
    cpu = PairedAligner(index, device="cpu", cand_per_read=64)
    _same_outputs(got, cpu.align_batch(*b))
    assert got["pair_found"].mean() > 0.9
    _same_outputs(
        measure.single_on_state(gpu, cand_per_read=64).align_batch(b[0], b[1]),
        measure.single_on_state(cpu, cand_per_read=64).align_batch(b[0], b[1]))


def test_engine_ab_onehot_on_card_equals_default(card, bench_world):
    """engine_ab's `onehot` configuration (K5 scores, the mate rescue's LV
    included, and K1 does not launch) gives `default`'s outputs."""
    from snap_rnaseq_tpu_torch.models.paired import PairedAligner
    from snap_rnaseq_tpu_torch.tools import engine_ab
    index, b = bench_world
    base = PairedAligner(index, device=card, cand_per_read=64)
    with engine_ab.lanes_env("default"):
        want = engine_ab.config_engine("default", base).align_batch(*b)
    kernels.reset_launches()
    with engine_ab.lanes_env("onehot"):
        got = engine_ab.config_engine("onehot", base).align_batch(*b)
    for name in ("K5_lv_onehot", "K2_bitpar_packed", "K2_bitpar_rescue"):
        assert kernels.LAUNCHES[name] > 0, name
    assert kernels.LAUNCHES["K1_lv_lanes"] == 0
    _same_outputs(got, want)
