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

pytestmark = pytest.mark.cuda


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


@pytest.mark.parametrize("e_max,P,free,qual", [
    (16, 100, True, "f32"), (16, 100, False, "u8"), (5, 32, True, None),
    (31, 128, True, "f32"), (8, 64, False, None)])
def test_k1_matches_plain(card, e_max, P, free, qual):
    rng = np.random.default_rng(e_max * P)
    B = 3000
    pats, p_len, texts, t_len = _edit_cases(rng, B, P, P + e_max, e_max)
    to = lambda a: torch.from_numpy(a).to(card)
    quals = to(rng.integers(33, 74, (B, P)).astype(np.uint8))
    q = {"f32": lv.phred_log_prob_device(quals), "u8": quals, None: None}[qual]
    fr = to(rng.integers(0, P // 2, B).astype(np.int32)) if free else None
    args = (to(pats), to(p_len), to(texts), to(t_len),
            to(rng.integers(0, e_max + 1, B).astype(np.int32)), q)
    before = kernels.LAUNCHES["K1_lv_lanes"]
    got = lv.lv_distance(*args, fr, e_max=e_max)
    assert kernels.LAUNCHES["K1_lv_lanes"] == before + 1
    want = lv._lv_distance_plain(*args, fr, e_max=e_max)
    _same_lv(got, want, ("distance", "e_final", "d_final", "net_indel"))
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


def test_k2_refuses_rescue_forms(card):
    pat = torch.zeros((4, 50), dtype=torch.uint8, device=card)
    w = torch.zeros((4, 10), dtype=torch.int32, device=card)
    tl = torch.full((4,), 60, dtype=torch.int32, device=card)
    for flag in ("reverse", "free_start", "track_pos"):
        with pytest.raises(NotImplementedError):
            bitpar.bitpar_distance_words(pat, w, tl, P=50, TXT=60,
                                         packed_off=4, **{flag: True})


@pytest.mark.parametrize("e_max,W,tables", [(31, 128, True), (5, 32, True),
                                            (31, 100, False)])
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
    script = ("distance", "e_final", "d_final", "net_indel", "acts",
              "matched", "start_run")
    _same_lv(got, want, script + (("L", "A") if tables else ()))
    if not tables:
        assert got.L.shape == (B, 0, 2 * e_max + 1) == got.A.shape


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


def test_aligner_on_card_equals_cpu(card):
    codes = hg_like_genome(300_000, seed=3)
    index = build_index(genome_from_codes(codes), seed_len=20)
    rng = np.random.default_rng(1)
    B, L = 256, 100
    starts = rng.integers(0, codes.size - L - 4, B)
    reads = codes[starts[:, None] + np.arange(L)].copy()
    sub = rng.random((B, L)) < 0.02
    reads[sub] = (reads[sub] + 1) % 4
    for i in range(0, B, 5):                       # indel reads
        p = int(rng.integers(20, 80))
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
