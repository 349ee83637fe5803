"""The LV kernels' CPU-side checks at their paths' widths.

* The CIGAR path at K3's real width: the port's compute_cigars (its plain
  version on the CPU) against the JAX package's at P = 100, e_max 31,
  k 30, on rows with short indels (one kind running right of the centre
  diagonal and back), rows needing 10-30 edits and rows that fail;
  integers and tokens identical.
* K5's mismatch masks (csrc/lv_onehot.cu MismatchMasks) replayed in plain
  torch: the words per diagonal as the kernel's ballots gather them (one
  compare per lane), then the first set bit from p as its extension walks
  them, against a brute-force next mismatch with the free prefix and the
  sentinels, across word boundaries.
"""
import numpy as np
import pytest
import torch

from snap_rnaseq_tpu.ops import cigar as jcg
from snap_rnaseq_tpu_torch.ops import cigar as tcg
from snap_rnaseq_tpu_torch.tools.cigar_cases import E_MAX_CIGAR, cigar_rows

ROW_SLACK = 8          # lvk::ROW_SLACK, bytes after each staged row


@pytest.mark.parametrize("use_m", [False, True])
def test_compute_cigars_at_k3_width(use_m):
    rng = np.random.default_rng(31 + use_m)
    pats, p_len, texts, t_len = cigar_rows(rng, 60)
    dj, tj = jcg.compute_cigars(pats, p_len, texts, t_len, use_m=use_m,
                                k=E_MAX_CIGAR - 1, e_max=E_MAX_CIGAR)
    dt, tt = tcg.compute_cigars(pats, p_len, texts, t_len, use_m=use_m,
                                k=E_MAX_CIGAR - 1, e_max=E_MAX_CIGAR,
                                device="cpu")
    np.testing.assert_array_equal(dt, np.asarray(dj))
    assert tt == tj
    assert (dt[3::4] == -1).all()                      # unrelated windows
    assert (dt >= 20).any() and (dt[0::4] <= 9).all()
    assert any(tok and any(op in "ID" for _, op in tok) for tok in tt)


# ---------------------------------------------------------------- K5 masks

def _staged(pats, texts, t_len, P, e_max):
    """Rows as csrc/lv_warp.cuh stages them: the pattern, zeros after P;
    e_max sentinels (255), the text masked to t_len, then sentinels
    (txt[j] is text position j - e_max); ROW_SLACK bytes after each.  As
    int64 tensors."""
    B, T = texts.shape
    pat = np.zeros((B, P + ROW_SLACK), np.int64)
    pat[:, :P] = pats
    n = P + 2 * e_max + ROW_SLACK
    txt = np.full((B, n), 255, np.int64)
    for i in range(B):
        m = min(int(t_len[i]), T, n - e_max)
        txt[i, e_max:e_max + m] = texts[i, :m]
    return torch.from_numpy(pat), torch.from_numpy(txt)


def _masks_ballot(pat, txt, free, P, e_max):
    """The ballot build: lane b of word w compares position 32 w + b."""
    D, NW = 2 * e_max + 1, (P + 31) // 32
    p = torch.arange(32 * NW)
    live = (p[None] < P) & (p[None] >= free[:, None])              # (B, 32NW)
    pad = torch.zeros((pat.shape[0], 32 * NW + ROW_SLACK), dtype=torch.int64)
    pad[:, :pat.shape[1]] = pat
    out = torch.zeros((pat.shape[0], NW, D), dtype=torch.int64)
    for d in range(D):
        t = torch.full_like(pad, 255)
        m = min(txt.shape[1] - d, t.shape[1])
        t[:, :m] = txt[:, d:d + m]
        mm = live & (pad[:, :32 * NW] != t[:, :32 * NW])
        words = (mm.view(-1, NW, 32).long() << torch.arange(32)).sum(2)
        out[:, :, d] = words
    return out


def _ctz(x):
    """Trailing zeros of each nonzero int64 (the position __ffs - 1)."""
    return torch.log2((x & -x).double()).long()


def _extend(words, p, end):
    """MismatchMasks::operator() at every row, diagonal and position p:
    the first set bit at or after p (the word shifted right by p & 31,
    else the first nonzero word after it), clipped to end.  words (B, NW,
    D); p (n,); end (B, D, n).  Returns (B, D, n)."""
    B, NW, D = words.shape
    big = torch.iinfo(torch.int64).max
    # after[:, w]: the first set bit in a word after w, else big
    after = torch.full((B, NW + 1, D), big, dtype=torch.int64)
    for w in range(NW - 1, -1, -1):
        x = words[:, w]
        after[:, w] = torch.where(x != 0, 32 * w + _ctz(x), after[:, w + 1])
    w = p >> 5
    x = words[:, w, :].transpose(1, 2) >> (p & 31)          # (B, D, n)
    first = torch.where(x != 0, p + _ctz(x),
                        after[:, w + 1, :].transpose(1, 2))
    return torch.minimum(first, end)


@pytest.mark.parametrize("e_max", [16, 17])
@pytest.mark.parametrize("P", [31, 32, 33, 64, 100])
def test_k5_mask_replay(P, e_max):
    """Rows with free prefixes 0, 31, 32, 33 and P (a word boundary and
    either side of it, and the whole read) and texts cut short of P + d,
    whose sentinels must mismatch: the extension from every (diagonal, p)
    to two ends equals the first q >= max(p, free) with
    pat[q] != txt[q + d]."""
    rng = np.random.default_rng(100 * e_max + P)
    B, T = 10, P + e_max
    pats = rng.integers(0, 4, (B, P), dtype=np.uint8)
    texts = rng.integers(0, 4, (B, T), dtype=np.uint8)
    for i in range(B):                     # a few edits of the pattern
        t = pats[i].tolist()
        for _ in range(int(rng.integers(1, 5))):
            pos = int(rng.integers(0, len(t)))
            t[pos] = (t[pos] + 1) % 4
        texts[i, :P] = t
    free = np.array([min(f, P) for f in (0, 31, 32, 33, P)] * 2, np.int64)
    t_len = np.where(np.arange(B) < 5, T, P // 2 - 1)
    pat, txt = _staged(pats, texts, t_len, P, e_max)
    fr = torch.from_numpy(free)
    words = _masks_ballot(pat, txt, fr, P, e_max)
    D = 2 * e_max + 1
    # brute force: the next mismatch at or after each p on each diagonal,
    # else P (a reversed running minimum)
    q = torch.arange(P)
    d = torch.arange(D)
    mm = ((q >= fr[:, None, None])
          & (pat[:, None, :P] != txt[:, d[:, None] + q[None, :]]))
    nxt = torch.where(mm, q, P).flip(2).cummin(2).values.flip(2)
    ends = torch.from_numpy(rng.integers(q + 1, P + 1, (B, D, P)))
    for end in (torch.full((B, D, P), P), ends):
        assert torch.equal(_extend(words, q, end), torch.minimum(nxt, end))
    # row 5 (free 0, text cut to P // 2 - 1): on the last diagonal every
    # position of the last word reads a sentinel, so all its bits are set
    NW = (P + 31) // 32
    assert int(words[5, NW - 1, D - 1]) == (1 << (P - 32 * (NW - 1))) - 1
