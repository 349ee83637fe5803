"""K3's rows at the width the CIGAR paths give them, made with numpy from
the caller's generator, for the kernel checks of chip_smoke.py and the
tests (numpy only, so they run where neither torch's card nor jax is)."""
import numpy as np

E_MAX_CIGAR = 31      # MAX_K: the CIGAR paths' e_max, with k = 30


def _edit(rng, t, n, indel_share):
    """n random edits of list t in place: substitutions, and insertions or
    deletions of one base with probability indel_share each."""
    for _ in range(n):
        pos = int(rng.integers(0, len(t)))
        r = rng.random()
        if r < indel_share:
            del t[pos]
        elif r < 2 * indel_share:
            t.insert(pos, int(rng.integers(0, 4)))
        else:
            t[pos] = (t[pos] + int(rng.integers(1, 4))) % 4


def cigar_rows(rng, B, P=100):
    """K3's rows as io/sam.py and io/bulk.py hand them over: a read of P
    bases and a reference window of the same width (p_len = t_len = P).
    Rows cycle over four kinds: one 1-3 base insertion or deletion in the
    middle; an insertion into the window and, 10-40 bases on, a deletion
    of the same length (the path runs right of the centre diagonal and
    back); 10-30 random edits (winning levels up to k = 30); and an
    unrelated window (no alignment within k, so all 30 levels run and the
    distance is -1).  The first two add up to three substitutions.  The
    window continues with random bases where the edits shortened it.
    Returns (pattern, p_len, text, t_len)."""
    pats = rng.integers(0, 4, (B, P), dtype=np.uint8)
    texts = rng.integers(0, 4, (B, P), dtype=np.uint8)
    for i in range(B):
        kind = i % 4
        if kind == 3:
            continue
        t = pats[i].tolist()
        if kind == 2:
            _edit(rng, t, int(rng.integers(10, 31)), 0.15)
        else:
            p, m = int(rng.integers(20, P // 2)), int(rng.integers(1, 4))
            if kind == 1:
                q = p + int(rng.integers(10, 41))
                del t[q:q + m]
                t[p:p] = rng.integers(0, 4, m).tolist()
            elif rng.random() < 0.5:
                del t[p:p + m]
            else:
                t[p:p] = rng.integers(0, 4, m).tolist()
            _edit(rng, t, int(rng.integers(0, 4)), 0.0)
        t = t[:P]
        texts[i, :len(t)] = t
    full = np.full(B, P, np.int32)
    return pats, full, texts, full.copy()


def max_path_diagonal(acts, e_final, d_final):
    """The rightmost diagonal (relative to the centre) each row's edit path
    visits, walking the script back from (e_final, d_final) as ops/lv.py
    _recover_actions does: an insertion (2) came from the diagonal right of
    it, a deletion (1) from the one left of it."""
    acts = np.asarray(acts)
    out = np.asarray(d_final).copy()
    for i in range(acts.shape[0]):
        d = int(d_final[i])
        for e in range(int(e_final[i]), 0, -1):
            a = int(acts[i, e - 1])
            d += 1 if a == 2 else (-1 if a == 1 else 0)
            out[i] = max(out[i], d)
    return out
