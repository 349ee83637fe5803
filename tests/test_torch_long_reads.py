"""Reads longer than 128 bases (more than four 32-bit pattern words) in
the PyTorch port against the JAX package, on the CPU.

* SingleAligner.align_batch on 150 bp reads: integers bit-identical,
  log-probabilities within rtol/atol 1e-5;
* K4's function (`bitpar_distance`, (B, TXT) code rows) at P = 150 in each
  flag form against the JAX package's dispatcher on the CPU (its plain
  reference, bitpar_distance_jax), and, in the slow tier, against its
  Pallas kernel in interpret mode, as tests/test_bitpar.py runs it.

The card's kernels at these lengths are held against the same plain
versions by tests/test_torch_kernels_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snap_rnaseq_tpu.index.genome import genome_from_codes
from snap_rnaseq_tpu.index.hash_index import build_index
from snap_rnaseq_tpu.models.single import SingleAligner as JSingleAligner
from snap_rnaseq_tpu.ops import bitpar as jbp
from snap_rnaseq_tpu.utils.synth_genome import hg_like_genome
from snap_rnaseq_tpu_torch.models.single import SingleAligner
from snap_rnaseq_tpu_torch.ops import bitpar as tbp
from test_torch_phases import simulate_reads

FLOAT_KEYS = ("log_pbest", "log_pall")


def test_align_batch_matches_jax_at_150bp():
    """Both engines on 32 simulated 150 bp reads (substitutions, indels, N
    bases, both strands) over a 150 kb hg-like genome with the overflow
    tier on, so the whole-read prefilter runs at P = 150 (five words)."""
    codes = hg_like_genome(150_000, seed=8)
    index = build_index(genome_from_codes(codes), seed_len=20)
    reads, quals = simulate_reads(codes, np.random.default_rng(4), 32,
                                  read_len=150)
    kw = dict(max_hits=24, overflow_tier=True, cand_per_read=16)
    want = JSingleAligner(index, **kw).align_batch(reads, quals)
    got = SingleAligner(index, device="cpu", **kw).align_batch(reads, quals)
    assert set(want) <= set(got), set(want) - set(got)
    for k, w in want.items():
        w = np.asarray(w)
        g = np.asarray(got[k])
        if w.dtype == np.uint32:
            g = g.astype(np.int32).view(np.uint32)
        if k in FLOAT_KEYS:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    assert (np.asarray(want["result"]) > 0).all()
    assert int(want["n_scored"]) > 0


def _k4_rows(rng, B, P, TXT, anywhere=True):
    """Patterns with an edited copy in half of the text rows (anywhere, or
    at column 0 where a global start reaches it at no cost), codes >= 4
    and the padding byte 255 in the text, t_len < TXT in some rows."""
    pats = rng.integers(0, 4, (B, P)).astype(np.uint8)
    text = rng.integers(0, 4, (B, TXT)).astype(np.uint8)
    for i in range(0, B, 2):
        seg = pats[i].copy()
        seg[rng.integers(0, P, 4)] ^= 1
        s = int(rng.integers(0, TXT - P + 1)) if anywhere else 0
        text[i, s:s + P] = seg
    text[rng.random((B, TXT)) < 0.01] = 4
    text[:2, TXT - 5:] = 255
    t_len = rng.integers(P, TXT + 1, B).astype(np.int32)
    return pats, text, t_len


@pytest.mark.parametrize("track_pos,free_start", [
    (False, False), (True, False), (False, True), (True, True)])
def test_k4_form_matches_jax_at_150(track_pos, free_start):
    rng = np.random.default_rng(150 + 2 * track_pos + free_start)
    P, TXT = 150, 181
    pats, text, t_len = _k4_rows(rng, 48, P, TXT, anywhere=free_start)
    kw = dict(P=P, track_pos=track_pos, free_start=free_start)
    want = np.asarray(jbp.bitpar_distance(
        jnp.asarray(pats), jnp.asarray(text), jnp.asarray(t_len), **kw))
    got = tbp.bitpar_distance(torch.from_numpy(pats), torch.from_numpy(text),
                              torch.from_numpy(t_len), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    dist = want >> 12 if track_pos else want
    assert (dist <= 8).any()


@pytest.mark.slow
def test_k4_form_matches_jax_pallas_interpret_at_150():
    """The JAX package's K4 kernel itself in interpret mode at P = 150
    (five words): tiny shapes, since the interpreter runs the column loop
    serially (several minutes)."""
    rng = np.random.default_rng(151)
    P, TXT = 150, 24
    pats, text, _ = _k4_rows(rng, 8, P, P)
    text = text[:, :TXT].copy()
    t_len = np.full(8, TXT, np.int32)
    want = np.asarray(jbp.bitpar_distance_pallas(
        jbp.pack_peq(jnp.asarray(pats), P),
        jnp.asarray(text.T.astype(np.int32)), jnp.asarray(t_len), P=P,
        interpret=True, tile=128))
    got = tbp.bitpar_distance(torch.from_numpy(pats), torch.from_numpy(text),
                              torch.from_numpy(t_len), P=P)
    np.testing.assert_array_equal(got.numpy(), want)
