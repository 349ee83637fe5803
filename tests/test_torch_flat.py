"""The port's flat back half and `trace` against the JAX package, on the CPU.

* aggregate_phase, compact_phase, filtered_score_phase (SNAP_TPU_FAST_SUB
  1 and 0, roomy and tight budgets) and replay_phase (max_hits_to_get 0
  and 4, stop_on_first both ways) of both packages on the same candidates:
  integers bit-identical, log-probabilities within rtol/atol 1e-5;
* tests/test_fast_sub.py's three relations, for the port alone;
* trace_read's text equal to the JAX package's, and through the CLI."""
import contextlib
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snap_rnaseq_tpu.index.genome import genome_from_codes
from snap_rnaseq_tpu.index.hash_index import build_index
from snap_rnaseq_tpu.models import single as js
from snap_rnaseq_tpu.models.single import SingleAligner as JSingleAligner
from snap_rnaseq_tpu.models.trace import trace_read as jax_trace
from snap_rnaseq_tpu.utils.synth_genome import hg_like_genome
from snap_rnaseq_tpu_torch.cli import main as port_cli
from snap_rnaseq_tpu_torch.models import single as ts
from snap_rnaseq_tpu_torch.models.trace import trace_read
from snap_rnaseq_tpu_torch.utils.tables import decode_bases
from test_torch_phases import same, same_dict, simulate_reads, t

B, L = 64, 100
KW = dict(seed_len=20, max_hits=24)      # popular seeds on a small genome


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU runs here take one intra-op thread: the suite runs
    its files in parallel processes, whose thread pools would otherwise
    crowd the cores and wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jd(d):
    """Port tensors -> jnp arrays (u32 views where the JAX engine has
    them)."""
    return {k: jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v
            for k, v in d.items()}


@pytest.fixture(scope="module")
def flat():
    """A repeat-rich genome, reads with substitutions and indels, and the
    port's candidates for them (the phases before aggregation are pinned
    to the JAX engine's by tests/test_torch_phases.py)."""
    codes = hg_like_genome(200_000, seed=5)
    index = build_index(genome_from_codes(codes), seed_len=20)
    reads, quals = simulate_reads(codes, np.random.default_rng(9), B)
    aligner = ts.SingleAligner(index, device="cpu", **KW)
    positions, wraps = aligner.schedule_for(L)
    st = aligner.state
    seeds = ts.seed_phase(torch.from_numpy(reads),
                          tuple(int(p) for p in positions), 20,
                          st["overflow"], aligner.genome_size, st)
    counts = torch.where(seeds["found"][:, :, None], seeds["counts"], 0)
    budget = ts.budget_phase(seeds["valid"], counts,
                             torch.from_numpy(np.asarray(wraps, np.int32)),
                             aligner.cfg)
    cands = ts.expand_phase(seeds, budget,
                            torch.from_numpy(np.asarray(positions, np.int32)),
                            st["overflow"], aligner.cfg, 20, L,
                            aligner.cfg.cand_per_read)
    J = dict(reads=jnp.asarray(reads), quals=jnp.asarray(quals),
             p4=jnp.asarray(st["genome_p4"].numpy()),
             pieces=jnp.asarray(st["piece_starts"].numpy()))
    return dict(codes=codes, index=index, reads=reads, quals=quals,
                aligner=aligner, S=len(positions), budget=budget,
                cands=cands, J=J, gs=aligner.genome_size)


def test_aggregate_phase(flat):
    got = ts.aggregate_phase(flat["cands"])
    same_dict(got, js.aggregate_phase(jd(flat["cands"])))
    assert int(got["live"].sum()) > B


@pytest.mark.parametrize("per_read", [32, 1])
def test_compact_phase(flat, per_read):
    u = ts.aggregate_phase(flat["cands"])
    got, got_over = ts.compact_phase(
        u, B, ts.SingleAlignerConfig(**KW, compact_per_read=per_read))
    want, want_over = js.compact_phase(
        jd(u), B, js.SingleAlignerConfig(**KW, compact_per_read=per_read))
    same_dict(got, want)
    same(got_over, want_over)
    assert (int(want_over) > 0) == (per_read == 1)


def _filtered(flat, fast, budget_B, monkeypatch):
    """filtered_score_phase of both packages on the compacted candidates;
    budget_B scales the pooled LV budgets (B = 2 forces the small tiers'
    overflow)."""
    monkeypatch.setenv("SNAP_TPU_FAST_SUB", fast)
    u, _ = ts.compact_phase(ts.aggregate_phase(flat["cands"]), B,
                            flat["aligner"].cfg)
    st, J = flat["aligner"].state, flat["J"]
    got = ts.filtered_score_phase(
        u, torch.from_numpy(flat["reads"]), torch.from_numpy(flat["quals"]),
        st["genome_p4"], st["piece_starts"], flat["aligner"].cfg, 20, L,
        flat["gs"], budget_B)
    want = js.filtered_score_phase(
        jd(u), J["reads"], J["quals"], J["p4"], J["pieces"],
        js.SingleAlignerConfig(**KW), 20, L, flat["gs"], budget_B)
    return u, got, want


@pytest.mark.parametrize("fast", ["1", "0"])
@pytest.mark.parametrize("budget_B", [B, 2])
def test_filtered_score_phase(flat, fast, budget_B, monkeypatch):
    _, got, want = _filtered(flat, fast, budget_B, monkeypatch)
    same_dict(got, want)
    assert (int(want["n_fast"]) > 0) == (fast == "1")
    assert (int(want["score_overflow"]) > 0) == (budget_B == 2)
    assert int(want["n_bucket2"]) > 0


def test_filtered_score_phase_small_e_max(flat, monkeypatch):
    """At e_max <= 7 (here -d 4: e_max 6) the JAX engine skips both LV
    buckets past E0 (its `hi == e_max and e_max <= E1` test), so
    candidates at whole-read distance 4-6 that the fast path does not
    take are never scored, though LV at e_max 6 scores some of them.  The
    port reproduces it (ROADMAP.md section 3)."""
    from snap_rnaseq_tpu_torch.ops.bitpar import bitpar_distance
    from snap_rnaseq_tpu_torch.ops.genome_gather import gather_windows
    monkeypatch.setenv("SNAP_TPU_FAST_SUB", "1")
    kw = dict(KW, max_k=4)
    tcfg = ts.SingleAlignerConfig(**kw)
    u, _ = ts.compact_phase(ts.aggregate_phase(flat["cands"]), B, tcfg)
    st, J = flat["aligner"].state, flat["J"]
    reads = torch.from_numpy(flat["reads"])
    quals = torch.from_numpy(flat["quals"])
    got = ts.filtered_score_phase(u, reads, quals, st["genome_p4"],
                                  st["piece_starts"], tcfg, 20, L,
                                  flat["gs"], B)
    want = js.filtered_score_phase(jd(u), J["reads"], J["quals"], J["p4"],
                                   J["pieces"], js.SingleAlignerConfig(**kw),
                                   20, L, flat["gs"], B)
    same_dict(got, want)
    # the whole-read distances, and LV at e_max 6 on the skipped rows
    E = tcfg.e_max
    rc = torch.tensor([3, 2, 1, 0, 4, 5], dtype=torch.uint8)[
        reads.flip(1).long()]
    sel = torch.where((u["dir"] == 1)[:, None], rc[u["read"].long()],
                      reads[u["read"].long()])
    loc = torch.where(u["live"], u["loc"], 0)
    win = gather_windows(st["genome_p4"], loc - E, width=L + 2 * E)
    wdist = bitpar_distance(sel, win[:, E:2 * E + L],
                            torch.full((loc.shape[0],), L + E), P=L)
    skipped = u["live"] & (wdist > 3) & (wdist <= E) & ~got["scored_ok"]
    sub = {k: v[skipped] for k, v in u.items()}
    lv = ts.score_phase(sub, reads, quals, st["genome_p4"],
                        st["piece_starts"], tcfg, 20, L, flat["gs"])
    assert int(lv["scored_ok"].sum()) > 0


@pytest.mark.parametrize("max_get", [0, 4])
@pytest.mark.parametrize("stop_on_first", [False, True])
def test_replay_phase(flat, max_get, stop_on_first, monkeypatch):
    u, sc, want_sc = _filtered(flat, "1", B, monkeypatch)
    kw = dict(KW, max_hits_to_get=max_get, stop_on_first=stop_on_first)
    got = ts.replay_phase(u, sc, flat["budget"],
                          torch.from_numpy(flat["reads"]), B, flat["S"],
                          ts.SingleAlignerConfig(**kw))
    want = js.replay_phase(jd(u), want_sc, jd(flat["budget"]),
                           flat["J"]["reads"], B, flat["S"],
                           js.SingleAlignerConfig(**kw))
    same_dict(got, want)
    res = np.asarray(want["result"])
    assert (res == ts.SINGLE_HIT).any()
    assert (res == ts.MULTIPLE_HITS).any() != stop_on_first
    if max_get:
        assert (np.asarray(want["mh_n"]) > 1).any()


def test_segment_sum_is_fixed_order():
    """_segment_sum over unsorted ids equals a serial sum per segment in
    index order; empty segments sum to 0."""
    rng = np.random.default_rng(3)
    vals = rng.uniform(0, 1, 500).astype(np.float32)
    seg = rng.integers(0, 40, 500)
    seg[seg == 7] = 8
    got = ts._segment_sum(torch.from_numpy(vals), torch.from_numpy(seg), 40)
    want = np.zeros(40, np.float32)
    for v, s in zip(vals, seg):
        want[s] += v
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert got[7] == 0


# ------------------------------------------------- test_fast_sub.py, port

@pytest.fixture(scope="module")
def fast_setup():
    """tests/test_fast_sub.py's genome and reads: clean, substitution,
    deletion and insertion reads in turn."""
    rng = np.random.default_rng(7)
    G = 200000
    codes = rng.integers(0, 4, G, dtype=np.uint8)
    idx = build_index(genome_from_codes(codes), seed_len=20)
    n = 32
    starts = rng.integers(0, G - 2 * L, n)
    reads = np.zeros((n, L), np.uint8)
    for i, s in enumerate(starts):
        r = codes[s:s + L + 4].copy()
        kind = i % 4
        if kind == 0:
            r = r[:L]
        elif kind == 1:
            r = r[:L]
            for _ in range(int(rng.integers(1, 4))):
                p = rng.integers(0, L)
                r[p] = (r[p] + rng.integers(1, 4)) % 4
        elif kind == 2:
            p = int(rng.integers(10, L - 10))
            r = np.concatenate([r[:p], r[p + 1:]])[:L]
        else:
            p = int(rng.integers(10, L - 10))
            r = np.concatenate([r[:p], [rng.integers(0, 4)], r[p:]])[:L]
        reads[i] = r
    quals = rng.integers(35, 74, (n, L)).astype(np.uint8)
    return idx, reads, quals


def _score_both_ways(idx, reads, quals, monkeypatch):
    aligner = ts.SingleAligner(idx, device="cpu")
    outs = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("SNAP_TPU_FAST_SUB", flag)
        u, sc, _ = ts.flat_align_batch(aligner, torch.from_numpy(reads),
                                       torch.from_numpy(quals))
        outs[flag] = {k: v.numpy() for k, v in sc.items()}
    return outs["1"], outs["0"], {k: v.numpy() for k, v in u.items()}


def test_fast_path_matches_lv(fast_setup, monkeypatch):
    on, off, _ = _score_both_ways(*fast_setup, monkeypatch)
    np.testing.assert_array_equal(on["scored_ok"], off["scored_ok"])
    ok = on["scored_ok"]
    np.testing.assert_array_equal(on["score"][ok], off["score"][ok])
    np.testing.assert_array_equal(on["loc_adj"][ok], off["loc_adj"][ok])
    # float sum order differs between the closed form and the LV backtrace
    np.testing.assert_allclose(on["logp"][ok], off["logp"][ok],
                               rtol=0, atol=2e-4)


def test_equal_cost_indel_substitution_tie(fast_setup, monkeypatch):
    """An adjacent transposition costs 2 as substitutions and 2 as an
    indel pair: score and loc_adj agree, logp may differ on those rows
    only (the JAX engine's documented deviation)."""
    idx = fast_setup[0]
    codes = np.asarray(idx.genome.codes)
    pad = int(idx.genome.piece_offsets[0])
    rng = np.random.default_rng(11)
    n = 8
    reads = np.zeros((n, L), np.uint8)
    tie = np.zeros(n, bool)
    for i in range(n):
        s = pad + 1000 + i * 1000
        r = codes[s:s + L].copy()
        p = 50
        if i % 2 == 0:
            if r[p] == r[p + 1]:
                r[p + 1] = (r[p + 1] + 1) % 4
            r[p], r[p + 1] = r[p + 1], r[p]
            tie[i] = True
        else:
            r[p] = (r[p] + 1) % 4
            r[p + 17] = (r[p + 17] + 2) % 4
        reads[i] = r
    quals = rng.integers(35, 74, (n, L)).astype(np.uint8)
    on, off, u = _score_both_ways(idx, reads, quals, monkeypatch)
    ok = on["scored_ok"] & off["scored_ok"]
    np.testing.assert_array_equal(on["score"][ok], off["score"][ok])
    np.testing.assert_array_equal(on["loc_adj"][ok], off["loc_adj"][ok])
    non_tie = ok & ~tie[u["read"]]
    np.testing.assert_allclose(on["logp"][non_tie], off["logp"][non_tie],
                               rtol=0, atol=2e-4)
    assert (ok & tie[u["read"]]).sum() > 0


def test_fast_path_covers_majority(fast_setup, monkeypatch):
    idx, reads, quals = fast_setup
    on, _, u = _score_both_ways(idx, reads, quals, monkeypatch)
    assert int(on["n_fast"]) > 0
    indel_free = (np.arange(reads.shape[0]) % 4) < 2
    rows = on["scored_ok"] & indel_free[u["read"]] & u["live"]
    assert int(on["n_fast"]) >= 0.9 * rows.sum()
    monkeypatch.setenv("SNAP_TPU_FAST_SUB", "1")
    out = ts.SingleAligner(idx, device="cpu").align_batch(reads, quals)
    assert (out["result"] > 0).mean() >= 0.9


def test_fast_path_misses_shifted_start(fast_setup, monkeypatch):
    """A read with a base inserted among its first four aligns one base
    right of its seeds' location at cost 1 (LV's head alignment starts
    anywhere).  The prefilter's whole-read distance is anchored at the
    seeds' location, where two substitutions cost 2, equal to the hamming
    count, so the fast path reports score 2 there for some of these reads,
    in the engine as in the flat phases (the JAX engine's fast path is the
    same code; ROADMAP.md section 3)."""
    idx = fast_setup[0]
    g = np.asarray(idx.genome.codes)
    starts = int(idx.genome.piece_offsets[0]) + 5000 + 3000 * np.arange(8)
    reads = np.stack([
        np.concatenate([g[s + 1:s + 2 + k % 4], [(g[s + 1 + k % 4] + 1) % 4],
                        g[s + 2 + k % 4:s + L]]) for k, s in enumerate(starts)
    ]).astype(np.uint8)
    quals = np.full(reads.shape, ord("I"), np.uint8)
    out = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("SNAP_TPU_FAST_SUB", flag)
        out[flag] = ts.SingleAligner(idx, device="cpu").align_batch(reads,
                                                                   quals)
    assert (out["0"]["score"] == 1).all()
    worse = out["1"]["score"] == 2
    assert worse.any()
    np.testing.assert_array_equal(out["1"]["loc"][worse], starts[worse])
    np.testing.assert_array_equal(out["0"]["loc"][worse], starts[worse] + 1)


# ----------------------------------------------------------------- trace

def _trace_reads(codes, pad):
    """A one-substitution read, a read with a two-base deletion, and a
    random read."""
    sub = codes[pad + 10_000:pad + 10_100].copy()
    sub[37] = (sub[37] + 1) % 4
    dele = np.concatenate([codes[pad + 20_000:pad + 20_050],
                           codes[pad + 20_052:pad + 20_102]])
    rand = np.random.default_rng(3).integers(0, 4, L, dtype=np.uint8)
    return dict(substitution=sub, deletion=dele, random=rand)


@pytest.fixture(scope="module")
def traced(flat):
    index = flat["index"]
    pad = int(index.genome.piece_offsets[0])
    reads = _trace_reads(np.asarray(index.genome.codes), pad)
    q = np.full(L, ord("I"), np.uint8)
    jal = JSingleAligner(index)
    return {k: (r, jax_trace(jal, r, q)) for k, r in reads.items()}


# the trace's scoring: LV on every candidate slot, no compaction, no wide
# tier (models/trace.py)
TRACE_CFG = dict(score_budget_per_read=0, compact_per_read=0,
                 overflow_tier=False)


@pytest.mark.parametrize("kind", ["substitution", "deletion", "random"])
def test_trace_matches_jax(flat, traced, kind):
    """The text equals the JAX package's.  Its result line equals the
    engine's under the trace's own scoring, and its score the default
    engine's.  The MAPQ can differ from the default engine's: with every
    slot scored, score_phase leaves loc_adj = 0 on the duplicate slots,
    which split the merge clusters, so two candidates on either side of
    the deletion that adjust to one location both count (MAPQ 3 here
    against 70); the JAX package does the same."""
    read, want = traced[kind]
    q = np.full(L, ord("I"), np.uint8)
    got = trace_read(ts.SingleAligner(flat["index"], device="cpu"), read, q)
    assert got == want
    result = got.splitlines()[-1]
    if kind == "random":
        assert result.startswith("result: NotFound")
        return
    out = ts.SingleAligner(flat["index"], device="cpu",
                           **TRACE_CFG).align_batch(read[None], q[None])
    status = {1: "SingleHit", 2: "MultipleHits"}[int(out["result"][0])]
    assert result.startswith(f"result: {status} ")
    assert f"score {int(out['score'][0])} " in result
    assert f"mapq {int(out['mapq'][0])} " in result
    default = ts.SingleAligner(flat["index"], device="cpu").align_batch(
        read[None], q[None])
    assert default["score"][0] == out["score"][0]
    assert (default["mapq"][0] == out["mapq"][0]) == (kind != "deletion")


def test_trace_cli(flat, traced, tmp_path):
    idx_dir = str(tmp_path / "idx")
    flat["index"].save(idx_dir)
    read, want = traced["deletion"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert port_cli(["trace", idx_dir, decode_bases(read).decode(),
                         "--device", "cpu"]) == 0
    assert buf.getvalue() == want + "\n"
    assert os.path.exists(os.path.join(idx_dir, "index.json"))
