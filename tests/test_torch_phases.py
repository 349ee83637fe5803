"""Engine phases of the PyTorch port against the JAX engine, on the CPU.

Both packages are fed the same index tables: the JAX package's numpy
device arrays go through the port's index_state_from_numpy.  Each phase
of models/single.py's _align_batch runs in both on the same inputs (the
JAX phase's inputs, converted); integers must be bit-identical and
log-probabilities agree to rtol/atol 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snap_rnaseq_tpu.index.genome import genome_from_codes
from snap_rnaseq_tpu.index.hash_index import build_index, cuckoo_layout_for
from snap_rnaseq_tpu.models import single as js
from snap_rnaseq_tpu.ops.genome_gather import pack_genome_4bit
from snap_rnaseq_tpu.utils.seed_sequencer import seed_position_schedule
from snap_rnaseq_tpu.utils.synth_genome import hg_like_genome
from snap_rnaseq_tpu_torch.models import single as ts
from snap_rnaseq_tpu_torch.ops import u32

B, L = 64, 100


def t(x):
    a = np.array(x)
    if a.dtype == np.uint32:
        return u32.from_numpy(a)
    return torch.from_numpy(a)


def td(d):
    return {k: (t(v) if hasattr(v, "shape") else v) for k, v in d.items()}


def same(got, want, name=""):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    if w.dtype == np.uint32:
        g = g.astype(np.int32).view(np.uint32)
    if w.dtype == np.float32:
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=name)
    else:
        np.testing.assert_array_equal(g, w, err_msg=name)


def same_dict(got, want, keys=None):
    for k in keys or want:
        same(got[k], want[k], k)


def simulate_reads(codes, rng, n, read_len=L):
    """Reads with substitutions, some indels, N bases and RC orientation."""
    reads = np.empty((n, read_len), np.uint8)
    for i in range(n):
        s = int(rng.integers(0, codes.size - read_len - 8))
        seg = list(codes[s:s + read_len + 8])
        for _ in range(int(rng.integers(0, 4))):
            p = int(rng.integers(0, read_len))
            seg[p] = (seg[p] + int(rng.integers(1, 4))) % 4
        if rng.random() < 0.35:
            p = int(rng.integers(10, read_len - 10))
            if rng.random() < 0.5:
                del seg[p:p + int(rng.integers(1, 3))]
            else:
                seg[p:p] = list(rng.integers(0, 4, int(rng.integers(1, 3))))
        r = np.asarray(seg[:read_len], np.uint8)
        if rng.random() < 0.5:
            r = (3 - r[::-1]).astype(np.uint8)
        if rng.random() < 0.1:
            r[int(rng.integers(0, read_len))] = 4
        reads[i] = r
    quals = rng.integers(40, 74, (n, read_len)).astype(np.uint8)
    return reads, quals


@pytest.fixture(scope="module")
def world():
    codes = hg_like_genome(200_000, seed=5)
    index = build_index(genome_from_codes(codes), seed_len=20)
    arrs = index.device_arrays()
    cuckoo = cuckoo_layout_for(index)
    p4 = pack_genome_4bit(arrs["genome_codes"])
    pieces = index.genome.piece_offsets.astype(np.int32)
    reads, quals = simulate_reads(codes, np.random.default_rng(9), B)
    positions, wraps = seed_position_schedule(L, 20)
    positions, wraps = positions[:48], wraps[:48]
    gs = index.genome_size
    state = ts.index_state_from_numpy(
        dict(arrs, genome_p4=p4, piece_starts=pieces), cuckoo, "cpu")
    # a low popularity cutoff so the small genome has popular seeds
    kw = dict(seed_len=20, max_hits_to_get=4, max_hits=24)
    jcfg = js.SingleAlignerConfig(**kw)
    tcfg = ts.SingleAlignerConfig(**kw)
    J = dict(reads=jnp.asarray(reads), quals=jnp.asarray(quals),
             p4=jnp.asarray(p4), pieces=jnp.asarray(pieces),
             cuckoo={k: jnp.asarray(v) for k, v in cuckoo.items()},
             overflow=jnp.asarray(arrs["overflow"]),
             positions=jnp.asarray(positions), wraps=jnp.asarray(wraps))
    seeds = js.seed_phase(J["reads"], J["positions"], 20, None, None, None,
                          J["overflow"], gs,
                          tuple(int(p) for p in positions), J["cuckoo"])
    cg = jnp.where(seeds["found"][:, :, None], seeds["counts"], 0)
    budget = js.budget_phase(seeds["valid"], cg, J["wraps"], jcfg)
    cands = js.expand_phase(seeds, budget, J["positions"], J["overflow"],
                            jcfg, 20, L, jcfg.cand_per_read)
    u2 = js._aggregate_rows(cands)
    sc2 = js.rowwise_score_phase(u2, J["reads"], J["quals"], J["p4"],
                                 J["pieces"], jcfg, 20, L, gs)
    return dict(index=index, state=state, reads=reads, quals=quals,
                positions=positions, wraps=wraps, gs=gs, jcfg=jcfg,
                tcfg=tcfg, J=J, seeds=seeds, counts_global=cg,
                budget=budget, cands=cands, u2=u2, sc2=sc2)


def test_index_state_carries_tables(world):
    st, idx = world["state"], world["index"]
    same(st["overflow"], idx.device_arrays()["overflow"])
    same(st["genome_p4"], np.asarray(world["J"]["p4"]))
    same(st["ck_buckets"], np.asarray(world["J"]["cuckoo"]["ck_buckets"]))
    assert st["genome_size"] == idx.genome_size


def test_small_helpers(world):
    pieces = np.array([0, 500, 9000, 70000], np.int32)
    locs = np.array([0, 499, 500, 8999, 9000, 69999, 70000, 2 ** 31 - 1],
                    np.int32)
    same(ts.piece_index_of(t(pieces), t(locs)),
         js.piece_index_of(jnp.asarray(pieces), jnp.asarray(locs)))
    big_p = np.array([0, -2 ** 31 + 5, -100], np.int32)     # u32 order
    big_l = np.array([3, -2 ** 31 + 4, -2 ** 31 + 6, -99, -1], np.int32)
    same(ts.piece_index_of(t(big_p), t(big_l), big=True),
         js.piece_index_of(jnp.asarray(big_p), jnp.asarray(big_l), big=True))
    assert ts.big_locations(3_100_000_000) and not ts.big_locations(10 ** 9)
    rng = np.random.default_rng(2)
    tbl = rng.integers(-9, 9, (5, 64)).astype(np.int32)
    idx = rng.integers(0, 64, (5, 128)).astype(np.int32)
    same(ts.row_select(t(tbl), t(idx)),
         js.row_select(jnp.asarray(tbl), jnp.asarray(idx)))
    for seed in range(3):
        mask = np.random.default_rng(seed).random(300) < 0.3
        same(ts.stable_partition_indices(t(mask), 120),
             js.stable_partition_indices(jnp.asarray(mask), 120))


def test_seed_phase(world):
    got = ts.seed_phase(t(world["reads"]),
                        tuple(int(p) for p in world["positions"]), 20,
                        world["state"]["overflow"], world["gs"],
                        world["state"])
    same_dict(got, world["seeds"])
    assert np.asarray(world["seeds"]["counts"]).max() > 1   # overflow lists


def _cfgs(world, **variant):
    """(JAX config, port config, JAX budget) for a config variant."""
    kw = dict(seed_len=20, max_hits_to_get=4, max_hits=24, **variant)
    jcfg, tcfg = js.SingleAlignerConfig(**kw), ts.SingleAlignerConfig(**kw)
    budget = js.budget_phase(world["seeds"]["valid"], world["counts_global"],
                             world["J"]["wraps"], jcfg)
    return jcfg, tcfg, budget


@pytest.mark.parametrize("variant", [
    {}, {"explore_popular": True}, {"seed_budget_per_position": True}])
def test_budget_phase(world, variant):
    s = world["seeds"]
    _, tcfg, want = _cfgs(world, **variant)
    got = ts.budget_phase(t(s["valid"]), t(world["counts_global"]),
                          t(world["wraps"]), tcfg)
    same_dict(got, want)
    assert np.asarray(want["popular"]).any()


@pytest.mark.parametrize("cand_slots,explore", [(128, False), (8, False),
                                                (128, True)])
def test_expand_phase(world, cand_slots, explore):
    jcfg, tcfg, budget = _cfgs(world, explore_popular=explore)
    want = js.expand_phase(world["seeds"], budget, world["J"]["positions"],
                           world["J"]["overflow"], jcfg, 20, L, cand_slots)
    got = ts.expand_phase(td(world["seeds"]), td(budget),
                          t(world["positions"]), world["state"]["overflow"],
                          tcfg, 20, L, cand_slots)
    same_dict(got, want)
    if cand_slots == 8:
        assert np.asarray(want["truncated"]).max() > 0


def test_aggregate_rows(world):
    got = ts._aggregate_rows(td(world["cands"]))
    same_dict(got, world["u2"])


@pytest.mark.parametrize("qlp", [False, True])
def test_score_phase(world, qlp):
    u2 = world["u2"]
    R, W = np.asarray(u2["dir"]).shape
    # every live candidate plus some dead slots
    live = np.asarray(u2["live"]).reshape(R * W)
    pick = np.concatenate([np.flatnonzero(live), np.flatnonzero(~live)[:64]])
    flat = lambda x: jnp.asarray(x).reshape(R * W)[pick]
    u = dict(read=jnp.asarray((pick // W).astype(np.int32)),
             dir=flat(u2["dir"]), loc=flat(u2["loc"]), off=flat(u2["off"]),
             live=flat(u2["live"]))
    J = world["J"]
    q = None
    if qlp:
        from snap_rnaseq_tpu.ops.lv import phred_log_prob_device
        q = phred_log_prob_device(jnp.stack([J["quals"],
                                             J["quals"][:, ::-1]], axis=1))
    want = js.score_phase(u, J["reads"], J["quals"], J["p4"], J["pieces"],
                          world["jcfg"], 20, L, world["gs"], qlp_both=q)
    st = world["state"]
    got = ts.score_phase(td(u), t(world["reads"]), t(world["quals"]),
                         st["genome_p4"], st["piece_starts"], world["tcfg"],
                         20, L, world["gs"],
                         qlp_both=None if q is None else t(q))
    same_dict(got, want)
    assert np.asarray(want["scored_ok"]).sum() > 10


def test_rowwise_score_phase(world):
    st = world["state"]
    got = ts.rowwise_score_phase(td(world["u2"]), t(world["reads"]),
                                 t(world["quals"]), st["genome_p4"],
                                 st["piece_starts"], world["tcfg"], 20, L,
                                 world["gs"])
    want = world["sc2"]
    same_dict(got, want, ("score", "logp", "loc_adj", "scored_ok",
                          "score_overflow", "n_fast"))
    # the LV tiers ran: some scored rows did not come from the fast path
    assert int(np.asarray(want["scored_ok"]).sum()) > int(want["n_fast"])


def test_rowwise_score_phase_no_prefilter(world):
    jcfg = js.SingleAlignerConfig(seed_len=20, score_budget_per_read=0)
    tcfg = ts.SingleAlignerConfig(seed_len=20, score_budget_per_read=0)
    J, st = world["J"], world["state"]
    u2 = {k: v[:8] for k, v in world["u2"].items()}
    want = js.rowwise_score_phase(u2, J["reads"][:8], J["quals"][:8],
                                  J["p4"], J["pieces"], jcfg, 20, L,
                                  world["gs"])
    got = ts.rowwise_score_phase(td(u2), t(world["reads"][:8]),
                                 t(world["quals"][:8]), st["genome_p4"],
                                 st["piece_starts"], tcfg, 20, L,
                                 world["gs"])
    same_dict(got, want, ("score", "logp", "loc_adj", "scored_ok"))


@pytest.mark.parametrize("stop_on_first", [False, True])
def test_rowwise_replay_phase(world, stop_on_first):
    S = len(world["positions"])
    jcfg, tcfg, _ = _cfgs(world, stop_on_first=stop_on_first)
    want = js.rowwise_replay_phase(world["u2"], world["sc2"],
                                   world["budget"], world["J"]["reads"], S,
                                   jcfg)
    got = ts.rowwise_replay_phase(td(world["u2"]), td(world["sc2"]),
                                  td(world["budget"]), t(world["reads"]), S,
                                  tcfg)
    same_dict(got, want)
    assert (np.asarray(want["mh_n"]) > 1).any()


def test_dense_topk_rowwise(world):
    for K in (128, 8):
        want = js.dense_topk_rowwise(world["u2"], world["sc2"], K)
        got = ts.dense_topk_rowwise(td(world["u2"]), td(world["sc2"]), K)
        same_dict(got, want)


def test_compute_mapq():
    rng = np.random.default_rng(4)
    n = 2000
    lp_best = rng.uniform(-60, 0, n).astype(np.float32)
    lp_other = (lp_best + rng.uniform(-50, 10, n)).astype(np.float32)
    lp_other[::7] = -1e30
    lp_all = np.logaddexp(lp_best, lp_other).astype(np.float32)
    score = rng.integers(0, 16, n).astype(np.int32)
    popular = rng.integers(0, 30, n).astype(np.int32)
    args = (lp_all, lp_best, lp_other, score, popular)
    same(ts._compute_mapq(*map(t, args)),
         js._compute_mapq(*map(jnp.asarray, args)))
