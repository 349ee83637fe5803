"""The port's probe-chain seed lookup against the JAX package, on the CPU.

* ops/lookup.py lookup_seeds against the JAX lookup_seeds on the same
  packed seeds: on tests/test_lookup_cuckoo.py's repeat genome, on an
  index built at a load factor of 0.98 (long chains, stragglers taken in
  more than one block), and on a full table whose chains run past
  MAX_PROBES (a chain cut there counts as not found); the results do not
  depend on the straggler block size;
* probe against cuckoo in the port, lookup and aligners (SingleAligner,
  PairedAligner under SNAP_TPU_LOOKUP=probe);
* the characterizer's probe branch against the JAX package's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snap_rnaseq_tpu.index.genome import genome_from_codes as jgenome
from snap_rnaseq_tpu.index.hash_index import build_index as jbuild_index
from snap_rnaseq_tpu.ops import lookup as jlk
from snap_rnaseq_tpu.rna import filter as jfilter
from snap_rnaseq_tpu_torch.index.genome import genome_from_codes
from snap_rnaseq_tpu_torch.index.hash_index import (build_cuckoo_layout,
                                                    build_index)
from snap_rnaseq_tpu_torch.models.paired import PairedAligner
from snap_rnaseq_tpu_torch.models.single import SingleAligner
from snap_rnaseq_tpu_torch.ops import lookup as tlk
from snap_rnaseq_tpu_torch.ops import u32
from snap_rnaseq_tpu_torch.rna import filter as tfilter
from snap_rnaseq_tpu_torch.utils.seed_sequencer import seed_position_schedule
from snap_rnaseq_tpu_torch.utils.synth_genome import wgsim_pairs

POSITIONS = tuple(range(0, 80, 5))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs its files in parallel
    processes, whose thread pools would otherwise crowd the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def repeat_codes():
    """tests/test_lookup_cuckoo.py's repeat-dense genome: a unit repeated
    with mutations (single hits, overflow lists, palindromic seeds)."""
    rng = np.random.default_rng(3)
    unit = rng.integers(0, 4, 2000, dtype=np.uint8)
    parts = []
    for i in range(30):
        u = unit.copy()
        for _ in range(i):
            p = rng.integers(0, u.size)
            u[p] = (u[p] + 1) % 4
        parts.append(u)
    parts.append(rng.integers(0, 4, 30000, dtype=np.uint8))
    return np.concatenate(parts)


@pytest.fixture(scope="module")
def repeat_index():
    return build_index(genome_from_codes(repeat_codes()), seed_len=20)


@pytest.fixture(scope="module")
def dense_index():
    return build_index(genome_from_codes(repeat_codes()), seed_len=20,
                       load_factor=0.98)


def sample_reads(genome, seed, B=64, L=100):
    """Reads cut from the genome with substitutions and N bases, so
    invalid seeds are exercised."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, genome.num_bases - L, B)
    reads = np.asarray(genome.codes)[starts[:, None] + np.arange(L)].copy()
    for i in range(B):
        for _ in range(rng.integers(0, 4)):
            reads[i, rng.integers(0, L)] = rng.integers(0, 5)
    return np.minimum(reads, 4).astype(np.uint8)


def jax_probe(reads, ht_entries, shard_start, shard_size):
    """The JAX package's lookup_seeds: (found, fwd_val, rc_val) numpy."""
    pj = jlk.pack_seeds(jnp.asarray(reads), POSITIONS, 20)
    return [np.asarray(w) for w in jlk.lookup_seeds(
        pj, jnp.asarray(ht_entries), jnp.asarray(shard_start),
        jnp.asarray(shard_size))]


def port_probe(reads, ht_entries, shard_start, shard_size, rem=None):
    """The port's lookup_seeds on the same seeds: numpy, values uint32."""
    pt = tlk.pack_seeds(torch.from_numpy(reads), POSITIONS, 20)
    got = tlk.lookup_seeds(pt, u32.from_numpy(ht_entries),
                           u32.from_numpy(shard_start),
                           u32.from_numpy(shard_size), rem=rem)
    return [got[0].numpy()] + [u32.to_numpy(g) for g in got[1:]]


def assert_same(got, want, what=""):
    for g, w, name in zip(got, want, ("found", "fwd_val", "rc_val")):
        np.testing.assert_array_equal(g, w, err_msg=f"{name} {what}")


def probe_rounds(monkeypatch, reads, table, rems):
    """The port's lookup at each straggler block size against the JAX
    package's; returns {rem: the shape of each probe gather}: (B, S) for
    the rounds over every lane, (lanes, probes) for a window of a
    straggler block."""
    calls, real = [], tlk._probe

    def counted(ht, base, idx, key):
        calls.append(tuple(idx.shape))
        return real(ht, base, idx, key)
    monkeypatch.setattr(tlk, "_probe", counted)
    want = jax_probe(reads, *table)
    rounds = {}
    for rem in rems:
        calls.clear()
        assert_same(port_probe(reads, *table, rem=rem), want, f"rem={rem}")
        rounds[rem] = list(calls)
    return want, rounds


def test_lookup_seeds_matches_jax_and_cuckoo(repeat_index):
    index = repeat_index
    arrs = index.device_arrays()
    table = (arrs["ht_entries"], arrs["shard_start"], arrs["shard_size"])
    reads = sample_reads(index.genome, 11)
    found, fv, rv = port_probe(reads, *table)
    assert_same((found, fv, rv), jax_probe(reads, *table))
    assert found.sum() > 100 and not found.all()
    layout = build_cuckoo_layout(index.ht_keys, index.ht_val1,
                                 index.ht_val2, index.shard_starts)
    pt = tlk.pack_seeds(torch.from_numpy(reads), POSITIONS, 20)
    ck = tlk.lookup_seeds_cuckoo(pt, *(u32.from_numpy(layout[k]) for k in
                                       ("ck_buckets", "ck_buckets2",
                                        "ck_stash")))
    assert_same([ck[0].numpy()] + [u32.to_numpy(c) for c in ck[1:]],
                (found, fv, rv), "cuckoo")


def test_lookup_seeds_dense_table(dense_index, monkeypatch):
    """At a load factor of 0.98 the chains are long: stragglers remain
    after the unrolled rounds and, three lanes a block, fill several
    blocks; every block size gives the JAX package's result."""
    arrs = dense_index.device_arrays()
    table = (arrs["ht_entries"], arrs["shard_start"], arrs["shard_size"])
    _, rounds = probe_rounds(monkeypatch, sample_reads(dense_index.genome,
                                                       12), table, (None, 3))
    for r in rounds.values():                        # stragglers walked
        assert sum(s[1] for s in r[1 + tlk.UNROLLED:]) > 1
    assert max(s[0] for s in rounds[3][1 + tlk.UNROLLED:]) <= 3
    assert len(rounds[3]) > len(rounds[None])        # several blocks


def test_lookup_seeds_max_probes_cut(monkeypatch):
    """A table with no empty slot, every queried key placed at a drawn
    depth of its own probe chain: the chains run to MAX_PROBES, the
    stragglers fill several default blocks of 256 lanes, and a key placed
    past the last probe is not found, in both packages."""
    rng = np.random.default_rng(5)
    reads = rng.integers(0, 4, (64, 100)).astype(np.uint8)
    n_shards, size = 256, 120      # chains of 75 probes do not wrap
    shard_start = (np.arange(n_shards) * size).astype(np.int32)
    shard_size = np.full(n_shards, size, np.int32)
    ht = rng.integers(0, 1 << 32, (n_shards * size, 3),
                      dtype=np.uint64).astype(np.uint32)
    ht[:, 1] = np.minimum(ht[:, 1], 0xFFFFFFF0)     # never EMPTY
    pt = tlk.pack_seeds(torch.from_numpy(reads), POSITIONS, 20)
    key, shard, _, _ = tlk._canonicalize(pt)
    key, shard = u32.to_numpy(key).ravel(), u32.to_numpy(shard).ravel()
    h0 = u32.to_numpy(tlk.murmur32(u32.from_numpy(key))) % size
    depth = rng.integers(0, 75, key.size)
    for j in range(key.size):
        idx = int(h0[j])
        for n in range(1, depth[j] + 1):
            idx = (idx + (n * n if n < 5 else 1)) % size
        ht[shard_start[shard[j]] + idx, 0] = key[j]
    (found, _, _), rounds = probe_rounds(
        monkeypatch, reads, (ht, shard_start, shard_size), (None, 7))
    found = found.ravel()
    deep = depth > tlk.MAX_PROBES      # probes 0..MAX_PROBES reach a key
    assert deep.any() and not found[deep].any()
    assert found[depth <= tlk.MAX_PROBES].mean() > 0.9
    # at least two full default blocks walked to the cut
    assert sum(s[1] for s in rounds[None][1 + tlk.UNROLLED:]
               if s[0] == 256) >= 2 * (tlk.MAX_PROBES - tlk.UNROLLED)


@pytest.fixture(scope="module")
def probe_world(repeat_index):
    index = repeat_index
    from test_torch_phases import simulate_reads
    codes = repeat_codes()
    reads, quals = simulate_reads(codes, np.random.default_rng(4), 32)
    r0, q0, r1, q1, _, _ = wgsim_pairs(codes, 16, 100, seed=2)
    return dict(index=index, reads=reads, quals=quals,
                pairs=(r0, q0 + 33, r1, q1 + 33))


@pytest.mark.parametrize("kind", ["single", "paired"])
def test_aligner_probe_equals_cuckoo(probe_world, monkeypatch, kind):
    w = probe_world
    kw = dict(max_hits=24, cand_per_read=16) if kind == "single" else {}
    make = SingleAligner if kind == "single" else PairedAligner
    args = ((w["reads"], w["quals"]) if kind == "single" else w["pairs"])
    outs = {}
    for mode in ("cuckoo", "probe"):
        monkeypatch.setenv("SNAP_TPU_LOOKUP", mode)
        al = make(w["index"], device="cpu", **kw)
        assert ("ck_buckets" in al.state) == (mode == "cuckoo")
        assert ("ht_entries" in al.state) == (mode == "probe")
        outs[mode] = al.align_batch(*args)
    assert set(outs["probe"]) == set(outs["cuckoo"])
    for k, v in outs["cuckoo"].items():
        np.testing.assert_array_equal(outs["probe"][k], v, err_msg=k)
    assert (outs["probe"]["result" if kind == "single"
                          else "result0"] > 0).any()


def test_characterize_batch_probe_matches_jax(monkeypatch):
    """tests/test_torch_rna.py's characterizer case, smaller, through the
    probe-chain table in both packages (the JAX characterizer given no
    cuckoo layout), and the port's probe against its cuckoo."""
    rng = np.random.default_rng(21)
    codes = rng.integers(0, 4, 60000, dtype=np.uint8)
    block = codes[2000:2200].copy()
    for j in range(50):
        codes[10000 + 200 * j:10200 + 200 * j] = block
    L = 100
    reads = sample_reads(genome_from_codes(codes), 9, B=16, L=L)
    reads[5] = 4                                   # no valid seed
    reads[7] = block[50:150]                       # > slots hits
    jidx = jbuild_index(jgenome(codes), seed_len=20)
    dev = {k: jnp.asarray(v) for k, v in jidx.device_arrays().items()
           if k in ("ht_entries", "shard_start", "shard_size", "overflow")}
    want = jfilter.BatchCharacterizer(jidx, dev, jidx.genome_size)
    idx = build_index(genome_from_codes(codes), seed_len=20)
    monkeypatch.setenv("SNAP_TPU_LOOKUP", "probe")
    probe_state = SingleAligner(idx, device="cpu").state
    monkeypatch.setenv("SNAP_TPU_LOOKUP", "cuckoo")
    ck_state = SingleAligner(idx, device="cpu").state
    got = tfilter.BatchCharacterizer(idx, probe_state)
    wrows, grows = want.characterize(reads), got.characterize(reads)
    for i in range(len(reads)):
        g_f, g_r = grows(i)
        w_f, w_r = wrows(i)
        assert list(g_f.items()) == list(w_f.items()), i
        assert list(g_r.items()) == list(w_r.items()), i
    positions = tuple(int(p) for p in
                      seed_position_schedule(L, 20)[0][:got.max_seeds])
    run = lambda st: tfilter.characterize_batch(
        torch.from_numpy(reads), st, positions=positions, seed_len=20,
        max_hits=got.max_hits, read_len=L, cpr=got.slots)
    p_out, c_out = run(probe_state), run(ck_state)
    assert int(p_out["total"][7]) > got.slots
    for k, v in c_out.items():
        np.testing.assert_array_equal(p_out[k].numpy(), v.numpy(),
                                      err_msg=k)
