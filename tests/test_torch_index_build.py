"""The port's index build on a device (index/hash_index.py
build_index_device, here on CPU tensors) against the JAX package.

* the device build equals the JAX build_index and build_index_chunked
  array for array (ht_keys, ht_val1, ht_val2, shard_starts, overflow,
  shard_ovf_starts) at seed lengths 16, 20 and 25 (at 25 build_index
  only: the chunked builder opens three spill files for each of the
  262,144 logical tables, past the open-file limit), with budgets small
  enough that packing chunks cut seeds, groups cut the logical tables and
  inserts cut the groups; on N runs and several pieces, a repeat-heavy
  genome (long overflow lists, which must descend), load factor 0.98
  (long probe chains), and built straight into 1-8 index slices;
* the torch seed packing and hash equal the numpy ones;
* the build straight into n_index 2, 4 and 8 slices equals the JAX
  partition_index of the JAX build (the probe-chain branch), and its
  genome_index(), assembled slice by slice, equals build_index;
* the slice count follows the int32 limit of a slice's slot offsets;
* the mesh takes a DeviceIndex's own slices for the probe-chain lookup
  only;
* the CLI `index` and `transcriptome` with --device cpu write the JAX
  CLI's files byte for byte, also with that limit lowered so that the
  build goes through several slices, and without a card the default
  raises;
* tools/hg_scale.py at 2.4 Mb (24 x 100 kb pieces): its table statistics
  and lookup check, and its align run on a (1, 8) CPU mesh, whose
  statistics dict equals the JAX ShardedPairedAligner's on 8 virtual CPU
  devices over the same batches;
* both packages narrow shard_starts to int32 for the single-card engine
  (GenomeIndex.device_arrays), so neither takes a table past 2^31 slots
  there: the shared limit, pinned.

The card's test is test_index_build_on_card_equals_cpu in
tests/test_torch_kernels_cuda.py."""
import contextlib
import io
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from snap_rnaseq_tpu.cli import main as jax_cli
from snap_rnaseq_tpu.index.genome import Genome as JGenome
from snap_rnaseq_tpu.index.hash_index import GenomeIndex as JGenomeIndex
from snap_rnaseq_tpu.index.hash_index import build_index as jbuild
from snap_rnaseq_tpu.index.hash_index import \
    build_index_chunked as jbuild_chunked
from snap_rnaseq_tpu.parallel import sharded as jsh
from snap_rnaseq_tpu_torch.cli import main as port_cli
from snap_rnaseq_tpu_torch.index.genome import Genome
from snap_rnaseq_tpu_torch.index import hash_index as hix
from snap_rnaseq_tpu_torch.index.hash_index import (GenomeIndex,
                                                    build_index_device)
from snap_rnaseq_tpu_torch.index.seeds import (murmur_finalize_torch,
                                               murmur_finalize_u32,
                                               pack_all_seeds,
                                               pack_all_seeds_torch)
from snap_rnaseq_tpu_torch.ops import u32
from snap_rnaseq_tpu_torch.parallel import sharded as tsh
from snap_rnaseq_tpu_torch.tools import hg_scale
from snap_rnaseq_tpu_torch.utils.synth_genome import hg_like_genome
from snap_rnaseq_tpu_torch.utils.tables import BASE_PAD, decode_bases

ARRAYS = ("ht_keys", "ht_val1", "ht_val2", "shard_starts", "overflow",
          "shard_ovf_starts")
# budgets small enough to cut seeds across packing chunks, logical tables
# across sort groups and groups across insert batches
SMALL = dict(chunk=997, group_seeds=3_000, insert_keys=1_000)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs its files in parallel
    processes, whose thread pools would otherwise crowd the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pieces_genome(chroms, pad=500):
    """Both packages' Genome of `chroms`, each after `pad` padding codes,
    and `pad` more at the end (read_fasta_genome's layout)."""
    parts, offsets, pos = [], [], 0
    for c in chroms:
        parts += [np.full(pad, BASE_PAD, np.uint8), c]
        offsets.append(pos + pad)
        pos += pad + c.size
    parts.append(np.full(pad, BASE_PAD, np.uint8))
    codes = np.concatenate(parts)
    names = [f"chr{i + 1}" for i in range(len(chroms))]
    offs = np.asarray(offsets, np.int64)
    return (Genome(codes=codes, piece_names=names, piece_offsets=offs,
                   padding=pad),
            JGenome(codes=codes.copy(), piece_names=names,
                    piece_offsets=offs.copy(), padding=pad))


def with_n_runs(codes, rng, n_runs=12):
    """Genome Ns (code 5) in runs of 1-60 bases."""
    codes = codes.copy()
    for s in rng.integers(0, codes.size - 60, n_runs):
        codes[s:s + int(rng.integers(1, 61))] = BASE_PAD
    return codes


def repeat_heavy(n, rng):
    """Mostly copies of a 180-base unit with a few substitutions: seeds
    with hundreds of hits."""
    unit = rng.integers(0, 4, 180, dtype=np.uint8)
    reps = np.tile(unit, n // 180 + 1)[:n]
    flip = rng.random(n) < 0.004
    reps[flip] = (reps[flip] + 1) % 4
    reps[: n // 5] = rng.integers(0, 4, n // 5, dtype=np.uint8)
    return reps


def same_arrays(got: GenomeIndex, want: JGenomeIndex, what):
    for k in ARRAYS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, (what, k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: {k}")


def descending_lists(idx):
    """Every overflow list of the table strictly descending, and how many
    lists there are."""
    gsize = idx.genome_size
    n = 0
    for v in np.concatenate([idx.ht_val1, idx.ht_val2]):
        if gsize <= v < 0xFFFFFFFE:
            off = int(v) - gsize
            lst = idx.overflow[off + 1:off + 1 + int(idx.overflow[off])]
            assert (np.diff(lst.astype(np.int64)) < 0).all()
            n += 1
    return n


def test_seed_packing_and_hash_equal_numpy():
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, 3_000).astype(np.uint8)
    codes[rng.random(3_000) < 0.05] = 4
    codes[rng.random(3_000) < 0.05] = BASE_PAD
    for L in range(16, 26):
        want = pack_all_seeds(codes, L)
        got = pack_all_seeds_torch(torch.from_numpy(codes), L)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), w.astype(g.numpy().dtype))
    keys = rng.integers(0, 1 << 32, 5_000, dtype=np.uint64)
    np.testing.assert_array_equal(
        murmur_finalize_torch(torch.from_numpy(keys.astype(np.int64))).numpy(),
        murmur_finalize_u32(keys).astype(np.int64))


@pytest.mark.parametrize("seed_len", [16, 20, 25])
def test_device_build_equals_both_jax_builders(seed_len):
    """Several pieces with N runs, at each seed length, with the default
    budgets and with SMALL ones."""
    rng = np.random.default_rng(seed_len)
    chroms = [with_n_runs(hg_like_genome(n, seed=seed_len + i), rng)
              for i, n in enumerate((40_000, 25_000, 9_000))]
    genome, jgenome = pieces_genome(chroms)
    want = jbuild(jgenome, seed_len)
    if seed_len < 25:   # the JAX chunked builder opens 3 files per table
        same_arrays(jbuild_chunked(jgenome, seed_len, chunk=4_096), want,
                    "JAX chunked")
    for budgets in ({}, SMALL):
        got = build_index_device(genome, seed_len, device="cpu", **budgets)
        same_arrays(got.genome_index(), want, f"L={seed_len} {budgets}")


def test_repeat_heavy_genome_long_descending_overflow_lists():
    rng = np.random.default_rng(5)
    genome, jgenome = pieces_genome([repeat_heavy(30_000, rng),
                                     repeat_heavy(12_000, rng)])
    want = jbuild_chunked(jgenome, 20, chunk=5_000)
    got = build_index_device(genome, 20, device="cpu", **SMALL).genome_index()
    same_arrays(got, want, "repeat-heavy")
    counts = [int(got.overflow[int(v) - got.genome_size])
              for v in got.ht_val1 if got.genome_size <= v < 0xFFFFFFFE]
    assert max(counts) >= 100
    assert descending_lists(got) > 100


def test_load_factor_098_long_probe_chains():
    rng = np.random.default_rng(6)
    genome, jgenome = pieces_genome([hg_like_genome(50_000, seed=6),
                                     with_n_runs(hg_like_genome(20_000,
                                                                seed=7), rng)])
    want = jbuild(jgenome, 20, load_factor=0.98)
    got = build_index_device(genome, 20, load_factor=0.98, device="cpu",
                             **SMALL).genome_index()
    same_arrays(got, want, "lf 0.98")
    # the keys that needed more than one probe: murmur start != slot
    starts = got.shard_starts
    moved = 0
    for s in range(got.n_shards):
        lo, hi = int(starts[s]), int(starts[s + 1])
        if hi == lo:
            continue
        used = np.nonzero(got.ht_val1[lo:hi] != 0xFFFFFFFF)[0]
        home = murmur_finalize_u32(got.ht_keys[lo:hi][used]).astype(
            np.int64) % (hi - lo)
        moved += int((home != used).sum())
    assert moved > 1_000


@pytest.mark.parametrize("n_idx", [2, 4, 8])
def test_slices_equal_jax_partition_index(n_idx):
    """The device build straight into n_idx slices against the JAX
    partition of the JAX build (probe-chain branch), and its host tables,
    assembled slice by slice, against the JAX build."""
    rng = np.random.default_rng(n_idx)
    genome, jgenome = pieces_genome(
        [with_n_runs(hg_like_genome(30_000, seed=n_idx), rng),
         repeat_heavy(8_000, rng)])
    jindex = jbuild(jgenome, 20)
    want = jsh.partition_index(jindex, n_idx, use_cuckoo=False)
    got = build_index_device(genome, 20, device="cpu", n_index=n_idx,
                             **SMALL)
    parts = got.parts
    for k in ("ht_entries", "overflow"):
        np.testing.assert_array_equal(
            u32.to_numpy(torch.stack(parts[k])), want[k], err_msg=k)
    for k in ("shard_start", "shard_size"):
        np.testing.assert_array_equal(parts[k].numpy(), want[k], err_msg=k)
    np.testing.assert_array_equal(parts["cuts"], want["cuts"])
    same_arrays(got.genome_index(), jindex, f"{n_idx} slices")


def test_slice_count_follows_the_int32_limit(monkeypatch):
    """slices_needed: the fewest balanced slices of at most
    MAX_SLICE_SLOTS slots, and an error for one table past it."""
    starts = np.concatenate(([0], np.cumsum([30, 50, 10, 40, 20, 0, 60])))
    monkeypatch.setattr(hix, "MAX_SLICE_SLOTS", 1_000)
    assert hix.slices_needed(starts) == 1
    monkeypatch.setattr(hix, "MAX_SLICE_SLOTS", 100)
    n = hix.slices_needed(starts)
    sizes = np.diff(starts[hix.slice_cuts(starts, n)])
    assert n == 3 and sizes.max() <= 100
    assert np.diff(starts[hix.slice_cuts(starts, n - 1)]).max() > 100
    monkeypatch.setattr(hix, "MAX_SLICE_SLOTS", 59)
    with pytest.raises(ValueError, match="logical table"):
        hix.slices_needed(starts)
    with pytest.raises(ValueError, match="past int32"):
        hix.slice_layout(starts, np.zeros_like(starts),
                         hix.slice_cuts(starts, 2))


def test_device_index_on_the_mesh_serves_the_probe_lookup_only(
        monkeypatch):
    """ShardedPairedAligner takes a DeviceIndex's own slices: under the
    cuckoo lookup (the default) it raises rather than using the probe
    chain silently, and it refuses a slice count unlike the mesh's."""
    genome, _ = pieces_genome([hg_like_genome(6_000, seed=3)])
    di = build_index_device(genome, 20, device="cpu", n_index=2)
    mesh = tsh.make_mesh(1, 2, device="cpu")
    monkeypatch.delenv("SNAP_TPU_LOOKUP", raising=False)
    with pytest.raises(ValueError, match="probe-chain"):
        tsh.ShardedPairedAligner(di, mesh)
    monkeypatch.setenv("SNAP_TPU_LOOKUP", "probe")
    with pytest.raises(ValueError, match="slices"):
        tsh.ShardedPairedAligner(di, tsh.make_mesh(1, 4, device="cpu"))
    assert not tsh.ShardedPairedAligner(di, mesh)._use_cuckoo


def _quiet(fn, argv):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(argv)


GTF = """\
chr1\tt\texon\t101\t400\t.\t+\t.\tgene_id "g1"; transcript_id "t1";
chr1\tt\texon\t601\t900\t.\t+\t.\tgene_id "g1"; transcript_id "t1";
chr1\tt\texon\t1201\t1500\t.\t-\t.\tgene_id "g2"; transcript_id "t2";
chr2\tt\texon\t51\t700\t.\t+\t.\tgene_id "g3"; transcript_id "t3";
chr2\tt\texon\t1001\t1300\t.\t+\t.\tgene_id "g3"; transcript_id "t3";
"""


@pytest.fixture(scope="module")
def ref_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("build_cli")
    rng = np.random.default_rng(11)
    fa = d / "ref.fa"
    with open(fa, "wb") as f:
        for name, n in (("chr1", 6_000), ("chr2", 3_000)):
            c = hg_like_genome(n, seed=n)
            seq = bytearray(decode_bases(c))
            for s in rng.integers(0, n - 30, 3):
                seq[s:s + 20] = b"N" * 20
            f.write(b">" + name.encode() + b"\n" + bytes(seq) + b"\n")
    gtf = d / "anno.gtf"
    gtf.write_text(GTF)
    return d, str(fa), str(gtf)


def same_dirs(a, b):
    names = sorted(os.listdir(b))
    assert sorted(os.listdir(a)) == names
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, \
                open(os.path.join(b, n), "rb") as fb:
            assert fa.read() == fb.read(), n
    return names


@pytest.mark.parametrize("flags", [[], ["-chunked"], ["-s", "16"],
                                   ["-s", "25", "-lf", "0.9"]])
def test_cli_index_cpu_byte_identical_to_jax_cli(ref_files, flags):
    d, fa, _ = ref_files
    a, b = str(d / f"port{len(flags)}"), str(d / f"jax{len(flags)}")
    assert _quiet(port_cli, ["index", fa, a, *flags, "--device", "cpu"]) == 0
    assert _quiet(jax_cli, ["index", fa, b, *flags]) == 0
    assert "ht_keys.npy" in same_dirs(a, b)


def test_cli_index_past_the_slice_limit_builds_in_slices(ref_files,
                                                         monkeypatch):
    """With MAX_SLICE_SLOTS below the table's slots (as a human genome's
    4.0e9 slots are past 2^31), `index` builds in several slices and
    assembles the JAX CLI's files from them."""
    d, fa, _ = ref_files
    slices = []
    assembled = hix.DeviceIndex.genome_index

    def spy(self):
        slices.append(len(self.parts["ht_entries"]))
        return assembled(self)
    monkeypatch.setattr(hix, "MAX_SLICE_SLOTS", 4_000)
    monkeypatch.setattr(hix.DeviceIndex, "genome_index", spy)
    a, b = str(d / "port_sliced"), str(d / "jax_sliced")
    assert _quiet(port_cli, ["index", fa, a, "--device", "cpu"]) == 0
    assert _quiet(jax_cli, ["index", fa, b]) == 0
    assert "ht_keys.npy" in same_dirs(a, b)
    assert slices[0] >= 3


def test_cli_transcriptome_cpu_byte_identical_to_jax_cli(ref_files):
    d, fa, gtf = ref_files
    a, b = str(d / "tport"), str(d / "tjax")
    assert _quiet(port_cli, ["transcriptome", gtf, fa, a,
                             "--device", "cpu"]) == 0
    assert _quiet(jax_cli, ["transcriptome", gtf, fa, b]) == 0
    assert "gtf.json" in same_dirs(a, b)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("cmd", ["index", "transcriptome"])
def test_cli_build_defaults_to_cuda_and_raises_without_card(ref_files, cmd):
    d, fa, gtf = ref_files
    out = str(d / f"nocard_{cmd}")
    argv = ([cmd, fa, out] if cmd == "index" else [cmd, gtf, fa, out])
    with pytest.raises(RuntimeError, match="cuda"):
        _quiet(port_cli, argv)
    assert not os.path.exists(out)


# ---------------------------------------------------------------- hg_scale

HG_BASES = 2_400_000        # 24 pieces of 100 kb
HG_PAIRS = 1_024           # 4 batches: about 45 s of CPU mesh alone
JAX_KEYS_DIFFER = ("index", "mesh", "wall_s", "align_pairs_per_s")


@pytest.fixture(scope="module")
def hg_small():
    genome = hg_scale.synth_genome(HG_BASES, workers=1, log=None)
    di, stats = hg_scale.build(genome, "cpu", log=None)
    return genome, di, stats


def test_hg_scale_build_and_check(hg_small):
    genome, di, stats = hg_small
    assert genome.num_bases == 24 * (100_000 + 500) + 500
    jg = JGenome(codes=genome.codes, piece_names=genome.piece_names,
                 piece_offsets=genome.piece_offsets, padding=500)
    want = jbuild_chunked(jg, 20, chunk=500_000)
    occupied = int((want.ht_val1 != 0xFFFFFFFE).sum())
    assert (stats["total_slots"], stats["occupied_slots"],
            stats["overflow_entries"], stats["ht_bytes"],
            stats["overflow_bytes"]) == (
        want.ht_keys.shape[0], occupied, want.overflow.shape[0],
        want.ht_keys.nbytes * 3, want.overflow.nbytes)
    parts = jsh.partition_index(want, 8, use_cuckoo=False)
    np.testing.assert_array_equal(
        u32.to_numpy(torch.stack(di.parts["ht_entries"])),
        parts["ht_entries"])
    tables = hg_scale.host_tables(di, log=None)
    assert tables.pop("slices") == 8
    assert {k: stats[k] for k in tables if k != "host_s"} == {
        k: v for k, v in tables.items() if k != "host_s"}
    res = hg_scale.check(di, 4_000, log=None)
    assert res["missing"] == 0 and res["overflow_descending"]
    assert res["past_probe_cap"] >= 1     # a chain past 64 probes here
    assert res["n_checked"] + res["invalid_windows"] == 4_000
    assert res["hit_size_max"] > 50


def test_hg_scale_align_equals_jax_mesh(hg_small):
    """The tool's align loop over the port's (1, 8) CPU mesh and over the
    JAX ShardedPairedAligner on 8 virtual CPU devices: the same
    statistics dict (timings and labels aside)."""
    genome, di, _ = hg_small
    got = hg_scale.align(hg_scale.make_aligner(di, "cpu"), genome,
                         HG_PAIRS, log=None)
    jg = JGenome(codes=genome.codes, piece_names=genome.piece_names,
                 piece_offsets=genome.piece_offsets, padding=500)
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(1, 8),
                ("data", "index"))
    saved = os.environ.get("SNAP_TPU_LOOKUP")
    os.environ["SNAP_TPU_LOOKUP"] = "probe"
    try:
        jal = jsh.ShardedPairedAligner(jbuild(jg, 20), mesh,
                                       cand_per_read=hg_scale.CAND_PER_READ)
    finally:
        if saved is None:
            del os.environ["SNAP_TPU_LOOKUP"]
        else:
            os.environ["SNAP_TPU_LOOKUP"] = saved
    want = hg_scale.align(jal, genome, HG_PAIRS, log=None)
    for k in JAX_KEYS_DIFFER:
        got.pop(k), want.pop(k)
    assert got == want
    assert got["n_pairs"] == HG_PAIRS and got["recall0"] > 0.9
    assert got["truncated0"] > 0


def test_single_card_shard_starts_narrow_to_int32_in_both_packages():
    """GenomeIndex.device_arrays (both packages) hands the single-card
    engine shard_start and shard_size as int32: a table past 2^31 slots
    wraps there, the same way in each (ROADMAP section 3); the mesh's
    slices (slice_layout) stay inside int32."""
    z = np.zeros(4, np.uint32)
    starts = np.asarray([0, 3, (1 << 31) + 5, (1 << 31) + 9], np.int64)
    arrays = []
    for G, I in ((Genome, GenomeIndex), (JGenome, JGenomeIndex)):
        g = G(codes=np.zeros(8, np.uint8), piece_names=["c"],
              piece_offsets=np.asarray([0], np.int64))
        idx = I(genome=g, seed_len=17, ht_keys=z, ht_val1=z, ht_val2=z,
                shard_starts=starts, overflow=z[:0],
                shard_ovf_starts=np.zeros(4, np.int64))
        arrays.append(idx.device_arrays())
    port, jx = arrays
    for k in ("shard_start", "shard_size"):
        np.testing.assert_array_equal(port[k], jx[k])
        assert port[k].dtype == np.int32
    assert port["shard_start"][2] < 0          # wrapped past 2^31
