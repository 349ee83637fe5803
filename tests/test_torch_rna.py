"""The PyTorch port's RNA path against the JAX package, on the CPU.

* the numpy RNA host modules: transcriptome genome codes and piece table,
  the `transcriptome` command's directory (index files and the GTFReader
  cache) byte for byte, splice-junction CIGAR rewriting on the exon-boundary
  probes, and TranscriptomeCoordMap.convert;
* the batched seed characterizer (rna/filter.py BatchCharacterizer) on the
  CPU against the JAX one and the host walk, a row past the slot budget
  included;
* the port's `index` + `transcriptome` + RNA `single` CLI, in a subprocess
  where `jax` and `snap_rnaseq_tpu` cannot be imported, reproduces
  tests/golden/rna_single_100bp.sam (without @PG);
* RNA `paired` (-tmh 8, -ct contamination index) writes the same SAM and the
  same counts, interval and contamination files as the JAX package's;
* K5's function: lv_distance(impl="onehot") against the JAX
  lv_distance_pallas_lanes(impl="onehot") in interpret mode, and the
  SNAP_TPU_LV_LANES switch on a CPU tensor.

Integers must be bit-identical, log-probabilities within rtol/atol 1e-5 (the
f32 summation-order bar of tests/test_lv_pallas.py)."""
import contextlib
import glob
import io
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_golden_paired_rna as golden_rna
import test_rna
from snap_rnaseq_tpu.cli import main as jax_cli
from snap_rnaseq_tpu.index.genome import genome_from_codes as jgenome
from snap_rnaseq_tpu.index.genome import read_fasta_genome as jread_fasta
from snap_rnaseq_tpu.index.hash_index import build_index as jbuild_index
from snap_rnaseq_tpu.models.single import SingleAligner as JSingleAligner
from snap_rnaseq_tpu.ops.lv_pallas import lv_distance_pallas_lanes
from snap_rnaseq_tpu.rna import filter as jfilter
from snap_rnaseq_tpu.rna.gtf import GTFReader as JGTFReader
from snap_rnaseq_tpu.rna.splice import insert_splice_junctions as jsplice
from snap_rnaseq_tpu.rna.t2g import TranscriptomeCoordMap as JCoordMap
from snap_rnaseq_tpu.rna.transcriptome import \
    build_transcriptome_genome as jbuild_tg
from snap_rnaseq_tpu_torch.cli import main as port_cli
from snap_rnaseq_tpu_torch.index.genome import read_fasta_genome
from snap_rnaseq_tpu_torch.index.hash_index import build_index
from snap_rnaseq_tpu_torch.models.single import SingleAligner
from snap_rnaseq_tpu_torch.ops import kernels, lv
from snap_rnaseq_tpu_torch.rna import filter as tfilter
from snap_rnaseq_tpu_torch.rna.gtf import GTFReader
from snap_rnaseq_tpu_torch.rna.splice import insert_splice_junctions
from snap_rnaseq_tpu_torch.rna.t2g import TranscriptomeCoordMap
from snap_rnaseq_tpu_torch.rna.transcriptome import build_transcriptome_genome
from snap_rnaseq_tpu_torch.utils.seed_sequencer import seed_position_schedule
from snap_rnaseq_tpu_torch.utils.tables import (decode_bases,
                                                reverse_complement_codes)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = 100


def _quiet(cli, argv):
    with contextlib.redirect_stdout(io.StringIO()):
        return cli(argv)


def _sam_body(path):
    lines = [l for l in open(path).read().splitlines()
             if not l.startswith("@PG")]
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------- host modules

@pytest.fixture(scope="module")
def small_rna(tmp_path_factory):
    """tests/test_rna.py's two-chromosome genome and GTF_TEXT annotation."""
    d = tmp_path_factory.mktemp("small_rna")
    rng = np.random.default_rng(123)
    chr1 = decode_bases(rng.integers(0, 4, 6000, dtype=np.uint8))
    chr2 = decode_bases(rng.integers(0, 4, 3000, dtype=np.uint8))
    (d / "ref.fa").write_bytes(b">chr1\n" + chr1 + b"\n>chr2\n" + chr2 + b"\n")
    (d / "anno.gtf").write_text(test_rna.GTF_TEXT)
    return d


def test_transcriptome_genome_matches_jax(small_rna):
    fa, gtf = str(small_rna / "ref.fa"), str(small_rna / "anno.gtf")
    got = build_transcriptome_genome(GTFReader.load(gtf),
                                     read_fasta_genome(fa))
    want = jbuild_tg(JGTFReader.load(gtf), jread_fasta(fa))
    np.testing.assert_array_equal(got.codes, want.codes)
    assert list(got.piece_names) == list(want.piece_names)
    np.testing.assert_array_equal(got.piece_offsets, want.piece_offsets)
    assert got.padding == want.padding


def test_transcriptome_dirs_byte_identical(small_rna):
    """The `transcriptome` command of each package: every file of the two
    directories (index and GTFReader.save_cache) is the same."""
    fa, gtf = str(small_rna / "ref.fa"), str(small_rna / "anno.gtf")
    a, b = str(small_rna / "tidx_port"), str(small_rna / "tidx_jax")
    assert _quiet(port_cli, ["transcriptome", gtf, fa, a,
                             "--device", "cpu"]) == 0
    assert _quiet(jax_cli, ["transcriptome", gtf, fa, b]) == 0
    names = sorted(os.listdir(b))
    assert sorted(os.listdir(a)) == names and "gtf.json" in names
    for n in names:
        with open(os.path.join(a, n), "rb") as fa_, \
                open(os.path.join(b, n), "rb") as fb_:
            assert fa_.read() == fb_.read(), n


SPLICE_PROBES = [
    (51, [(100, "=")]), (1, [(99, "=")]), (1, [(100, "=")]),
    (51, [(200, "M")]), (96, [(5, "S"), (5, "="), (2, "I"), (8, "=")]),
    (101, [(100, "=")]), (150, [(3, "="), (4, "D"), (60, "X"), (2, "I")]),
    (200, [(101, "=")])]


def test_splice_tokens_match_jax(small_rna):
    gtf = str(small_rna / "anno.gtf")
    t_port = GTFReader.load(gtf).get_transcript("T1")
    t_jax = JGTFReader.load(gtf).get_transcript("T1")
    for tpos, toks in SPLICE_PROBES:
        assert insert_splice_junctions(t_port, tpos, list(toks)) == \
            jsplice(t_jax, tpos, list(toks)), (tpos, toks)


def test_coord_map_convert_matches_jax(small_rna):
    fa, gtf = str(small_rna / "ref.fa"), str(small_rna / "anno.gtf")
    g_port, g_jax = GTFReader.load(gtf), JGTFReader.load(gtf)
    port = TranscriptomeCoordMap(
        g_port, build_transcriptome_genome(g_port, read_fasta_genome(fa)))
    want_map = JCoordMap(g_jax, jbuild_tg(g_jax, jread_fasta(fa)))
    rng = np.random.default_rng(5)
    n = port.g_of_t.shape[0]
    tloc = np.concatenate([rng.integers(-5, n + 5, 401),
                           [0, n - 1, 4294967295]]).reshape(-1, 2)
    rlen = rng.integers(1, 160, (tloc.shape[0], 1))
    got, want = port.convert(tloc, rlen), want_map.convert(tloc, rlen)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert want["valid"].any()


def test_piece_index_at_transcriptome_scale_matches_jax():
    """piece_index_of with a transcriptome's thousands of pieces (the
    port binary-searches; the JAX engine compares against every piece)."""
    from snap_rnaseq_tpu.models.single import piece_index_of as jpiece
    from snap_rnaseq_tpu_torch.models.single import piece_index_of
    rng = np.random.default_rng(11)
    starts = np.cumsum(rng.integers(500, 3000, 5000)).astype(np.int32)
    locs = np.concatenate([rng.integers(0, starts[-1] + 5000, 20000),
                           starts, starts - 1, [0, 2 ** 31 - 1]])
    locs = locs.astype(np.int32)
    got = piece_index_of(torch.from_numpy(starts), torch.from_numpy(locs))
    want = jpiece(jnp.asarray(starts), jnp.asarray(locs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------- characterizer

def test_batch_characterizer_matches_jax_and_host():
    """tests/test_rna.py's construction plus a 200-base block copied 50
    times: a read inside it has more than `slots` hits and takes the host
    walk in both packages."""
    rng = np.random.default_rng(21)
    codes = rng.integers(0, 4, 130000, dtype=np.uint8)
    codes[40000:40200] = codes[1000:1200]
    block = codes[2000:2200].copy()
    for j in range(50):
        codes[10000 + 200 * j:10200 + 200 * j] = block
    g = jgenome(codes)
    jidx = jbuild_index(g, seed_len=20)
    B, P = 24, L
    reads = np.zeros((B, P), np.uint8)
    pad = int(g.piece_offsets[0])
    for i in range(B):
        s = pad + int(rng.integers(0, 130000 - P))
        r = np.asarray(g.codes[s:s + P]).copy()
        for _ in range(int(rng.integers(0, 3))):
            p = int(rng.integers(0, P))
            r[p] = (r[p] + int(rng.integers(1, 4))) % 4
        if i % 3 == 0:
            r = reverse_complement_codes(r)
        reads[i] = r
    reads[5] = 4                                   # all-N: no valid seeds
    reads[7] = block[50:150]                       # > slots hits
    jal = JSingleAligner(jidx)
    want = jfilter.BatchCharacterizer(jidx, jal._dev, jal.genome_size,
                                      cuckoo=jal._cuckoo)
    idx = build_index(g, seed_len=20)
    got = tfilter.BatchCharacterizer(
        idx, SingleAligner(idx, device="cpu").state)
    wrows, grows = want.characterize(reads), got.characterize(reads)
    positions = tuple(int(p) for p in
                      seed_position_schedule(P, 20)[0][:got.max_seeds])
    total = tfilter.characterize_batch(
        torch.from_numpy(reads), got.state, positions=positions, seed_len=20,
        max_hits=got.max_hits, read_len=P, cpr=got.slots)["total"]
    assert int(total[7]) > got.slots
    for i in range(B):
        g_f, g_r = grows(i)
        w_f, w_r = wrows(i)
        h_f, h_r = tfilter.characterize_seeds(idx, reads[i])
        # the same maps, built in the same insertion order
        assert list(g_f.items()) == list(w_f.items()), i
        assert list(g_r.items()) == list(w_r.items()), i
        assert (g_f, g_r) == (h_f, h_r), i


# ---------------------------------------------------------------- golden SAM

@pytest.fixture(scope="module")
def rna_ref(tmp_path_factory):
    """tests/test_golden_paired_rna.py's genome and annotation, indexed by
    the port (genome) and the JAX package (transcriptome)."""
    tmp = str(tmp_path_factory.mktemp("rna_ref"))
    fa, gtf, g = golden_rna._build_ref(tmp)
    gidx, tidx = os.path.join(tmp, "gidx"), os.path.join(tmp, "tidx")
    assert _quiet(port_cli, ["index", fa, gidx, "--device", "cpu"]) == 0
    assert _quiet(jax_cli, ["transcriptome", gtf, fa, tidx]) == 0
    return dict(tmp=tmp, fa=fa, gtf=gtf, genome=g, gidx=gidx, tidx=tidx)


_BLOCKED_RUN = r"""
import sys
sys.modules["jax"] = None
sys.modules["snap_rnaseq_tpu"] = None
import torch
torch.set_num_threads(1)   # beside the other test processes' threads
from snap_rnaseq_tpu_torch.cli import main
fa, gtf, reads, gidx, tidx, out = sys.argv[1:7]
assert main(["index", fa, gidx, "--device", "cpu"]) == 0
assert main(["transcriptome", gtf, fa, tidx, "--device", "cpu"]) == 0
assert main(["single", gidx, tidx, gtf, reads, "-o", out, "--device",
             "cpu"]) == 0
assert not [m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "snap_rnaseq_tpu")
            and sys.modules[m] is not None]
"""


def test_rna_single_golden_without_jax(rna_ref):
    tmp = rna_ref["tmp"]
    reads = golden_rna._rna_dataset(tmp, rna_ref["genome"], rna_ref["gtf"])
    out = os.path.join(tmp, "rna_blocked.sam")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN, rna_ref["fa"], rna_ref["gtf"],
         reads, os.path.join(tmp, "gidx_b"), os.path.join(tmp, "tidx_b"),
         out], env=env, cwd=tmp, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    got = _sam_body(out)
    assert got == open(golden_rna.GOLDEN_RNA).read()
    assert any("N" in l.split("\t")[5] for l in got.splitlines()
               if l and not l.startswith("@"))


# ---------------------------------------------------------------- RNA paired

def _write_pairs(path0, path1, pairs):
    with open(path0, "wb") as f0, open(path1, "wb") as f1:
        for name, a, b in pairs:
            f0.write(b"@%s/1\n" % name + decode_bases(a) + b"\n+\n"
                     + b"I" * len(a) + b"\n")
            f1.write(b"@%s/2\n" % name + decode_bases(b) + b"\n+\n"
                     + b"I" * len(b) + b"\n")


def _mutate(rng, r, n_max):
    r = r.copy()
    for _ in range(int(rng.integers(0, n_max + 1))):
        p = int(rng.integers(0, len(r)))
        r[p] = (r[p] + int(rng.integers(1, 4))) % 4
    return r


@pytest.fixture(scope="module")
def rna_paired(rna_ref):
    """One RNA `paired` run of each package on the same inputs: FR pairs
    cut from the three spliced transcripts and from the genome, chimeric
    pairs (ends on two chromosomes, or far apart on one), pairs with a
    fused end (half chr1, half chr2: unaligned, seed evidence) and pairs
    from a contamination genome that only the -ct index holds."""
    tmp = rna_ref["tmp"]
    g = rna_ref["genome"]
    codes = np.asarray(g.codes)
    rng = np.random.default_rng(31337)
    tg = build_transcriptome_genome(GTFReader.load(rna_ref["gtf"]),
                                    read_fasta_genome(rna_ref["fa"]))
    ends = np.append(tg.piece_offsets[1:], tg.codes.shape[0]) - tg.padding
    pairs = []

    def fr(seq, tag, n, sub=2):
        for i in range(n):
            ins = int(rng.integers(200, min(400, len(seq)) + 1))
            s = int(rng.integers(0, len(seq) - ins + 1))
            frag = seq[s:s + ins]
            pairs.append((b"%s%d" % (tag, i), _mutate(rng, frag[:L], sub),
                          _mutate(rng, reverse_complement_codes(
                              frag[ins - L:]), sub)))

    for j, name in enumerate(tg.piece_names):
        o = int(tg.piece_offsets[j])
        fr(np.asarray(tg.codes[o:int(ends[j])]), name.encode(), 10)
    for piece, plen in ((0, 60000), (1, 30000)):
        b0 = int(g.piece_offsets[piece])
        fr(codes[b0:b0 + plen], b"g%d_" % piece, 5)
    c1, c2 = int(g.piece_offsets[0]), int(g.piece_offsets[1])
    rc = reverse_complement_codes
    for i in range(4):
        # genomic ends on two chromosomes / 30 kb apart on one
        s, t = int(rng.integers(0, 59000)), int(rng.integers(0, 29000))
        pairs.append((b"inter%d" % i, codes[c1 + s:c1 + s + L].copy(),
                      rc(codes[c2 + t:c2 + t + L])))
        s = int(rng.integers(0, 20000))
        pairs.append((b"intra%d" % i, codes[c1 + s:c1 + s + L].copy(),
                      rc(codes[c1 + s + 30000:c1 + s + 30000 + L])))
    for tag, (c, at) in ((b"xchr", (c2, 20000)), (b"xpos", (c1, 30000))):
        # fusion evidence: pairs with one end in exon 3 of gA (chr1
        # 7001-7800) and the other at the partner, and pairs whose second
        # end spans the fusion junction (unaligned: seed evidence), six of
        # each, past the evidence threshold of analyze_read_intervals
        for i in range(6):
            pairs.append((b"%sp%d" % (tag, i),
                          codes[c1 + 7200 + 10 * i:c1 + 7300 + 10 * i].copy(),
                          rc(codes[c + at + 100 + 10 * i:
                                   c + at + 200 + 10 * i])))
            fused = np.concatenate(
                [codes[c1 + 7350 + 5 * i:c1 + 7400 + 5 * i],
                 codes[c + at + 50 + 5 * i:c + at + 100 + 5 * i]])
            pairs.append((b"%ss%d" % (tag, i),
                          codes[c1 + 7100 + 7 * i:c1 + 7200 + 7 * i].copy(),
                          rc(fused)))
    contam = rng.integers(0, 4, 20000, dtype=np.uint8)
    cfa = os.path.join(tmp, "contam.fa")
    with open(cfa, "wb") as f:
        f.write(b">rRNA\n" + decode_bases(contam) + b"\n")
    cidx = os.path.join(tmp, "cidx")
    assert _quiet(port_cli, ["index", cfa, cidx, "--device", "cpu"]) == 0
    fr(contam, b"ct", 6, sub=1)
    r1, r2 = os.path.join(tmp, "p_r1.fq"), os.path.join(tmp, "p_r2.fq")
    _write_pairs(r1, r2, pairs)

    outs = {}
    for name, cli, extra in (("port", port_cli, ["--device", "cpu"]),
                             ("jax", jax_cli, [])):
        d = os.path.join(tmp, name)
        os.makedirs(d)
        argv = ["paired", rna_ref["gidx"], rna_ref["tidx"], rna_ref["gtf"],
                r1, r2, "-o", os.path.join(d, "rna_p.sam"), "-tmh", "8",
                "-ct", cidx] + extra
        assert _quiet(cli, argv) == 0
        outs[name] = d
    return outs


def test_rna_paired_sam_matches_jax(rna_paired):
    got = _sam_body(os.path.join(rna_paired["port"], "rna_p.sam"))
    want = _sam_body(os.path.join(rna_paired["jax"], "rna_p.sam"))
    assert got == want
    cigars = [l.split("\t")[5] for l in want.splitlines()
              if not l.startswith("@")]
    assert any("N" in c for c in cigars)          # spliced records
    assert any(c == "*" for c in cigars)          # unaligned ends


def test_rna_paired_run_files_match_jax(rna_paired):
    """Every counts, interval and contamination file of the run."""
    names = sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(rna_paired["jax"], "rna_p.*")) if not p.endswith(".sam"))
    assert "rna_p.contamination" in names
    assert "rna_p.transcript_id.counts.txt" in names
    assert "rna_p.interchromosomal_intervals.gtf" in names
    assert sorted(os.path.basename(p) for p in glob.glob(os.path.join(
        rna_paired["port"], "rna_p.*")) if not p.endswith(".sam")) == names
    for n in names:
        with open(os.path.join(rna_paired["port"], n), "rb") as a, \
                open(os.path.join(rna_paired["jax"], n), "rb") as b:
            assert a.read() == b.read(), n
    read = lambda n: open(os.path.join(rna_paired["jax"], n)).read()
    assert read("rna_p.contamination").startswith("rRNA\t")
    # fusion evidence past the threshold, on two chromosomes and on one
    assert "NoGene,S,6" in read("rna_p.interchromosomal_intervals.gtf")
    assert "NoGene,S,6" in read("rna_p.intrachromosomal_intervals.gtf")


# ---------------------------------------------------------------- K5

def _lanes_cases(rng, B, P, e_max):
    """Edited text rows in the JAX lanes layout (e_max leading sentinels),
    random k, and a third of the rows with a free prefix (some of it the
    whole read)."""
    TXT = P + 2 * e_max + P
    pat = rng.integers(0, 4, (B, P)).astype(np.uint8)
    pat[rng.random((B, P)) < 0.01] = 4
    txt = np.full((B, TXT), 255, np.uint8)
    plen = rng.integers(P - 10, P + 1, B).astype(np.int32)
    tl = np.zeros(B, np.int32)
    for i in range(B):
        t = list(pat[i, :plen[i]] % 4)
        for _ in range(int(rng.integers(0, e_max + 3))):
            op, p = int(rng.integers(0, 3)), int(rng.integers(0, len(t)))
            if op == 0:
                t[p] = (t[p] + 1) % 4
            elif op == 1:
                del t[p]
            else:
                t.insert(p, int(rng.integers(0, 4)))
        t = t[:P + e_max]
        tl[i] = len(t) if rng.random() < 0.7 else int(rng.integers(P // 2,
                                                                   P + 1))
        txt[i, e_max:e_max + len(t)] = t
    kk = rng.integers(0, e_max + 1, B).astype(np.int32)
    kk[:B // 2] = e_max
    fr = np.where(rng.random(B) < 0.33, rng.integers(0, P, B), 0)
    fr[-2:] = plen[-2:]
    qlp = lv.phred_log_prob_device(torch.from_numpy(
        rng.integers(33, 74, (B, P)).astype(np.uint8))).numpy()
    return pat, plen, txt, tl, kk, qlp, fr.astype(np.int32)


@pytest.mark.parametrize("e_max", [16, 17])
def test_k5_function_matches_jax_onehot(e_max):
    rng = np.random.default_rng(500 + e_max)
    B, P = 48, L
    pat, plen, txt, tl, kk, qlp, fr = _lanes_cases(rng, B, P, e_max)
    want = lv_distance_pallas_lanes(
        *map(jnp.asarray, (pat, plen, txt, tl, kk, qlp, fr)), e_max=e_max,
        interpret=True, impl="onehot")
    got = lv.lv_distance(
        torch.from_numpy(pat), torch.from_numpy(plen),
        torch.from_numpy(txt[:, e_max:]), torch.from_numpy(tl),
        torch.from_numpy(kk), torch.from_numpy(qlp), torch.from_numpy(fr),
        e_max=e_max, impl="onehot")
    for name, g, w in zip(("distance", "e_final", "d_final"),
                          (got.distance, got.e_final, got.d_final), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_allclose(got.log_prob.numpy(), np.asarray(want[3]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.net_indel.numpy(), np.asarray(want[4]))
    dist = np.asarray(want[0])
    assert (dist >= 0).any() and (dist < 0).any()
    assert (np.asarray(want[4]) != 0).any()


def test_lv_lanes_switch_on_cpu_takes_plain(monkeypatch):
    """SNAP_TPU_LV_LANES=onehot on a CPU tensor: the plain version, no
    kernel launch counted."""
    rng = np.random.default_rng(9)
    pat, plen, txt, tl, kk, qlp, fr = _lanes_cases(rng, 32, 40, 7)
    args = [torch.from_numpy(a) for a in (pat, plen, txt[:, 7:], tl, kk, qlp,
                                          fr)]
    monkeypatch.setenv("SNAP_TPU_LV_LANES", "onehot")
    before = dict(kernels.LAUNCHES)
    got = lv.lv_distance(*args, e_max=7)
    want = lv._lv_distance_plain(*args, e_max=7)
    assert kernels.LAUNCHES == before
    for f in ("distance", "e_final", "d_final", "net_indel", "log_prob"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
