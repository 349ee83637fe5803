"""The port's index-sharded mesh (parallel/sharded.py) against the JAX
package's, on the CPU.

* partition_index array for array against the JAX function, in both
  lookup branches, for 1-4 index shards (and the ValueError past the
  logical table count);
* ShardedSingleAligner on (1, 4) and (2, 2) CPU meshes against the JAX
  ShardedSingleAligner on a mesh of four virtual CPU devices, at
  tests/test_sharded_fast.py's problem (a 60 kb genome with a 40 x 300
  bp repeat, B = 8, cand_per_read 16, max_seed_slots 8), and against the
  port's single-chip engine; ShardedPairedAligner the same way on pairs
  with seedless mates (the mate rescue places them);
* models/paired.py _dense_per_read against the JAX function;
* the RNA pipelines with mesh aligners injected: RNA single on
  tests/test_sharded.py's dataset writes the port's stock SAM (without
  @PG) and count files, and the JAX package's; RNA paired with a mesh
  genome aligner writes the stock run's files;
* the DNA pipelines: `paired` with a mesh aligner writes the stock SAM,
  and `single` with one raises TypeError in both packages (the mesh
  broadcasts n_lookups to one value per read, which the pipeline reads
  as one number);
* the mesh without jax: a run where `jax` and `snap_rnaseq_tpu` cannot
  be imported; make_mesh refuses CUDA without a card.

Integers must be bit-identical, log-probabilities within rtol/atol 1e-5."""
import contextlib
import glob
import io
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from snap_rnaseq_tpu.index.genome import genome_from_codes as jgenome
from snap_rnaseq_tpu.index.hash_index import build_index as jbuild_index
from snap_rnaseq_tpu.models import paired as jpaired
from snap_rnaseq_tpu.models.pipeline import PipelineOptions as JPipeOpt
from snap_rnaseq_tpu.models.pipeline import SingleEndPipeline as JSinglePipe
from snap_rnaseq_tpu.parallel import sharded as jsh
from snap_rnaseq_tpu.rna.pipeline import RnaSingleEndPipeline as JRnaSingle
from snap_rnaseq_tpu_torch.cli import main as port_cli
from snap_rnaseq_tpu_torch.index.genome import (genome_from_codes,
                                                read_fasta_genome)
from snap_rnaseq_tpu_torch.index.hash_index import GenomeIndex, build_index
from snap_rnaseq_tpu_torch.models import paired as tpaired
from snap_rnaseq_tpu_torch.models.paired import PairedAligner
from snap_rnaseq_tpu_torch.models.paired_pipeline import (
    PairedEndPipeline, PairedPipelineOptions)
from snap_rnaseq_tpu_torch.models.pipeline import (PipelineOptions,
                                                   SingleEndPipeline)
from snap_rnaseq_tpu_torch.models.single import SingleAligner
from snap_rnaseq_tpu_torch.parallel import sharded as tsh
from snap_rnaseq_tpu_torch.rna.pipeline import (RnaPairedEndPipeline,
                                                RnaSingleEndPipeline)
from snap_rnaseq_tpu_torch.utils.synth_genome import wgsim_pairs
from snap_rnaseq_tpu_torch.utils.tables import (decode_bases,
                                                reverse_complement_codes)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = [(1, 4), (2, 2)]
KW = dict(cand_per_read=16, max_seed_slots=8)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs its files in parallel
    processes, whose thread pools would otherwise crowd the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_mesh(shape):
    return Mesh(np.asarray(jax.devices()[:4]).reshape(shape),
                ("data", "index"))


def compare(got, want):
    """The port's numpy results against the JAX package's: the same keys,
    integers equal, float32 within 1e-5."""
    assert set(got) == set(want)
    for k, v in want.items():
        v = np.asarray(v)
        if v.dtype == np.float32:
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.fixture(scope="module")
def fast_world():
    """tests/test_sharded_fast.py's problem, indexed by both packages; the
    pairs' end 1 loses every exact 20-mer in a quarter of them."""
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 4, 60_000, dtype=np.uint8)
    unit = rng.integers(0, 4, 300, dtype=np.uint8)
    codes[40_000:40_000 + 40 * 300] = np.tile(unit, 40)
    B, L = 8, 100
    reads = np.empty((B, L), np.uint8)
    for i in range(B):
        if i < 3:       # flood reads from inside the repeat block
            s = 40_000 + int(rng.integers(0, 40 * 300 - L))
        else:
            s = int(rng.integers(0, 39_000))
        r = codes[s:s + L].copy()
        reads[i] = reverse_complement_codes(r) if i % 2 else r
    r0, q0, r1, q1, _, _ = wgsim_pairs(codes, B, L, seed=2)
    r1[::4, 5::17] = (r1[::4, 5::17] + 1) % 4
    return dict(codes=codes, reads=reads,
                quals=np.full((B, L), ord("I"), np.uint8),
                pairs=(r0, q0 + 33, r1, q1 + 33),
                jidx=jbuild_index(jgenome(codes), seed_len=20),
                idx=build_index(genome_from_codes(codes), seed_len=20))


@pytest.mark.parametrize("use_cuckoo", [True, False])
def test_partition_index_matches_jax(fast_world, use_cuckoo, monkeypatch):
    """The slices' layouts are rebuilt to one L2 size (here for n_index 2-4);
    the port rebuilds only the slices below it, and still gives the JAX
    package's arrays."""
    idx, jidx = fast_world["idx"], fast_world["jidx"]
    builds, real = [], tsh.build_cuckoo_layout
    monkeypatch.setattr(tsh, "build_cuckoo_layout", lambda *a, **k: (
        builds.append(k["nb2_min"]), real(*a, **k))[1])
    for n in (1, 2, 3, 4):
        builds.clear()
        want = jsh.partition_index(jidx, n, use_cuckoo)
        got = tsh.partition_index(idx, n, use_cuckoo)
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=f"{k} n={n}")
        if use_cuckoo and n == 4:
            assert n < len(builds) < 2 * n        # some slices rebuilt
    # the rebased overflow pointers are slice-local
    got = tsh.partition_index(idx, 4, use_cuckoo)
    assert got["overflow"].shape[1] < idx.overflow.size
    for part in (jsh, tsh):
        with pytest.raises(ValueError, match="logical tables"):
            part.partition_index(idx if part is tsh else jidx,
                                 idx.n_shards + 1, use_cuckoo)


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_single_matches_jax(fast_world, shape):
    w = fast_world
    want = jsh.ShardedSingleAligner(w["jidx"], jax_mesh(shape), **KW) \
        .align_batch(w["reads"], w["quals"])
    al = tsh.ShardedSingleAligner(w["idx"], tsh.make_mesh(*shape, "cpu"),
                                  **KW)
    assert not hasattr(al, "state")
    got = al.align_batch(w["reads"], w["quals"])
    compare(got, want)
    # n_lookups and score_overflow_vec: one value per read, each data
    # shard's count over its index shards
    assert got["n_lookups"].shape == (8,) and got["n_lookups"][0] > 0
    ref = SingleAligner(w["idx"], device="cpu", **KW).align_batch(
        w["reads"], w["quals"])
    for k in ("result", "loc", "direction", "score", "mapq"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert (got["result"][3:] != 0).all()


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_paired_matches_jax(fast_world, shape, monkeypatch):
    """Both lookups; the seedless ends placed by the mate rescue."""
    w = fast_world
    kw = dict(cand_per_read=16, max_seed_slots=16)
    want = jsh.ShardedPairedAligner(w["jidx"], jax_mesh(shape), **kw) \
        .align_batch(*w["pairs"])
    got = tsh.ShardedPairedAligner(w["idx"], tsh.make_mesh(*shape, "cpu"),
                                   **kw).align_batch(*w["pairs"])
    compare(got, want)
    assert got["pair_found"].all()
    monkeypatch.setenv("SNAP_TPU_LOOKUP", "probe")
    probe = tsh.ShardedPairedAligner(w["idx"], tsh.make_mesh(*shape, "cpu"),
                                     **kw).align_batch(*w["pairs"])
    compare(probe, got)
    ref = PairedAligner(w["idx"], device="cpu", **kw).align_batch(
        *w["pairs"])
    for k in ("pair_found", "pair_mapq", "result0", "loc0", "dir0",
              "score0", "mapq0", "result1", "loc1", "dir1", "score1",
              "mapq1"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_batch_must_divide_the_data_axis(fast_world):
    w = fast_world
    al = tsh.ShardedSingleAligner(w["idx"], tsh.make_mesh(2, 2, "cpu"),
                                  **KW)
    with pytest.raises(ValueError, match="data axis"):
        al.align_batch(w["reads"][:7], w["quals"][:7])


def test_dense_per_read_matches_jax():
    """Read-sorted flat candidates, some reads with more scored rows than
    K and one with none."""
    rng = np.random.default_rng(4)
    B, K, C = 6, 4, 40
    read = np.sort(rng.integers(0, B, C)).astype(np.int32)
    read[read == 2] = 3                               # read 2: no rows
    u = dict(read=read, dir=rng.integers(0, 2, C).astype(np.int32),
             live=rng.random(C) < 0.8)
    sc = dict(scored_ok=rng.random(C) < 0.7,
              score=rng.integers(0, 20, C).astype(np.int32),
              logp=rng.normal(-10, 3, C).astype(np.float32),
              loc_adj=rng.integers(0, 1 << 30, C).astype(np.int32))
    in_prob = rng.random(C) < 0.5
    want = jpaired._dense_per_read(
        {k: jnp.asarray(v) for k, v in u.items()},
        {k: jnp.asarray(v) for k, v in sc.items()}, jnp.asarray(in_prob),
        B, K)
    got = tpaired._dense_per_read(
        {k: torch.from_numpy(v) for k, v in u.items()},
        {k: torch.from_numpy(v) for k, v in sc.items()},
        torch.from_numpy(in_prob), B, K)
    compare({k: v.numpy() for k, v in got.items()}, want)
    assert int(got["overflow"]) > 0 and not got["live"][2].any()


# ---------------------------------------------------------------- pipelines

def _quiet(fn, *a):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a)


def _body(path):
    return [l for l in open(path).read().splitlines()
            if not l.startswith("@PG")]


def _run_files(out):
    """The count, interval and contamination files beside `out`."""
    stem = out.rsplit(".", 1)[0]
    return {os.path.basename(p): open(p, "rb").read()
            for p in sorted(glob.glob(stem + ".*")) if p != out}


@pytest.fixture(scope="module")
def rna_world(tmp_path_factory):
    """tests/test_sharded.py's RNA dataset (one 30 kb chromosome, one
    three-exon transcript; 16 reads across the first junction, 16 genomic
    reads with a substitution), indexed by the port's CLI, plus 24 FR
    pairs cut from the transcript and the chromosome."""
    tmp = tmp_path_factory.mktemp("rna_mesh")
    rng = np.random.default_rng(31)
    chrom = decode_bases(rng.integers(0, 4, 30000, dtype=np.uint8))
    fa = str(tmp / "ref.fa")
    open(fa, "wb").write(b">chr1\n" + chrom + b"\n")
    gtf = str(tmp / "ann.gtf")
    rows = [f'chr1\tsrc\texon\t{s}\t{e}\t.\t+\t.\tgene_id "g1"; '
            f'transcript_id "t1"; exon_number "{i + 1}";'
            for i, (s, e) in enumerate([(2001, 2500), (5001, 5600),
                                        (8001, 8700)])]
    open(gtf, "w").write("\n".join(rows) + "\n")
    gidx, tidx = str(tmp / "gidx"), str(tmp / "tidx")
    assert _quiet(port_cli, ["index", fa, gidx, "--device", "cpu"]) == 0
    assert _quiet(port_cli, ["transcriptome", gtf, fa, tidx,
                             "--device", "cpu"]) == 0
    g = read_fasta_genome(fa)
    codes = np.asarray(g.codes)
    base = int(g.piece_offsets[0])
    tseq = np.concatenate([codes[base + 2000:base + 2500],
                           codes[base + 5000:base + 5600],
                           codes[base + 8000:base + 8700]])
    L = 100
    fq = str(tmp / "reads.fq")
    with open(fq, "wb") as f:
        for i in range(16):
            off = int(rng.integers(420, 520))  # spans the first junction
            r = tseq[off:off + L].copy()
            if i % 2:
                r = reverse_complement_codes(r)
            f.write(b"@s%d\n" % i + decode_bases(r) + b"\n+\n" + b"I" * L
                    + b"\n")
        for i in range(16):
            s = base + int(rng.integers(0, 30000 - L))
            r = codes[s:s + L].copy()
            p = int(rng.integers(0, L))
            r[p] = (r[p] + 1) % 4
            f.write(b"@g%d\n" % i + decode_bases(r) + b"\n+\n" + b"I" * L
                    + b"\n")
    fq1, fq2 = str(tmp / "p1.fq"), str(tmp / "p2.fq")
    with open(fq1, "wb") as f1, open(fq2, "wb") as f2:
        for i in range(24):
            seq = tseq if i < 16 else codes[base:base + 30000]
            ins = int(rng.integers(200, 400))
            s = int(rng.integers(0, len(seq) - ins))
            a, b = seq[s:s + L], reverse_complement_codes(seq[s + ins - L:
                                                              s + ins])
            for f, r in ((f1, a), (f2, b)):
                f.write(b"@q%d\n" % i + decode_bases(r) + b"\n+\n"
                        + b"I" * L + b"\n")
    return dict(tmp=str(tmp), fa=fa, gtf=gtf, gidx=gidx, tidx=tidx, fq=fq,
                fq1=fq1, fq2=fq2)


def test_rna_single_mesh_pipeline_matches_stock_and_jax(rna_world):
    w = rna_world
    kw = dict(cand_per_read=64, max_seed_slots=32)

    def run(name, pipe_cls, opts, **extra):
        out = os.path.join(w["tmp"], name, "rna.sam")
        os.makedirs(os.path.dirname(out))
        pipe_cls(w["gidx"], w["tidx"], w["gtf"], options=opts(batch_size=32),
                 **extra).run(w["fq"], out)
        return _body(out), _run_files(out)

    mesh = tsh.make_mesh(2, 2, "cpu")
    got = run("mesh", RnaSingleEndPipeline, PipelineOptions, device="cpu",
              g_aligner=tsh.ShardedSingleAligner(
                  GenomeIndex.load(w["gidx"]), mesh, **kw),
              t_aligner=tsh.ShardedSingleAligner(
                  GenomeIndex.load(w["tidx"]), mesh, **kw))
    stock = run("stock", RnaSingleEndPipeline, PipelineOptions,
                device="cpu", **kw)
    want = run("jax", JRnaSingle, JPipeOpt, **kw)
    assert got == stock
    assert got == want
    assert "rna.gene_id.counts.txt" in got[1]
    assert any("N" in l.split("\t")[5] for l in got[0]
               if not l.startswith("@"))


def test_rna_paired_mesh_genome_aligner_matches_stock(rna_world):
    """A mesh genome aligner has no `state`: the characterizer gets the
    whole index on the aligner's device."""
    w = rna_world
    opts = PairedPipelineOptions(batch_size=32)

    def run(name, **extra):
        out = os.path.join(w["tmp"], name, "rna_p.sam")
        os.makedirs(os.path.dirname(out))
        pipe = RnaPairedEndPipeline(w["gidx"], w["tidx"], w["gtf"],
                                    options=opts, device="cpu",
                                    transcriptome_multi_hits=8, **extra)
        pipe.run(w["fq1"], w["fq2"], out)
        return pipe, _body(out), _run_files(out)

    mesh_al = tsh.ShardedPairedAligner(
        GenomeIndex.load(w["gidx"]), tsh.make_mesh(2, 2, "cpu"),
        min_spacing=opts.min_spacing, max_spacing=opts.max_spacing)
    pipe, *got = run("mesh_p", g_aligner=mesh_al)
    assert pipe._bchar.state["overflow"].device == mesh_al.device
    _, *want = run("stock_p")
    assert got == want
    assert any("N" in l.split("\t")[5] for l in got[0]
               if not l.startswith("@"))


def test_dna_pipelines_with_mesh(fast_world, tmp_path):
    """`paired` with a mesh aligner writes the stock SAM; `single` with
    one raises TypeError in both packages: the mesh broadcasts n_lookups
    to one value per read (sharded.py's scalar-stat fold) and the
    pipeline's drain reads it as one number (ROADMAP.md section 3)."""
    w = fast_world
    r0, q0, r1, q1 = w["pairs"]
    fq = [str(tmp_path / f"r{e}.fq") for e in (1, 2)]
    for path, r, q in ((fq[0], r0, q0), (fq[1], r1, q1)):
        with open(path, "wb") as f:
            for i in range(len(r)):
                f.write(b"@p%d\n%s\n+\n%s\n" % (i, decode_bases(r[i]),
                                               q[i].tobytes()))
    outs = {}
    for name, al in (("stock", None), ("mesh", tsh.ShardedPairedAligner(
            w["idx"], tsh.make_mesh(2, 2, "cpu"), min_spacing=50,
            max_spacing=1000))):
        outs[name] = str(tmp_path / f"{name}.sam")
        PairedEndPipeline(w["idx"], options=PairedPipelineOptions(
            batch_size=8), aligner=al, device="cpu").run(*fq, outs[name])
    assert _body(outs["mesh"]) == _body(outs["stock"])
    with pytest.raises(TypeError, match="converted to Python scalars"):
        SingleEndPipeline(w["idx"], options=PipelineOptions(batch_size=8),
                          aligner=tsh.ShardedSingleAligner(
                              w["idx"], tsh.make_mesh(2, 2, "cpu"), **KW)
                          ).run(fq[0], str(tmp_path / "single.sam"))
    with pytest.raises(TypeError, match="converted to Python scalars"):
        JSinglePipe(w["jidx"], options=JPipeOpt(batch_size=8),
                    aligner=jsh.ShardedSingleAligner(
                        w["jidx"], jax_mesh((2, 2)), **KW)
                    ).run(fq[0], str(tmp_path / "jsingle.sam"))


def test_make_mesh_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tsh.make_mesh(1, 4)
    mesh = tsh.make_mesh(2, 3, device="cpu")
    assert mesh.shape == {"data": 2, "index": 3}
    assert {d.type for d in mesh.devices.ravel()} == {"cpu"}


_BLOCKED_RUN = r"""
import sys
sys.modules["jax"] = None
sys.modules["snap_rnaseq_tpu"] = None
import numpy as np
import torch
torch.set_num_threads(1)   # beside the other test processes' threads
from snap_rnaseq_tpu_torch.index.genome import genome_from_codes
from snap_rnaseq_tpu_torch.index.hash_index import build_index
from snap_rnaseq_tpu_torch.models.single import SingleAligner
from snap_rnaseq_tpu_torch.parallel import sharded
from snap_rnaseq_tpu_torch.utils.synth_genome import wgsim_pairs
codes = np.random.default_rng(3).integers(0, 4, 40_000, dtype=np.uint8)
idx = build_index(genome_from_codes(codes), seed_len=20)
r0, q0, r1, q1, _, _ = wgsim_pairs(codes, 8, 100, seed=1)
mesh = sharded.make_mesh(2, 2, device="cpu")
got = sharded.ShardedSingleAligner(idx, mesh).align_batch(r0, q0 + 33)
want = SingleAligner(idx, device="cpu").align_batch(r0, q0 + 33)
for k in ("result", "loc", "direction", "score", "mapq"):
    assert (got[k] == want[k]).all(), k
out = sharded.ShardedPairedAligner(idx, mesh).align_batch(r0, q0 + 33,
                                                          r1, q1 + 33)
assert out["pair_found"].all()
assert not [m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "snap_rnaseq_tpu")
            and sys.modules[m] is not None]
"""


def test_mesh_runs_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], env=env,
                       cwd=str(tmp_path), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
