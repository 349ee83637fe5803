"""Output formats and SAM/BAM input of the port against the JAX package,
on the CPU.

On tests/test_golden.py's and tests/test_golden_paired_rna.py's datasets,
each with duplicate reads on both strands and an unaligned read added,
the port's CLI (`single`, DNA `paired`, RNA `single`; `-o .bam`, `-o .bam
-so`, `-o .sam.gz`, `-o .sam -so`, `-o .bam -so -S id`) writes the files
the JAX package's pipelines write when given the CLI's command line for
@PG: BAM after BGZF decompression, the .bai, the decompressed .sam.gz,
the sorted SAM and the RNA count files byte for byte.  The JAX package's
own SAM and BAM outputs fed back as input (`single`; interleaved to
`paired`) give the same outputs in both packages, and both packages'
validators return the same errors."""
import contextlib
import gzip
import io
import os

import numpy as np
import pytest
import torch

import test_golden
import test_golden_paired_rna as golden_rna
from snap_rnaseq_tpu.index.hash_index import GenomeIndex as JGenomeIndex
from snap_rnaseq_tpu.io import validate as jval
from snap_rnaseq_tpu.models import paired_pipeline as jpp
from snap_rnaseq_tpu.models import pipeline as jpl
from snap_rnaseq_tpu.rna import pipeline as jrna
from snap_rnaseq_tpu_torch.cli import main as port_cli
from snap_rnaseq_tpu_torch.io import validate as tval
from snap_rnaseq_tpu_torch.io.readers import bam_records

# batches of 64 hold each dataset in one or two batches (the CPU's plain
# kernels cost by the padded batch)
BATCH = 64
FORMS = {   # name: (output suffix, flags)
    "bam": (".bam", []),
    "bam_so": (".bam", ["-so"]),
    "sam_gz": (".sam.gz", []),
    "sam_so": (".sam", ["-so"]),
    "bam_so_Sid": (".bam", ["-so", "-S", "id"]),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU runs here take one intra-op thread: the suite runs
    its files in parallel processes, whose thread pools would otherwise
    crowd the cores and wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(fn, *a, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a, **kw)


def _fq_records(path):
    lines = open(path, "rb").read().splitlines()
    return [lines[i:i + 4] for i in range(0, len(lines), 4)]


def _with_duplicates(path, out, picks, extra=()):
    """The FASTQ at `path` plus a copy of each picked record under a new
    name (the aligner places copies alike, so the sorted BAM flags them)
    and the `extra` records."""
    recs = _fq_records(path)
    with open(out, "wb") as f:
        for r in recs:
            f.write(b"\n".join(r) + b"\n")
        for i in picks:
            name, _, end = recs[i][0].partition(b"/")
            f.write(b"\n".join([name + b"dup" + _ + end] + recs[i][1:])
                    + b"\n")
        for r in extra:
            f.write(b"\n".join(r) + b"\n")
    return out


def _random_read(name, seed):
    seq = np.frombuffer(b"ACGT", np.uint8)[
        np.random.default_rng(seed).integers(0, 4, 100)].tobytes()
    return [b"@" + name, seq, b"+", b"I" * 100]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The three datasets, the port's indices and the JAX package's
    pipelines' aligners (one engine compile each)."""
    from snap_rnaseq_tpu.models.paired import PairedAligner as JPaired
    from snap_rnaseq_tpu.models.single import SingleAligner as JSingle
    tmp = str(tmp_path_factory.mktemp("formats"))
    fa, fq = test_golden._build_dataset(tmp)
    idx = os.path.join(tmp, "idx")
    assert _quiet(port_cli, ["index", fa, idx, "--device", "cpu"]) == 0
    fq = _with_duplicates(fq, os.path.join(tmp, "dups.fq"), range(6),
                          [_random_read(b"rand", 1)])

    rtmp = os.path.join(tmp, "rna")
    os.makedirs(rtmp)
    rfa, gtf, g = golden_rna._build_ref(rtmp)
    gidx, tidx = os.path.join(rtmp, "gidx"), os.path.join(rtmp, "tidx")
    assert _quiet(port_cli, ["index", rfa, gidx, "--device", "cpu"]) == 0
    assert _quiet(port_cli, ["transcriptome", gtf, rfa, tidx,
                             "--device", "cpu"]) == 0
    r1, r2 = golden_rna._paired_dataset(rtmp, g)
    r1 = _with_duplicates(r1, os.path.join(rtmp, "d1.fq"), range(4),
                          [_random_read(b"randp/1", 2)])
    r2 = _with_duplicates(r2, os.path.join(rtmp, "d2.fq"), range(4),
                          [_random_read(b"randp/2", 3)])
    rfq = golden_rna._rna_dataset(rtmp, g, gtf)
    rfq = _with_duplicates(rfq, os.path.join(rtmp, "rdups.fq"), range(6))

    jidx, jgidx = JGenomeIndex.load(idx), JGenomeIndex.load(gidx)
    jal = dict(single=JSingle(jidx), paired=JPaired(jgidx),
               rna_g=JSingle(jgidx), rna_t=JSingle(JGenomeIndex.load(tidx)))
    return dict(tmp=tmp, idx=idx, fq=fq, gidx=gidx, tidx=tidx, gtf=gtf,
                r1=r1, r2=r2, rfq=rfq, jidx=jidx, jgidx=jgidx, jal=jal)


def _argv(data, kind, inputs, out, flags):
    """The port's CLI arguments for one run (positionals first, so the
    CLI's @PG line is `snap-rna ` + these joined)."""
    head = {"single": ["single", data["idx"]],
            "paired": ["paired", data["gidx"]],
            "rna": ["single", data["gidx"], data["tidx"], data["gtf"]]}[kind]
    return head + list(inputs) + ["-o", out] + flags + [
        "-bs", str(BATCH), "--device", "cpu"]


def _jax_run(data, kind, inputs, out, flags, cmdline):
    """The JAX package's pipeline with the options the CLI builds."""
    so = "-so" in flags
    sup = flags[flags.index("-S") + 1] if "-S" in flags else ""
    jal = data["jal"]
    if kind == "paired":
        opt = jpp.PairedPipelineOptions(batch_size=BATCH, sorted_output=so,
                                        suppress=sup)
        pipe = jpp.PairedEndPipeline(data["jgidx"], options=opt,
                                     aligner=jal["paired"])
        fq0, fq1 = (inputs + [None])[:2]
        return _quiet(pipe.run, fq0, fq1, out, command_line=cmdline)
    opt = jpl.PipelineOptions(batch_size=BATCH, sorted_output=so,
                              suppress=sup)
    if kind == "single":
        pipe = jpl.SingleEndPipeline(data["jidx"], options=opt,
                                     aligner=jal["single"])
    else:
        pipe = jrna.RnaSingleEndPipeline(
            data["gidx"], data["tidx"], data["gtf"], options=opt,
            g_aligner=jal["rna_g"], t_aligner=jal["rna_t"])
    inp = inputs[0] if len(inputs) == 1 else list(inputs)
    return _quiet(pipe.run, inp, out, command_line=cmdline)


def _both(data, kind, name, inputs, suffix, flags):
    """One run of each package into its own directory; returns the two
    directories and output paths."""
    runs = {}
    for pkg in ("jax", "port"):
        d = os.path.join(data["tmp"], f"{kind}_{name}_{pkg}")
        os.makedirs(d)
        runs[pkg] = (d, os.path.join(d, "out" + suffix))
    argv = _argv(data, kind, inputs, runs["port"][1], flags)
    assert _quiet(port_cli, argv) == 0
    _jax_run(data, kind, inputs, runs["jax"][1], flags,
             "snap-rna " + " ".join(argv))
    return runs


def _content(path):
    blob = open(path, "rb").read()
    return gzip.decompress(blob) if path.endswith((".bam", ".gz")) else blob


def _same_files(runs):
    (jd, _), (td, _) = runs["jax"], runs["port"]
    names = sorted(os.listdir(jd))
    assert names == sorted(os.listdir(td))
    for n in names:
        assert _content(os.path.join(td, n)) == \
            _content(os.path.join(jd, n)), n
    return names


def _validate(path):
    """Both packages' validators on one output: the same (empty) list."""
    fn = "validate_bam" if path.endswith(".bam") else "validate_sam"
    if path.endswith(".gz"):
        plain = path[:-3]
        open(plain, "wb").write(_content(path))
        path = plain
    got, want = getattr(tval, fn)(path), getattr(jval, fn)(path)
    assert got == want == []


def _inputs(data, kind):
    return {"single": [data["fq"]], "paired": [data["r1"], data["r2"]],
            "rna": [data["rfq"]]}[kind]


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("kind", ["single", "paired", "rna"])
def test_formats_match_jax(data, kind, form):
    suffix, flags = FORMS[form]
    runs = _both(data, kind, form, _inputs(data, kind), suffix, flags)
    names = _same_files(runs)
    out = runs["port"][1]
    _validate(out)
    assert ("out.bam.bai" in names) == (form == "bam_so")
    if kind == "rna":
        assert any(n.endswith("counts.txt") for n in names)
    if not out.endswith(".bam"):
        return
    recs = list(bam_records(out))
    mapped = [r for r in recs if not r["flag"] & 4]
    assert len(mapped) < len(recs) or kind == "rna"
    dup = {bool(r["flag"] & 0x10) for r in mapped if r["flag"] & 0x400}
    if form == "bam_so":
        # coordinate order, unaligned records last, duplicates flagged on
        # both strands
        keys = [(r["ref_id"] if r["ref_id"] >= 0 else 1 << 30, r["pos"])
                for r in recs]
        assert keys == sorted(keys)
        assert dup == {False, True}
    else:
        assert not dup


INPUT_RUNS = {   # name: (kind, the JAX output fed back, form it came from)
    "single_sam": ("single", "sam_so", ".sam"),
    "paired_sam": ("paired", "sam_so", ".sam"),
    "paired_bam": ("paired", "bam", ".bam"),
}


@pytest.mark.parametrize("name", list(INPUT_RUNS))
def test_sam_bam_input_matches_jax(data, name):
    kind, form, suffix = INPUT_RUNS[name]
    src = os.path.join(data["tmp"], f"{kind}_{form}_jax", "out" + suffix)
    if not os.path.exists(src):
        _both(data, kind, form, _inputs(data, kind), suffix,
              FORMS[form][1])
    runs = _both(data, kind, f"{name}_input", [src], ".sam", [])
    _same_files(runs)
    _validate(runs["port"][1])
    assert _n_records(runs["port"][1]) == _n_records(src)


def _n_records(path):
    if path.endswith(".bam"):
        return len(list(bam_records(path)))
    return sum(1 for l in open(path, "rb") if not l.startswith(b"@"))


# tests/test_validate.py's records: valid ones, then one error each
HDR = b"@HD\tVN:1.4\n@SQ\tSN:chr1\tLN:1000\n"
RECORDS = [
    b"r1\t0\tchr1\t10\t60\t4=\t*\t0\t0\tACGT\tIIII\n",
    b"u\t4\t*\t0\t0\t*\t*\t0\t0\tACGT\tIIII\n",
    b"p\t99\tchr1\t10\t60\t4=\t=\t100\t94\tACGT\tIIII\n"
    b"p\t147\tchr1\t100\t60\t4=\t=\t10\t-94\tACGT\tIIII\n",
    b"r\t0\tchr1\t10\t60\t5=\t*\t0\t0\tACGT\tIIII\n",
    b"r\t0\tchr1\t999\t60\t4=\t*\t0\t0\tACGT\tIIII\n",
    b"r\t0\tchr1\t10\t60\t*\t*\t0\t0\tACGT\tIIII\n",
    b"r\t4\tchr1\t10\t0\t4=\t*\t0\t0\tACGT\tIIII\n",
    b"r\t64\tchr1\t10\t60\t4=\t*\t0\t0\tACGT\tIIII\n",
    b"r\t0\tchrX\t10\t60\t4=\t*\t0\t0\tACGT\tIIII\n",
    b"p\t99\tchr1\t10\t60\t4=\t=\t100\t94\tACGT\tIIII\n",
    b"p\t99\tchr1\t10\t60\t4=\t=\t90\t94\tACGT\tIIII\n"
    b"p\t147\tchr1\t100\t60\t4=\t=\t10\t-94\tACGT\tIIII\n",
    b"p\t99\tchr1\t10\t60\t4=\t=\t100\t94\tACGT\tIIII\n"
    b"p\t147\tchr1\t100\t60\t4=\t=\t10\t-90\tACGT\tIIII\n",
    b"r\t0\tchr1\t10\t60\t4=\t*\t0\t0\tACGT\tIII\n",
]


def test_validators_match_jax():
    for i, body in enumerate(RECORDS):
        lines = (HDR + body).splitlines()
        got = tval.validate_records(lines)
        assert got == jval.validate_records(lines), body
        assert (got == []) == (i < 3), body
