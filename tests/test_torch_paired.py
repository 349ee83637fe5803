"""The PyTorch port's paired-end path against the JAX package, on the CPU.

* bitpar in every form: bitpar_distance_words (packed text) for all eight
  (reverse, free_start, track_pos) combinations and bitpar_distance (byte
  code rows);
* seed_phase(select_first_valid=8), _mate_rescue_end and pair_phase on
  the same inputs as the JAX functions;
* PairedAligner.align_batch against the JAX PairedAligner on the
  seedless-mate construction of tests/test_mate_rescue.py and on the golden
  paired reads, every output key compared;
* the port's `index` + `paired` CLI reproduces tests/golden/paired_100bp.sam
  (without @PG) in-process and with `jax` and `snap_rnaseq_tpu` blocked;
* the bulk and per-read paired paths write the same SAM;
* stringz on the CPU, and CUDA requested without a card raises.

Integers must be bit-identical, log-probabilities within rtol/atol 1e-5 (the
f32 summation-order bar of tests/test_lv_pallas.py).  The JAX side runs its
plain path on the CPU (_lv_backend() is "jax")."""
import contextlib
import io
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_golden_paired_rna as golden_paired
from snap_rnaseq_tpu.index.genome import genome_from_codes as jgenome
from snap_rnaseq_tpu.index.hash_index import build_index as jbuild_index
from snap_rnaseq_tpu.index.hash_index import cuckoo_layout_for
from snap_rnaseq_tpu.models import paired as jp
from snap_rnaseq_tpu.models import single as js
from snap_rnaseq_tpu.ops import bitpar as jbp
from snap_rnaseq_tpu.ops.genome_gather import pack_genome_4bit
from snap_rnaseq_tpu.utils.seed_sequencer import seed_position_schedule
from snap_rnaseq_tpu.utils.tables import reverse_complement_codes
from snap_rnaseq_tpu_torch.cli import main as port_cli
from snap_rnaseq_tpu_torch.index.genome import genome_from_codes
from snap_rnaseq_tpu_torch.index.hash_index import GenomeIndex, build_index
from snap_rnaseq_tpu_torch.io.readers import open_paired_read_supplier
from snap_rnaseq_tpu_torch.io.reads import make_batch
from snap_rnaseq_tpu_torch.models import paired as tp
from snap_rnaseq_tpu_torch.models import single as ts
from snap_rnaseq_tpu_torch.models.paired_pipeline import (
    PairedEndPipeline, PairedPipelineOptions)
from snap_rnaseq_tpu_torch.ops import bitpar as tbp
from snap_rnaseq_tpu_torch.ops import u32
from snap_rnaseq_tpu_torch.tools import stringz
from snap_rnaseq_tpu_torch.utils.tables import decode_bases

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = 100


def t(x):
    a = np.array(x)
    if a.dtype == np.uint32:
        return u32.from_numpy(a)
    return torch.from_numpy(a)


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
    keys = list(want) if keys is None else keys
    assert set(keys) <= set(got), set(keys) - set(got)
    for k in keys:
        same(got[k], want[k], k)


def _sam_body(path):
    lines = [l for l in open(path).read().splitlines()
             if not l.startswith("@PG")]
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------- bitpar

FLAGS = [(r, f, tr) for r in (False, True) for f in (False, True)
         for tr in (False, True)]


@pytest.mark.parametrize("P,TXT", [(37, 300), (100, 1084)])
@pytest.mark.parametrize("reverse,free_start,track_pos", FLAGS)
def test_bitpar_words_every_form(P, TXT, reverse, free_start, track_pos):
    rng = np.random.default_rng(P + 8 * reverse + 4 * free_start + track_pos)
    B, off = 48, 3
    n_w = (off + TXT + 7) // 8 + 1
    pats = rng.integers(0, 4, (B, P)).astype(np.uint8)
    pats[rng.random((B, P)) < 0.01] = 4
    codes = rng.integers(0, 4, (B, n_w * 8)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.002] = 5
    for i in range(0, B, 2):           # the pattern planted, with edits
        seg = pats[i] % 4
        for _ in range(rng.integers(0, 5)):
            seg[rng.integers(0, P)] = rng.integers(0, 4)
        if free_start:
            s = off + int(rng.integers(0, TXT - P))
        else:                          # a global start: at scan column 0
            s = off + TXT - P if reverse else off
        codes[i, s:s + P] = seg[::-1] if reverse else seg
    words = pack_genome_4bit(codes.reshape(-1))[:B * n_w].reshape(B, n_w)
    t_len = rng.integers(TXT // 2, TXT + 1, B).astype(np.int32)
    kw = dict(P=P, TXT=TXT, packed_off=off, reverse=reverse,
              free_start=free_start, track_pos=track_pos)
    want = jbp.bitpar_distance_words(jnp.asarray(pats), jnp.asarray(words),
                                     jnp.asarray(t_len), **kw)
    same(tbp.bitpar_distance_words(t(pats), t(words), t(t_len), **kw), want)
    dist = np.asarray(want) >> 12 if track_pos else np.asarray(want)
    assert (dist <= 5).any() and (dist > 5).any()


@pytest.mark.parametrize("track_pos,free_start", [
    (False, False), (True, False), (False, True), (True, True)])
def test_bitpar_rows_matches_jax(track_pos, free_start):
    rng = np.random.default_rng(11 + 2 * track_pos + free_start)
    B, P, TXT = 64, 100, 131
    pats = rng.integers(0, 4, (B, P)).astype(np.uint8)
    text = rng.integers(0, 4, (B, TXT)).astype(np.uint8)
    half = rng.random(B) < 0.5
    text[half, 10:10 + P] = pats[half]
    text[half, rng.integers(10, 10 + P)] ^= 1
    text[rng.random((B, TXT)) < 0.01] = 4
    text[:8, 120:] = 255                       # padding bytes
    t_len = rng.integers(P, TXT + 1, B).astype(np.int32)
    kw = dict(P=P, track_pos=track_pos, free_start=free_start)
    want = jbp.bitpar_distance(jnp.asarray(pats), jnp.asarray(text),
                               jnp.asarray(t_len), **kw)
    same(tbp.bitpar_distance(t(pats), t(text), t(t_len), **kw), want)


# ---------------------------------------------------------------- phases

@pytest.fixture(scope="module")
def small_world():
    """A random 60 kb genome, its index and 24 pairs (N bases included)."""
    rng = np.random.default_rng(21)
    codes = rng.integers(0, 4, 60_000, dtype=np.uint8)
    index = jbuild_index(jgenome(codes), seed_len=20)
    arrs = index.device_arrays()
    cuckoo = cuckoo_layout_for(index)
    p4 = pack_genome_4bit(arrs["genome_codes"])
    pieces = index.genome.piece_offsets.astype(np.int32)
    state = ts.index_state_from_numpy(
        dict(arrs, genome_p4=p4, piece_starts=pieces), cuckoo, "cpu")
    pad = int(pieces[0])
    B = 24
    starts = rng.integers(0, 59_000 - 400, B)
    r0 = np.stack([codes[s:s + L] for s in starts])
    r1 = np.stack([reverse_complement_codes(codes[s + 300 - L:s + 300])
                   for s in starts])
    for r in (r0, r1):
        sub = rng.random(r.shape) < 0.02
        r[sub] = (r[sub] + 1) % 4
    r0[::5, rng.integers(0, L, 5)] = 4          # N bases kill some seeds
    q = rng.integers(40, 74, (B, L)).astype(np.uint8)
    return dict(index=index, arrs=arrs, cuckoo=cuckoo, p4=p4, pieces=pieces,
                state=state, codes=codes, pad=pad, starts=starts, r0=r0,
                r1=r1, q=q, B=B)


def test_seed_phase_select_first_valid(small_world):
    w = small_world
    reads = np.concatenate([w["r0"], w["r1"]])
    positions, _ = seed_position_schedule(L, 20)
    positions = tuple(int(p) for p in positions[:32])
    want = js.seed_phase(jnp.asarray(reads), jnp.asarray(positions), 20,
                         None, None, None, jnp.asarray(w["arrs"]["overflow"]),
                         w["index"].genome_size, positions,
                         {k: jnp.asarray(v) for k, v in w["cuckoo"].items()},
                         select_first_valid=8)
    got = ts.seed_phase(t(reads), positions, 20, w["state"]["overflow"],
                        w["index"].genome_size, w["state"],
                        select_first_valid=8)
    same_dict(got, want)
    assert "sel_pos" in got
    assert (np.asarray(want["sel_pos"])[:, 0] > 0).any()   # N-shifted


def _dense(rng, w, end, B, K, mate_side):
    """A (B, K) dense candidate set per end, JAX layout: the true location
    for some reads (others lose it, so the rescue has work), decoys, dead
    slots."""
    pad, starts = w["pad"], w["starts"]
    true = (starts + pad) if end == 0 else (starts + 300 - L + pad)
    d = dict(loc=rng.integers(pad, pad + 59_000, (B, K)).astype(np.int32),
             dir=rng.integers(0, 2, (B, K)).astype(np.int32),
             score=rng.integers(0, 12, (B, K)).astype(np.int32),
             logp=rng.uniform(-40, -1, (B, K)).astype(np.float32),
             live=rng.random((B, K)) < 0.3)
    keep_true = rng.random(B) < mate_side
    d["loc"][keep_true, 0] = true[keep_true]
    d["dir"][keep_true, 0] = end
    d["score"][keep_true, 0] = rng.integers(0, 4, int(keep_true.sum()))
    d["logp"][keep_true, 0] = rng.uniform(-12, -2, int(keep_true.sum()))
    d["live"][keep_true, 0] = True
    d["score"] = np.where(d["live"], d["score"], js.BIG).astype(np.int32)
    d["logp"] = np.where(d["live"], d["logp"], -1e30).astype(np.float32)
    d["loc"] = np.where(d["live"], d["loc"], 0).astype(np.int32)
    d["in_prob"] = d["live"] & (rng.random((B, K)) < 0.9)
    return d


@pytest.mark.parametrize("truncation_mass", [False, True])
def test_mate_rescue_and_pair_phase(small_world, truncation_mass):
    w = small_world
    rng = np.random.default_rng(5)
    B, K = w["B"], 12
    d0 = _dense(rng, w, 0, B, K, 0.5)
    d1 = _dense(rng, w, 1, B, K, 0.6)
    kw = dict(seed_len=20, truncation_mass=truncation_mass)
    jcfg, tcfg = jp.PairedAlignerConfig(**kw), tp.PairedAlignerConfig(**kw)
    ecfg_j, ecfg_t = jcfg.end_config(), tcfg.end_config()
    gs = w["index"].genome_size
    J = {e: {k: jnp.asarray(v) for k, v in d.items()}
         for e, d in ((0, d0), (1, d1))}
    T = {e: {k: t(v) for k, v in d.items()} for e, d in ((0, d0), (1, d1))}
    for e in (0, 1):
        J[e]["overflow"] = jnp.int32(0)
        T[e]["overflow"] = torch.zeros((), dtype=torch.int32)
    J_app, T_app, n_resc = {}, {}, 0
    for e, reads in ((0, w["r0"]), (1, w["r1"])):
        want = jp._mate_rescue_end(
            J[e], J[1 - e], jnp.asarray(reads), jnp.asarray(w["q"]),
            jnp.asarray(w["p4"]), jnp.asarray(w["pieces"]), ecfg_j, jcfg,
            L, gs, B)
        got = tp._mate_rescue_end(
            T[e], T[1 - e], t(reads), t(w["q"]), w["state"]["genome_p4"],
            w["state"]["piece_starts"], ecfg_t, tcfg, L, gs, B)
        same_dict(got, want)
        n_resc += int(want["n_rescued"])
        J_app[e] = jp._append_dense(J[e], want)
        T_app[e] = tp._append_dense(T[e], got)
    assert n_resc > 0
    pop0 = rng.integers(0, 4, B).astype(np.int32)
    pop1 = rng.integers(0, 4, B).astype(np.int32)
    trunc = np.where(rng.random(B) < 0.4, rng.integers(1, 50, B), 0).astype(
        np.int32)
    want = jp.pair_phase(J_app[0], J_app[1], jcfg, jnp.asarray(pop0),
                         jnp.asarray(pop1), trunc_total=jnp.asarray(trunc))
    got = tp.pair_phase(T_app[0], T_app[1], tcfg, t(pop0), t(pop1),
                        trunc_total=t(trunc))
    same_dict(got, want)
    assert np.asarray(want["pair_found"]).sum() > B // 2


# ---------------------------------------------------------------- aligner

def _compare_align(got, want):
    for k, v in want.items():
        v = np.asarray(v)
        if v.dtype == np.float32:
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert set(want) == set(got)


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("golden_paired"))
    fa, _gtf, _g = golden_paired._build_ref(tmp)
    r1, r2 = golden_paired._paired_dataset(tmp, _g)
    idx = os.path.join(tmp, "idx")
    with contextlib.redirect_stdout(io.StringIO()):
        assert port_cli(["index", fa, idx]) == 0
    return dict(tmp=tmp, fa=fa, r1=r1, r2=r2, idx=idx)


SEEDLESS_STARTS = (10_000, 25_000, 40_000, 52_000)     # within chr1
FRAG = 300


@pytest.fixture(scope="module")
def aligned(golden):
    """One batch through both engines (one JAX compile): the golden paired
    reads, then tests/test_mate_rescue.py's seedless-mate construction on
    the golden genome's chr1 (every 20-mer of end 1 carries a
    substitution, so only the mate rescue can place it)."""
    pairs = list(open_paired_read_supplier(golden["r1"], golden["r2"]))
    n = len(pairs)
    b0 = make_batch([p[0] for p in pairs], L, n)
    b1 = make_batch([p[1] for p in pairs], L, n)
    index = GenomeIndex.load(golden["idx"])
    codes = index.genome.codes
    base = int(index.genome.piece_offsets[0])
    rng = np.random.default_rng(3)
    r0 = np.zeros((len(SEEDLESS_STARTS), L), np.uint8)
    r1 = np.zeros_like(r0)
    for i, s in enumerate(SEEDLESS_STARTS):
        r0[i] = codes[base + s:base + s + L]
        end1 = codes[base + s + FRAG - L:base + s + FRAG].copy()
        for p in (5, 22, 39, 56, 73, 90):
            end1[p] = (end1[p] + 1 + rng.integers(0, 3)) % 4
        r1[i] = reverse_complement_codes(end1)
    q = np.full(r0.shape, ord("I"), np.uint8)
    c0, c1 = np.concatenate([b0.codes, r0]), np.concatenate([b1.codes, r1])
    q0, q1 = np.concatenate([b0.quals, q]), np.concatenate([b1.quals, q])
    want = jp.PairedAligner(index).align_batch(c0, q0, c1, q1)
    got = tp.PairedAligner(index, device="cpu").align_batch(c0, q0, c1, q1)
    return dict(got=got, want=want, n_golden=n, base=base)


def test_align_batch_matches_jax_seedless_mate(aligned):
    got, n = aligned["got"], aligned["n_golden"]
    _compare_align(got, aligned["want"])
    assert got["pair_found"][n:].all()
    assert int(got["n_rescued1"]) >= 1
    for i, s in enumerate(SEEDLESS_STARTS):
        assert int(got["loc1"][n + i]) == aligned["base"] + s + FRAG - L
        assert int(got["score1"][n + i]) == 6


def test_align_batch_matches_jax_on_golden_reads(aligned):
    _compare_align(aligned["got"], aligned["want"])
    assert np.asarray(aligned["want"]["pair_found"])[:aligned["n_golden"]].all()


def test_cli_reproduces_golden_paired_sam(golden):
    out = os.path.join(golden["tmp"], "port.sam")
    with contextlib.redirect_stdout(io.StringIO()):
        assert port_cli(["paired", golden["idx"], golden["r1"],
                         golden["r2"], "-o", out, "--device", "cpu"]) == 0
    assert _sam_body(out) == open(golden_paired.GOLDEN_PAIRED).read()


_BLOCKED_RUN = r"""
import sys
sys.modules["jax"] = None
sys.modules["snap_rnaseq_tpu"] = None
from snap_rnaseq_tpu_torch.cli import main
fa, r1, r2, idx, out = sys.argv[1:6]
assert main(["index", fa, idx]) == 0
assert main(["paired", idx, r1, r2, "-o", out, "--device", "cpu"]) == 0
assert not [m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "snap_rnaseq_tpu")
            and sys.modules[m] is not None]
"""


def test_paired_runs_without_jax(golden):
    idx = os.path.join(golden["tmp"], "idx_blocked")
    out = os.path.join(golden["tmp"], "blocked.sam")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _BLOCKED_RUN, golden["fa"],
                        golden["r1"], golden["r2"], idx, out], env=env,
                       cwd=golden["tmp"], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert _sam_body(out) == open(golden_paired.GOLDEN_PAIRED).read()


# ---------------------------------------------------------------- bulk I/O

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """tests/test_bulk_io.py's corpus: clean pairs with substitutions, a
    clipped end either side, an all-N end, a hopeless pair, a quality-gate
    failure, spaced ids and a random pair."""
    d = tmp_path_factory.mktemp("bulk")
    rng = np.random.default_rng(7)
    G, FRAG = 60000, 260
    codes = rng.integers(0, 4, G, dtype=np.uint8)
    idx = build_index(genome_from_codes(codes), seed_len=20)
    q = b"I" * L

    def fr_pair(s, sub0=0, sub1=0):
        fwd = codes[s:s + L].copy()
        rc = reverse_complement_codes(codes[s + FRAG - L:s + FRAG])
        for arr, k in ((fwd, sub0), (rc, sub1)):
            for _ in range(k):
                p = int(rng.integers(0, L))
                arr[p] = (arr[p] + int(rng.integers(1, 4))) % 4
        return decode_bases(fwd), decode_bases(rc)

    pairs = []
    for i in range(24):
        a, b = fr_pair(int(rng.integers(0, G - FRAG)), i % 3, (i + 1) % 3)
        pairs.append((b"p%d/1" % i, a, q, b"p%d/2" % i, b, q))
    a, b = fr_pair(int(rng.integers(0, G - FRAG)))
    pairs.append((b"clip/1", a, b"I" * 90 + b"#" * 10, b"clip/2", b, q))
    a, b = fr_pair(int(rng.integers(0, G - FRAG)))
    pairs.append((b"clipf/1", a, q, b"clipf/2", b, b"#" * 8 + b"I" * 92))
    a, b = fr_pair(int(rng.integers(0, G - FRAG)))
    pairs.append((b"halfn/1", b"N" * L, q, b"halfn/2", b, q))
    pairs.append((b"badn/1", b"N" * L, q, b"badn/2", b"N" * L, q))
    a, b = fr_pair(int(rng.integers(0, G - FRAG)))
    pairs.append((b"lowq/1", a, b"%" * L, b"lowq/2", b, q))
    a, b = fr_pair(int(rng.integers(0, G - FRAG)))
    pairs.append((b"spaced extra", a, q, b"spaced extra", b, q))
    pairs.append((b"rand/1",
                  decode_bases(rng.integers(0, 4, L, dtype=np.uint8)), q,
                  b"rand/2",
                  decode_bases(rng.integers(0, 4, L, dtype=np.uint8)), q))
    with open(d / "r1.fq", "wb") as f0, open(d / "r2.fq", "wb") as f1:
        for id0, s0, q0, id1, s1, q1 in pairs:
            f0.write(b"@" + id0 + b"\n" + s0 + b"\n+\n" + q0 + b"\n")
            f1.write(b"@" + id1 + b"\n" + s1 + b"\n+\n" + q1 + b"\n")
    aligner = tp.PairedAligner(idx, device="cpu", cand_per_read=16,
                               max_seed_slots=16)
    return d, idx, aligner, len(pairs)


def _run_pipe(d, idx, aligner, name, bulk, r=("r1", "r2"), **opt_kw):
    pipe = PairedEndPipeline(
        idx, options=PairedPipelineOptions(batch_size=16, **opt_kw),
        aligner=aligner)
    out = d / name
    os.environ["SNAP_TPU_BULK_IO"] = "1" if bulk else "0"
    try:
        stats = pipe.run(str(d / f"{r[0]}.fq"), str(d / f"{r[1]}.fq"),
                         str(out), command_line="parity-test")
    finally:
        os.environ.pop("SNAP_TPU_BULK_IO", None)
    with open(out, "rb") as f:
        lines = f.read().splitlines(keepends=True)
    return lines, stats


@pytest.mark.parametrize("opt_kw", [{}, {"pass_filter": "a"}])
def test_bulk_matches_per_read_sam(corpus, opt_kw):
    """The same records (the per-read path emits filtered pairs out of
    input order) and the same stats."""
    d, idx, aligner, n = corpus
    tag = "".join(opt_kw.values())
    bulk, st_b = _run_pipe(d, idx, aligner, f"bulk{tag}.sam", True, **opt_kw)
    per, st_l = _run_pipe(d, idx, aligner, f"per{tag}.sam", False, **opt_kw)
    assert [l for l in bulk if l.startswith(b"@")] == \
        [l for l in per if l.startswith(b"@")]
    assert sorted(bulk) == sorted(per)
    assert st_b.total_reads == st_l.total_reads == 2 * n
    for k in ("useful_reads", "single_hits", "multi_hits", "not_found",
              "aligned_as_pairs"):
        assert getattr(st_b, k) == getattr(st_l, k), k
    assert (st_b.mapq_histogram == st_l.mapq_histogram).all()
    assert (st_b.distance_histogram.counts
            == st_l.distance_histogram.counts).all()
    assert (st_b.score_histogram.counts == st_l.score_histogram.counts).all()


def test_bulk_byte_exact_clean_corpus(corpus):
    """Without the pairs filtered before alignment the two paths are
    byte-identical, clipping, RC, mismatch CIGARs and TLEN included."""
    d, idx, aligner, n = corpus
    for r in ("r1", "r2"):
        lines = (d / f"{r}.fq").read_bytes().split(b"\n")
        keep = []
        for i in range(0, len(lines) - 1, 4):
            if not lines[i].startswith((b"@badn", b"@lowq")):
                keep += lines[i:i + 4]
        (d / f"{r}_clean.fq").write_bytes(b"\n".join(keep) + b"\n")
    clean = ("r1_clean", "r2_clean")
    bulk, _ = _run_pipe(d, idx, aligner, "bulk_clean.sam", True, r=clean)
    per, _ = _run_pipe(d, idx, aligner, "per_clean.sam", False, r=clean)
    assert bulk == per
    assert any(b"X" in l.split(b"\t")[5] for l in bulk
               if not l.startswith(b"@"))


# ---------------------------------------------------------------- surface

def test_stringz_on_cpu(capsys):
    assert stringz.main(["-B", "32", "-r", "1", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3
    assert lines[0].startswith("bitpar (whole-read)")
    assert "landau-vishkin k=16" in lines[1] and "k=7" in lines[2]
    assert all("M pairs/s" in l for l in lines)


def test_cuda_without_card_raises(golden, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tp.PairedAligner(GenomeIndex.load(golden["idx"]))   # default CUDA
    with pytest.raises(RuntimeError, match="cuda"):
        port_cli(["paired", golden["idx"], golden["r1"], golden["r2"], "-o",
                  os.path.join(golden["tmp"], "never.sam")])
    with pytest.raises(RuntimeError, match="cuda"):
        stringz.main(["-B", "8"])


def test_not_ported_paired_forms_raise(golden):
    base = ["paired", golden["idx"], golden["r1"], golden["r2"], "-o"]
    for argv in (base + ["x.sam", "--hosts", "2"],
                 base + ["x.bam", "-so", "--hosts", "2"]):
        with pytest.raises(SystemExit, match="not yet ported"):
            port_cli(argv)
