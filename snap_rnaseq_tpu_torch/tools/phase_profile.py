"""The engine's time by phase at the bench's shape: the counterpart of the
JAX repo's tools/phase_profile.py.

One batch of `--batch-pairs` wgsim pairs of 100 bases (seed 0) over the
bench's genome, PairedAligner(index, cand_per_read=--cand-per-read; the
JAX tool's default of 128).  The intermediates are materialised once,
then each phase, the full batch included, is called `--calls` times on
them and timed:
  * the JAX tool's phases, on end 0 (B rows) at the engine's per-end
    config, composed as models/single.py flat_align_batch composes them:
    seed, budget, expand, aggregate, compact, score(filtered) (K4, then
    K1), replay;
  * the phases the paired engine runs (models/paired.py
    _paired_align_batch, both ends in one 2B-row pipeline): pair:seed
    (the first num_seeds valid positions), pair:budget, pair:expand,
    pair:aggregate_rows, pair:rowwise_score (K2, then K1),
    pair:rowwise_replay, pair:dense_topk, pair:mate_rescue0 and
    pair:mate_rescue1 (K2's rescue form, then K1), pair:pair_phase;
  * the full batch (PairedAligner.align_batch_device).
For each phase: wall ms a call (the calls dispatched in a row, one
synchronize at the end), device busy ms and device operations a call
under torch.profiler (at least `calls` calls and 50 ms), and kernel
launches a call.
Eager torch runs every call, so no barrier against hoisting is needed
(the JAX tool chained its iterations through lax.optimization_barrier).
A last line sets the sum of the pair: phases beside the full batch; the
difference is the engine's glue (concatenations, the qualities'
log-probabilities, per-end views, output selection).

Prints one JSON line per phase.  Runs on `--device` (default cuda; raises
without a card); on the CPU every device metric is null.

    python -m snap_rnaseq_tpu_torch.tools.phase_profile [--calls 32]
        [--cand-per-read 128] [--index DIR | --cache DIR]
        [--batch-pairs 1024] [--bases 64e6] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import measure as m

FLAT = ("seed", "budget", "expand", "aggregate", "compact",
        "score(filtered)", "replay")
PAIRED = ("pair:seed", "pair:budget", "pair:expand", "pair:aggregate_rows",
          "pair:rowwise_score", "pair:rowwise_replay", "pair:dense_topk",
          "pair:mate_rescue0", "pair:mate_rescue1", "pair:pair_phase")
FULL = "FULL paired batch"


def _schedule(pa, L, dev):
    from ..utils.seed_sequencer import seed_position_schedule
    positions, wraps = seed_position_schedule(L, pa.index.seed_len)
    S = min(pa.cfg.max_seed_slots, len(positions))
    as_t = lambda a: torch.from_numpy(np.asarray(a[:S], np.int32)).to(dev)
    return (as_t(positions), as_t(wraps),
            tuple(int(x) for x in positions[:S]))


def flat_phases(pa, r0, q0) -> dict:
    """The JAX tool's phases on end 0 at the paired engine's per-end
    config: {phase: fn}, each fn a call of the phase on the materialised
    intermediates (materialised here, in order, by the same calls)."""
    from ..models import single as sg
    ecfg = pa.cfg.end_config()
    st, gsize, seed_len = pa.state, pa.genome_size, pa.index.seed_len
    B, L = r0.shape
    sched, wraps, sched_static = _schedule(pa, L, r0.device)
    fns, v = {}, {}

    def phase(name, fn):
        fns[name] = fn
        v[name] = fn()
    phase("seed", lambda: sg.seed_phase(r0, sched_static, seed_len,
                                        st["overflow"], gsize, st,
                                        schedule_t=sched))
    counts = torch.where(v["seed"]["found"][:, :, None],
                         v["seed"]["counts"], 0)
    phase("budget", lambda: sg.budget_phase(v["seed"]["valid"], counts,
                                            wraps, ecfg))
    phase("expand", lambda: sg.expand_phase(
        v["seed"], v["budget"], sched, st["overflow"], ecfg, seed_len, L,
        ecfg.cand_per_read))
    phase("aggregate", lambda: sg.aggregate_phase(v["expand"]))
    phase("compact", lambda: sg.compact_phase(v["aggregate"], B, ecfg))
    u = v["compact"][0]
    phase("score(filtered)", lambda: sg.filtered_score_phase(
        u, r0, q0, st["genome_p4"], st["piece_starts"], ecfg, seed_len, L,
        gsize, B))
    phase("replay", lambda: sg.replay_phase(
        u, v["score(filtered)"], v["budget"], r0, B, len(sched_static),
        ecfg))
    return fns


def paired_phases(pa, r0, q0, r1, q1) -> dict:
    """The phases of models/paired.py _paired_align_batch (without its
    overflow tier, off by default): {phase: fn} as flat_phases, composed
    as the engine composes them."""
    from ..models import paired as pm
    from ..models import single as sg
    from ..ops.lv import phred_log_prob_device
    if pa.cfg.overflow_tier:
        raise ValueError("phase_profile splits the engine without its "
                         "overflow tier")
    cfg = pa.cfg
    ecfg = cfg.end_config()
    st, gsize, seed_len = pa.state, pa.genome_size, pa.index.seed_len
    p4, pieces = st["genome_p4"], st["piece_starts"]
    B, L = r0.shape
    sched, wraps, sched_static = _schedule(pa, L, r0.device)
    S = min(cfg.num_seeds, sched.shape[0])
    reads = torch.cat([r0, r1], dim=0)
    quals = torch.cat([q0, q1], dim=0)
    qlp = phred_log_prob_device(torch.stack([quals, quals.flip(1)], dim=1))
    big = sg.big_locations(gsize)
    fns, v = {}, {}

    def phase(name, fn):
        fns[name] = fn
        v[name] = fn()
    phase("pair:seed", lambda: sg.seed_phase(
        reads, sched_static, seed_len, st["overflow"], gsize, st,
        select_first_valid=S, schedule_t=sched))
    seeds = v["pair:seed"]

    def budget():
        sel = seeds["sel_pos"]
        tab = lambda x: sg.row_select(x[None, :].expand(2 * B, -1), sel)
        cg = torch.where(seeds["found"][:, :, None], seeds["counts"], 0)
        return tab(sched), sg.budget_phase(seeds["valid"], cg, tab(wraps),
                                           ecfg)
    phase("pair:budget", budget)
    sched_tab, bud = v["pair:budget"]
    phase("pair:expand", lambda: sg.expand_phase(
        seeds, bud, sched_tab, st["overflow"], ecfg, seed_len, L,
        ecfg.cand_per_read, big=big))
    phase("pair:aggregate_rows",
          lambda: sg._aggregate_rows(v["pair:expand"], big=big))
    u2 = v["pair:aggregate_rows"]
    phase("pair:rowwise_score", lambda: sg.rowwise_score_phase(
        u2, reads, quals, p4, pieces, ecfg, seed_len, L, gsize,
        qlp_both=qlp))
    sc2 = v["pair:rowwise_score"]
    phase("pair:rowwise_replay", lambda: sg.rowwise_replay_phase(
        u2, sc2, bud, reads, S, ecfg))
    phase("pair:dense_topk",
          lambda: sg.dense_topk_rowwise(u2, sc2, ecfg.cand_per_read))
    dense = v["pair:dense_topk"]
    zero = torch.zeros((), dtype=torch.int32, device=r0.device)
    pre = []                  # the per-end views the rescues read
    for e in (0, 1):
        d = {k: (x[e * B:(e + 1) * B] if x.dim() >= 1 else x)
             for k, x in dense.items()}
        d["overflow"] = dense["overflow"] if e == 0 else zero
        pre.append(d)
    ends = pre
    if cfg.mate_rescue and cfg.rescue_mates > 0:
        for e, (re, qe) in enumerate(((r0, q0), (r1, q1))):
            phase(f"pair:mate_rescue{e}", lambda e=e, re=re, qe=qe:
                  pm._mate_rescue_end(pre[e], pre[1 - e], re, qe, p4,
                                      pieces, ecfg, cfg, L, gsize, B,
                                      qlp_e=qlp[e * B:(e + 1) * B]))
        ends = [pm._append_dense(pre[e], v[f"pair:mate_rescue{e}"])
                for e in (0, 1)]
    popular = v["pair:rowwise_replay"]["popular"]
    trunc = v["pair:expand"]["truncated"]
    phase("pair:pair_phase", lambda: pm.pair_phase(
        ends[0], ends[1], cfg, popular[:B], popular[B:],
        trunc_total=trunc[:B] + trunc[B:]))
    return fns


def time_phase(fn, calls: int, dev) -> tuple:
    """(line fields, the last call's output): wall ms a call over `calls`
    calls and one synchronize, launches a call, then the profiled calls:
    as many as fill measure.MIN_PROFILE_MS at the measured wall, and at
    least `calls`.  The call that materialised the phase's output was its
    warm-up."""
    m.sync(dev)
    before = m.launches()
    t0 = time.time()
    for _ in range(calls):
        out = fn()
    m.sync(dev)
    wall = (time.time() - t0) * 1e3 / calls
    launched = m.launches_since(before, calls)
    n_prof = m.profiled_units(calls, wall)

    def again():
        for _ in range(n_prof):
            fn()
    prof = m.device_profile(again, n_prof, dev)
    return dict(calls=calls, profiled_calls=n_prof, wall_ms=wall,
                device_busy_ms=prof["device_busy_ms"],
                device_ops=prof["device_ops"], kernel_ms=prof["kernel_ms"],
                launches=launched), out


def run(index, *, device="cuda", bases=m.GENOME_BASES,
        batch_pairs=m.BATCH_PAIRS, cand_per_read=128, calls=32, base=None,
        stage=m.no_stage):
    """Every phase timed; returns (JSON line dicts, {phase: its last call's
    output}).  `base`: an aligner whose device copy of the index is used.
    The flat phases run as stage("flat", fn), the paired engine's as
    stage("paired", fn)."""
    from ..models.paired import PairedAligner
    from ..models.single import resolve_device
    dev = resolve_device(device)
    pa = (m.paired_on_state(base, cand_per_read=cand_per_read)
          if base is not None else
          PairedAligner(index, device=dev, cand_per_read=cand_per_read))
    batch = m.pair_batches(index, bases, batch_pairs, dev, n_batches=1)[0]
    info = m.device_info(dev)
    lines, outs = [], {}

    def group(view, fns):
        for name, fn in fns.items():
            fields, outs[name] = time_phase(fn, calls, dev)
            lines.append(dict(phase=name, view=view,
                              cand_per_read=cand_per_read,
                              batch_pairs=batch_pairs, **fields,
                              device=info))
    stage("flat", lambda: group("flat", flat_phases(pa, *batch[:2])))

    def paired():
        group("paired", paired_phases(pa, *batch))
        full = lambda: pa.align_batch_device(*batch)
        full()
        group("full", {FULL: full})
    stage("paired", paired)
    split = [l for l in lines if l["view"] == "paired"]
    full = lines[-1]

    def total(key):
        if full[key] is None:
            return None, None
        s = sum(l[key] for l in split)
        return s, full[key] - s
    wall, wall_rest = total("wall_ms")
    busy, busy_rest = total("device_busy_ms")
    lines.append(dict(phase="sum of pair: phases", view="summary",
                      cand_per_read=cand_per_read, wall_ms=wall,
                      full_wall_ms=full["wall_ms"],
                      unsplit_wall_ms=wall_rest, device_busy_ms=busy,
                      full_device_busy_ms=full["device_busy_ms"],
                      unsplit_device_busy_ms=busy_rest, device=info))
    return lines, outs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="phase_profile")
    m.add_common_args(p)
    p.add_argument("--calls", type=int, default=32,
                   help="calls a phase (the JAX tool's iters)")
    p.add_argument("--cand-per-read", type=int, default=128)
    a = p.parse_args(argv)
    from ..models.single import resolve_device
    dev = resolve_device(a.device)
    bases = int(a.bases)
    index, index_s, src = m.open_index(a.index, a.cache, bases, dev)
    m.log(f"phase_profile: index {src} in {index_s:.1f} s")
    lines, _ = run(index, device=dev, bases=bases,
                   batch_pairs=a.batch_pairs,
                   cand_per_read=a.cand_per_read, calls=a.calls)
    for line in lines:
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
