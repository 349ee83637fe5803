"""Per-read trace: the _DumpAlignments analog (BaseAligner.cpp:622-631).

Port of snap_rnaseq_tpu/models/trace.py.  The engine runs whole batches;
to debug one read's verdict the trace replays the phases of
models/single.py for that read alone (B = 1) with the scoring budget off
(LV on every candidate slot: no prefilter, no compaction, no wide tier)
and formats what each phase saw: the seeds and their hits, the unique
candidates with their scores, and the result.  The phases run on the
aligner's device; the text equals the JAX package's.

    from snap_rnaseq_tpu_torch.models.trace import trace_read
    print(trace_read(aligner, read_codes, quals))

or through the CLI:  snap-rna trace <index-dir> <read> [<quals>]
[--device cuda|cpu] (read as an ACGT string, quals as a phred+33 string;
default 'I' * L).
"""
from __future__ import annotations

import numpy as np
import torch

from . import single as sg


def trace_read(aligner, read_codes: np.ndarray, quals: np.ndarray) -> str:
    """Phase-by-phase trace of one read through the given SingleAligner."""
    dev = aligner.device
    read_codes = np.asarray(read_codes, np.uint8).reshape(1, -1)
    quals = np.asarray(quals, np.uint8).reshape(1, -1)
    L = read_codes.shape[1]
    cfg = aligner.cfg.resolve_for_read_len(L)
    # exhaustive scoring: no prefilter/compaction/budget, no wide tier
    cfg = sg.SingleAlignerConfig(**{**cfg.__dict__,
                                    "score_budget_per_read": 0,
                                    "compact_per_read": 0,
                                    "overflow_tier": False})
    positions, wraps = aligner.schedule_for(L)
    state = aligner.state
    genome = aligner.index.genome
    seed_len = aligner.index.seed_len
    t = lambda a: torch.from_numpy(np.array(a)).to(dev)
    h = lambda x: x.cpu().numpy()
    reads = t(read_codes)
    sched = t(np.asarray(positions, np.int32))

    seeds = sg.seed_phase(reads, tuple(int(x) for x in positions), seed_len,
                          state["overflow"], aligner.genome_size, state,
                          schedule_t=sched)
    counts = h(torch.where(seeds["found"][:, :, None], seeds["counts"], 0))
    budget = sg.budget_phase(seeds["valid"], t(counts),
                             t(np.asarray(wraps, np.int32)), cfg)
    cands = sg.expand_phase(seeds, budget, sched, state["overflow"], cfg,
                            seed_len, L, cfg.cand_per_read)
    u = sg.aggregate_phase(cands)
    sc = sg.score_phase(u, reads, t(quals), state["genome_p4"],
                        state["piece_starts"], cfg, seed_len, L,
                        aligner.genome_size)
    out = sg.replay_phase(u, sc, budget, reads, 1, len(positions), cfg)

    lines = [f"read: {L}bp, seed_len {seed_len}, e_max {cfg.e_max}, "
             f"num_seeds {cfg.num_seeds}, max_hits {cfg.max_hits}"]
    valid = h(seeds["valid"])[0]
    found = h(seeds["found"])[0]
    applied = h(budget["applied_act"])[0]
    popular = h(budget["popular"])[0]
    lines.append("seeds (offset: fwd-hits/rc-hits flags):")
    for s, p in enumerate(positions):
        flags = []
        if not valid[s]:
            flags.append("invalid")
        if not found[s]:
            flags.append("miss")
        for d in range(2):
            if popular[s, d]:
                flags.append(f"popular[{'fr'[d]}]")
            if applied[s, d]:
                flags.append(f"applied[{'fr'[d]}]")
        lines.append(f"  @{int(p):3d}: {counts[0, s, 0]}/{counts[0, s, 1]} "
                     f"{' '.join(flags)}")

    live = h(u["live"])
    loc = h(u["loc"])
    dirs = h(u["dir"])
    score = h(sc["score"])
    logp = h(sc["logp"])
    okd = h(sc["scored_ok"])
    loc_adj = h(sc["loc_adj"])
    order = np.argsort(np.where(live & okd, score, 1 << 30), kind="stable")
    n_live = int(live.sum())
    lines.append(f"candidates: {n_live} unique "
                 f"(slots {live.shape[0]}, truncated "
                 f"{int(h(cands['truncated'])[0])})")
    shown = 0
    for c in order:
        if not live[c] or shown >= 50:
            break
        name, off = genome.piece_at(int(loc_adj[c] if okd[c] else loc[c]))
        lines.append(
            f"  {name}:{off + 1} {'fwd' if dirs[c] == 0 else 'rc '} "
            + (f"score {int(score[c]):2d} logp {float(logp[c]):9.3f}"
               if okd[c] else "score >e_max"))
        shown += 1
    if n_live > shown:
        lines.append(f"  ... {n_live - shown} more (unscored/worse)")

    res = {k: h(v)[0] for k, v in out.items() if tuple(v.shape[:1]) == (1,)}
    status = {0: "NotFound", 1: "SingleHit", 2: "MultipleHits"}[
        int(res["result"])]
    if int(res["result"]) != 0:
        name, off = genome.piece_at(int(res["loc"]))
        where = f"{name}:{off + 1} {'fwd' if int(res['direction']) == 0 else 'rc'}"
    else:
        where = "-"
    lines.append(f"result: {status} {where} score {int(res['score'])} "
                 f"mapq {int(res['mapq'])} "
                 f"log_pbest {float(res['log_pbest']):.3f} "
                 f"log_pall {float(res['log_pall']):.3f} "
                 f"popular_skipped {int(res['popular'])}")
    return "\n".join(lines)
