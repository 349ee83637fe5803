"""One run of one benchmark cell on one card.

    python3 -m benchmark.run --workload <config>.<traffic> --seed N
        --seconds S --trace 0|1

The cell's configuration (benchmark/configs/<config>.json), traffic mix
(benchmark/traffic/<traffic>.json), limits (benchmark/cells/<cell>.json)
and per-layer metric readers (benchmark/metrics/<metric>.py) are found by
the names BENCHMARK.json gives; the configuration's entry, genome kind,
extra inputs and reference, and the mix's read source, by the names
those files give (benchmark/lookup.py), before any work.

Set-up (setup_s, from process start): the configuration's genome and
extra inputs from their own seeds, its index built on the card, the
entry's aligner on the index's device copy, a pool of distinct read
batches from --seed in pinned host memory, one warm-up batch at the
cell's shapes, gc.collect(); gc.freeze().

Window: one client, closed loop.  Each step copies the next pool batch to
the card, calls the configuration's entry and copies the batch's result
rows back to the host.  Whole batches run until --seconds have passed;
the window ends when the batch in flight completes.  reads_per_s is every
read of every completed batch over the window's whole time (a pair counts
two reads); peak_mem_gib the allocator's peak over the window, resident
index included; placed_share the share of the window's reads placed
within two read lengths of their true origin.  With --trace 1 the first
steps of the window (at least 3 and 2 s) run under torch.profiler and the
per-layer metrics are printed instead.

Then `correct`: once the window has closed and the program's state is
freed, a sample of the window's reads drawn from the seed is aligned by
the plain reference (benchmark/reference/) on the same card, and each
number of the reference's comparison (reference/compare.py unless its
file defines its own) is held to its limit.

The last line of stdout is one JSON object; progress and the compared
numbers (last) go to stderr.  Without a card (or with fewer cards than
the cell asks for) it exits 3 and prints no result; if jax, jaxlib, flax
or snap_rnaseq_tpu is loaded once the window has closed it exits 4.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from . import lookup  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "snap_rnaseq_tpu")
TRACE_MIN_STEPS, TRACE_MIN_S = 3, 2.0


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_file() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell_spec(bench: dict, name: str) -> dict:
    """The workload entry, its configuration, traffic and cell files."""
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    return dict(
        workload=w,
        config=load_json(os.path.join(HERE, "configs", w["config"] + ".json")),
        traffic=load_json(os.path.join(HERE, "traffic",
                                       w["traffic"] + ".json")),
        cell=load_json(os.path.join(HERE, "cells", name + ".json")))


def metrics_for(bench: dict, name: str, traced: bool) -> list:
    """The metrics this cell reports in a run of this kind."""
    kind = "per_layer" if traced else "end_to_end"
    return [m for m in bench[kind]
            if "workloads" not in m or name in m["workloads"]]


def read_metric(name: str, ctx: dict):
    """A per-layer metric from its reader, benchmark/metrics/<name>.py;
    None when it finds nothing to read."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("metric_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def set_cache_dirs() -> None:
    """Build caches inside the checkout, at fixed paths (the port builds
    its kernels into snap_rnaseq_tpu_torch/csrc/_build/ by itself)."""
    cache = os.path.join(HERE, ".cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def sample_rows(steps: list, n_rows: int, n_sample: int, seed: int):
    """(step, row) pairs drawn from the seed over the completed steps."""
    import numpy as np
    rng = np.random.default_rng([int(seed) % (1 << 63), 0x5EED])
    n = len(steps) * n_rows
    pick = rng.choice(n, size=min(n_sample, n), replace=False)
    return sorted((int(i // n_rows), int(i % n_rows)) for i in pick)


def quarters(ends_at: list) -> list:
    """Mean ms a batch in each quarter of the window's batches."""
    import numpy as np
    dt = np.diff([0.0] + ends_at) * 1e3
    return [round(float(q.mean()), 3) for q in np.array_split(dt, 4)
            if q.size]


def take_sample(pool, outs, picks, keys: tuple):
    """The picked rows' results (per field; rows named by `keys`) and
    their reads and qualities (per end)."""
    import numpy as np

    from .program import rows_to_dict
    ends = len(pool[0].reads)
    got, reads, quals = {}, [[] for _ in range(ends)], [[] for _ in
                                                        range(ends)]
    for s_i, r in picks:
        p_i, rows = outs[s_i]
        for k, v in rows_to_dict(rows[:, r:r + 1], keys).items():
            got.setdefault(k, []).append(int(v[0]))
        for e in range(ends):
            reads[e].append(pool[p_i].reads[e][r])
            quals[e].append(pool[p_i].quals[e][r])
    return ({k: np.asarray(v, np.int64) for k, v in got.items()},
            [np.stack(x) for x in reads], [np.stack(x) for x in quals])


def inputs(config: dict, parts: dict | None = None) -> tuple:
    """(genome, extras by kind): the configuration's inputs, from their
    own seeds; the seconds of each into `parts`."""
    from .gen.genome import make_genome
    parts = {} if parts is None else parts
    t = time.perf_counter()
    genome = make_genome(config["genome"])
    parts["genome_s"] = time.perf_counter() - t
    log(f"genome: {genome.size:,} codes in {parts['genome_s']:.1f} s")
    extras = {}
    for x, mod in lookup.extras(config):
        if x["kind"] in extras:
            raise ValueError(f"extra input {x['kind']!r} listed twice")
        t = time.perf_counter()
        extras[x["kind"]] = mod.make(genome, x)
        parts[x["kind"] + "_s"] = time.perf_counter() - t
        log(f"{x['kind']} in {parts[x['kind'] + '_s']:.1f} s")
    return genome, extras


def setup(spec: dict, seed: int, dev, hook=None) -> dict:
    """Everything before the window: the cell's parts found by name,
    genome and extra inputs, index, aligner, the read pool in pinned
    memory, one warm-up batch; seconds of each part."""
    import torch

    from .gen.reads import make_pool
    from .program import System, sync
    config, traffic = spec["config"], spec["traffic"]
    lookup.cell(config, traffic)
    parts = {}
    genome, extras = inputs(config, parts)
    system = System(genome, extras, config, traffic, dev)
    parts.update(system.parts)
    log(f"index built in {parts['index_build_s']:.2f} s "
        f"({system.n_slices} slices), aligner in {parts['aligner_s']:.2f} s")
    if hook:
        hook(system)
    t = time.perf_counter()
    pool = make_pool(genome, traffic, int(config["reads_per_batch"]), seed,
                     extras)
    host = [[torch.from_numpy(x) for pair in zip(b.reads, b.quals)
             for x in pair] for b in pool]
    if dev.type == "cuda":
        host = [[x.pin_memory() for x in b] for b in host]
    parts["traffic_s"] = time.perf_counter() - t
    t = time.perf_counter()
    system.step([x.to(dev) for x in host[0]])
    sync(dev)
    parts["warmup_s"] = time.perf_counter() - t
    return dict(genome=genome, extras=extras, system=system, pool=pool,
                host=host, parts=parts)


def window(s: dict, dev, seconds: float, traced: bool) -> dict:
    """The closed loop of whole batches; with `traced`, its first steps
    (TRACE_MIN_STEPS and TRACE_MIN_S at least) under the profiler and
    the kernel hooks."""
    from contextlib import ExitStack

    from .program import sync
    system, host = s["system"], s["host"]
    w = dict(outs=[], attempted=0, failed=0, ends_at=[], prof=None,
             hooks=None, traced_s=0.0, traced_steps=0)
    stack = ExitStack()
    if traced:
        from . import trace
        w["hooks"] = trace.KernelHooks()
        w["prof"] = stack.enter_context(trace.profiling())
        stack.enter_context(w["hooks"].active())
    tracing = traced
    t0 = time.perf_counter()
    step = 0
    while True:
        batch = [x.to(dev, non_blocking=True) for x in host[step % len(host)]]
        w["attempted"] += 1
        try:
            w["outs"].append((step % len(host),
                              system.step(batch).cpu().numpy()))
        except Exception as exc:              # a batch that raises fails
            w["failed"] += 1
            log(f"batch {step} failed: {exc!r}")
        step += 1
        now = time.perf_counter() - t0
        w["ends_at"].append(now)
        done = now >= seconds
        if tracing and ((step >= TRACE_MIN_STEPS and now >= TRACE_MIN_S)
                        or done):
            sync(dev)
            w["traced_s"] = time.perf_counter() - t0
            w["traced_steps"] = len(w["outs"])
            stack.close()
            tracing = False
            w["untraced_from"] = time.perf_counter() - t0
        if done:
            break
    sync(dev)
    w["window_s"] = time.perf_counter() - t0
    return w


def check(s: dict, w: dict, spec: dict, seed: int, dev) -> tuple:
    """(correct, compared rows): the sampled reads of the window through
    the plain reference, once the program's state is freed."""
    import torch

    from .reference import compare
    config, traffic, cell = spec["config"], spec["traffic"], spec["cell"]
    cmp = lookup.comparison(config)
    paired = traffic["mode"] == "paired"
    ends = 2 if paired else 1
    pool, outs = s["pool"], w["outs"]
    picks = sample_rows(outs, pool[0].n_reads // ends,
                        int(cell["check_reads"]) // ends, seed)
    got, reads, quals = take_sample(pool, outs, picks, s["system"].keys)
    n_slices = s["system"].n_slices
    s["system"].free()
    s["system"] = s["host"] = None
    w["outs"] = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = lookup.reference(config).make(s["genome"], s["extras"], config,
                                        traffic, dev)
    slice_of = getattr(ref, "slice_of", None)
    if slice_of is not None and slice_of.n_slices != n_slices:
        log(f"reference: {slice_of.n_slices} index slices, the program "
            f"built {n_slices}")
    want = ref.align(reads, quals)
    log(f"reference: {len(picks)} sampled {'pairs' if paired else 'reads'}"
        f" in {time.perf_counter() - t:.1f} s; reads that differ, by "
        "output: " + json.dumps(cmp.fields(got, want, paired)))
    correct, rows = compare.judge(cmp.numbers(got, want, paired),
                                  cell["limits"])
    return correct and w["failed"] == 0 and len(picks) > 0, rows


def run(name: str, seed: int, seconds: float, traced: bool, *,
        spec: dict | None = None, bench: dict | None = None,
        device: str = "cuda", hook=None) -> dict:
    """One run; returns the result line's dict (and leaves the process's
    card state freed).  `hook(system)` may wrap the timed path (the
    benchmark's own fault tests)."""
    import numpy as np
    import torch

    from .program import rows_to_dict
    bench = bench or benchmark_file()
    spec = spec or cell_spec(bench, name)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    paired = spec["traffic"]["mode"] == "paired"
    L = int(spec["traffic"]["read_len"])

    s = setup(spec, seed, dev, hook)
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - T_START
    log(f"set-up {setup_s:.2f} s: " + json.dumps(
        {k: round(v, 3) for k, v in s["parts"].items()}))
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    w = window(s, dev, seconds, traced)
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    per_batch = s["pool"][0].n_reads
    n_done = len(w["outs"]) * per_batch
    log(f"window: {len(w['outs'])} batches of {per_batch} reads in "
        f"{w['window_s']:.3f} s ({w['attempted']} attempted, "
        f"{w['failed']} failed); ms a batch by quarter: "
        + json.dumps(quarters(w["ends_at"])))

    # placement against the generator's origins, every read of the window
    placed = 0
    ends = ("0", "1") if paired else ("",)
    keys = s["system"].keys
    for p_i, rows in w["outs"]:
        d = rows_to_dict(rows, keys)
        for e, true in zip(ends, s["pool"][p_i].true_loc):
            placed += int((np.abs(d["loc" + e] - true) <= 2 * L).sum())
    e2e = dict(reads_per_s=n_done / w["window_s"],
               placed_share=placed / max(n_done, 1),
               peak_mem_gib=window_peak / 2 ** 30, setup_s=setup_s)
    device_info = dict(platform="gpu" if cuda else "cpu",
                       kind=torch.cuda.get_device_name(dev) if cuda
                       else "cpu", count=1,
                       memory_peak_bytes=int(max(setup_peak, window_peak)))
    ctx = dict(parts=s["parts"], n_slices=s["system"].n_slices,
               window_s=w["window_s"], steps=len(w["outs"]),
               reads_per_batch=per_batch)
    breakdown = None
    if traced and cuda:
        from . import trace
        summ = trace.summarize(w["prof"], w["traced_s"])
        ctx.update(trace=summ, traced_s=w["traced_s"],
                   traced_steps=w["traced_steps"],
                   untraced_from=w["untraced_from"],
                   traced_reads=w["traced_steps"] * per_batch)
        clock = trace.max_sm_clock_hz()
        if clock and w["hooks"].calls:
            ops = trace.roofline.int32_ops_per_s(
                torch.cuda.get_device_properties(dev).multi_processor_count,
                clock)
            ctx["kernel_bounds"] = w["hooks"].bounds_s(ops)
        device_info.update(busy_s=summ["busy_s"], window_s=w["traced_s"])
        breakdown = dict(device_ops=summ.get("device_ops", []),
                         idle_gaps=summ.get("idle_gaps", []))
    w["prof"] = w["hooks"] = None

    correct, rows = check(s, w, spec, seed, dev)
    metrics = {}
    for m in metrics_for(bench, name, traced):
        v = read_metric(m["name"], ctx) if traced else e2e.get(m["name"])
        if v is not None:
            metrics[m["name"]] = dict(value=v, unit=m["unit"])
    line = dict(correct=bool(correct), attempted=w["attempted"],
                failed=w["failed"], metrics=metrics, device=device_info)
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["compared"] = {k: dict(value=v, limit=lim) for k, v, lim in rows}
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    set_cache_dirs()
    bench = benchmark_file()
    spec = cell_spec(bench, a.workload)
    import torch
    chips = int(spec["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"benchmark: needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    line = run(a.workload, a.seed, a.seconds, bool(a.trace), spec=spec,
               bench=bench)
    bad = loaded_forbidden()
    if bad:
        log(f"benchmark: loaded in this process: {', '.join(bad)}")
        return 4
    print(json.dumps(line), flush=True)
    for k, v in line["compared"].items():
        log(f"{k}: {v['value']:.6g} (limit {v['limit']:.6g})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
