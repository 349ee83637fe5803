"""The paired engine under configuration variants at the bench's operating
point: the counterpart of the JAX repo's tools/engine_ab.py.

Configurations (the JAX tool's, :47-73):
  default   PairedAligner(cand_per_read=64), bench.py's operating point;
  norescue  the same with mate_rescue=False;
  onehot    the same under SNAP_TPU_LV_LANES=onehot (K5 scores in place
            of K1, the mate rescue's LV included);
  b2048     2,048 pairs a batch;
  cand128   cand_per_read=128, the engine's default;
  se        a SingleAligner at its defaults, on end 0 of the batches;
  all       default, norescue, onehot, b2048, se, then cand128.

Every configuration runs on one device copy of the index (the JAX tool
uploaded it again for each) over bench.py's batches and timing
(tools/bench.py: windows of rounds, median and min/max, one profiled
window for device busy ms and idle share).  SNAP_TPU_LV_LANES is unset for
each run and restored after it.  Prints one JSON line per configuration;
an error raises (the JAX tool printed it and went on).

    python -m snap_rnaseq_tpu_torch.tools.engine_ab [config ...]
        [--index DIR | --cache DIR] [--rounds 10] [--windows 5]
        [--batch-pairs 1024] [--bases 64e6] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

from . import measure as m

CONFIGS = ("default", "norescue", "onehot", "b2048", "cand128", "se")
ALL = ("default", "norescue", "onehot", "b2048", "se", "cand128")
LANES_ENV = "SNAP_TPU_LV_LANES"


@contextlib.contextmanager
def lanes_env(name):
    """SNAP_TPU_LV_LANES unset (onehot under the configuration `onehot`)
    for the duration, then restored (the JAX tool popped it, :48)."""
    saved = os.environ.pop(LANES_ENV, None)
    try:
        if name == "onehot":
            os.environ[LANES_ENV] = "onehot"
        yield
    finally:
        os.environ.pop(LANES_ENV, None)
        if saved is not None:
            os.environ[LANES_ENV] = saved


def config_engine(name, base):
    """The configuration's engine on `base`'s device copy of the index (a
    PairedAligner): a PairedAligner, or a SingleAligner for `se`."""
    if name not in CONFIGS:
        raise ValueError(f"unknown configuration {name!r}; one of "
                         f"{', '.join(CONFIGS)} or all")
    if name == "se":
        return m.single_on_state(base)
    kw = {"cand_per_read": m.CAND_PER_READ}
    if name == "norescue":
        kw["mate_rescue"] = False
    elif name == "cand128":
        kw["cand_per_read"] = 128
    return m.paired_on_state(base, **kw)


def run_config(name, index, base, *, bases=m.GENOME_BASES,
               batch_pairs=m.BATCH_PAIRS, rounds=m.ROUNDS,
               windows=m.WINDOWS, stage=m.no_stage) -> dict:
    """One configuration on `base`'s device copy of the index; its JSON
    line's dict.  The timed run is stage(name, fn)."""
    eng = config_engine(name, base)
    dev = base.device
    B = 2 * batch_pairs if name == "b2048" else batch_pairs
    batches = m.pair_batches(index, bases, B, dev)
    if name == "se":
        step = lambda b: eng.align_batch_device(b[0], b[1])
        per_batch, key = B, "result"
    else:
        step = lambda b: eng.align_batch_device(*b)
        per_batch, key = 2 * B, "pair_found"
    t0 = time.time()
    with lanes_env(name):
        res = stage(name, lambda: m.timed_windows(
            step, batches, per_batch, rounds, windows, dev))
    run_s = time.time() - t0
    out = res.pop("out")
    rps = res.pop("reads_per_sec")
    return dict(config=name, reads_per_sec=rps["median"],
                reads_per_sec_min=rps["min"], reads_per_sec_max=rps["max"],
                ms_per_batch=res.pop("wall_ms_per_batch"), batch=B,
                rounds=rounds, windows=windows, run_s=run_s,
                found_share=float((out[key] > 0).float().mean()), **res,
                reads_per_sec_windows=rps["windows"],
                device=m.device_info(dev))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="engine_ab")
    p.add_argument("configs", nargs="*", default=["default"],
                   help=f"{', '.join(CONFIGS)} or all (default: default)")
    m.add_common_args(p)
    p.add_argument("--rounds", type=int, default=m.ROUNDS)
    p.add_argument("--windows", type=int, default=m.WINDOWS)
    a = p.parse_args(argv)
    names = list(ALL) if a.configs == ["all"] else a.configs
    for n in names:
        if n not in CONFIGS:
            p.error(f"unknown configuration {n!r}")
    from ..models.paired import PairedAligner
    from ..models.single import resolve_device
    dev = resolve_device(a.device)
    bases = int(a.bases)
    index, index_s, src = m.open_index(a.index, a.cache, bases, dev)
    m.log(f"engine_ab: index {src} in {index_s:.1f} s")
    base = PairedAligner(index, device=dev, cand_per_read=m.CAND_PER_READ)
    for n in names:
        print(json.dumps(run_config(n, index, base, bases=bases,
                                    batch_pairs=a.batch_pairs,
                                    rounds=a.rounds, windows=a.windows)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
