"""Entry "paired": PairedAligner.align_batch_device on the index's host
tables (cuckoo lookup).  Also the entries' shared option handling."""
from __future__ import annotations

import os
from contextlib import contextmanager

# per-read result rows the window copies to the host, as the pipeline
# fetches them before it writes
PAIR_KEYS = ("pair_found", "pair_score", "result0", "loc0", "dir0",
             "score0", "mapq0", "result1", "loc1", "dir1", "score1", "mapq1")
SINGLE_OPTIONS = ("max_dist", "num_seeds", "max_hits",
                  "extra_search_depth", "cand_per_read", "max_seed_slots")
PAIRED_OPTIONS = SINGLE_OPTIONS + ("min_spacing", "max_spacing")


def options(config: dict, traffic: dict, keys: tuple) -> dict:
    """The aligner config's fields among a mix's options and the
    configuration's candidate slots (max_dist is the config's max_k)."""
    o = dict(traffic["aligner"], cand_per_read=int(config["cand_per_read"]))
    out = {k: v for k, v in o.items() if k in keys}
    out["max_k"] = out.pop("max_dist")
    return out


@contextmanager
def seed_lookup(config: dict):
    """The configuration's seed lookup while an aligner is built (the port
    reads SNAP_TPU_LOOKUP when an aligner is built)."""
    saved = os.environ.get("SNAP_TPU_LOOKUP")
    os.environ["SNAP_TPU_LOOKUP"] = config["index"]["lookup"]
    try:
        yield
    finally:
        if saved is None:
            del os.environ["SNAP_TPU_LOOKUP"]
        else:
            os.environ["SNAP_TPU_LOOKUP"] = saved


def paired_aligner(index, config: dict, traffic: dict, device):
    from snap_rnaseq_tpu_torch.models.paired import PairedAligner
    return PairedAligner(index.genome_index(), device=device,
                         **options(config, traffic, PAIRED_OPTIONS))


def build(index, genome, extras, config, traffic, device):
    with seed_lookup(config):
        aligner = paired_aligner(index, config, traffic, device)
    return aligner, PAIR_KEYS, len(index.parts["ht_entries"])
