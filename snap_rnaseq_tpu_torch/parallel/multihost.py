"""Multi-host scale-out: data-parallel FASTQ sharding with per-host
pipelines and merged outputs.

Port of snap_rnaseq_tpu/parallel/multihost.py.  Reference role:
RangeSplitter.h:37-55 (input chunking) + ReadSupplierQueue.h:70-198
(decoupled suppliers) + ParallelTask.h (the per-thread share-nothing
loop), lifted from threads-on-one-box to processes-on-many-hosts.

  * Short-read alignment is embarrassingly data-parallel: reads need no
    cross-read communication and the index is read-only, so every process
    holds its own copy of the index on its own device and aligns a
    record-aligned byte range of the input (io/range_split.py), writing
    `out.part{k:04d}` on the device it was given (`device=`, CUDA by
    default).
  * torch.distributed with the gloo backend coordinates the processes:
    the stats merge is an all_gather of a 7-field int64 CPU tensor, and
    two barriers order the part merge.  Only that host-side vector
    crosses processes, so N processes may share one card (NCCL refuses
    several ranks on one GPU).  Without a coordinator, a file barrier
    (per-host stats JSON beside the output) takes its place.
  * Host 0 merges the output parts (streaming concat, or k-way merge by
    coordinate for sorted output).

`launch_local` spawns N local worker processes running this module's
`main`.  The JAX package's `devices_per_host` argument sized JAX's
virtual CPU devices and has no counterpart here.  Each host prints one
`multihost worker:` JSON line to stderr (its device, local wall seconds,
kernel launch counts, peak device bytes, engine counters), which
`launch_local` passes on to its own stderr.
"""
from __future__ import annotations

import json
import os
import sys
import time


def _stats_vector(stats) -> "np.ndarray":
    import numpy as np
    return np.array([stats.total_reads, stats.useful_reads,
                     stats.single_hits, stats.multi_hits, stats.not_found,
                     getattr(stats, "aligned_as_pairs", 0),
                     stats.lv_calls], np.int64)


STATS_FIELDS = ("total_reads", "useful_reads", "single_hits", "multi_hits",
                "not_found", "aligned_as_pairs", "lv_calls")


def part_path(out_path: str, host_id: int) -> str:
    return f"{out_path}.part{host_id:04d}"


def run_host(index_dir: str, inputs, out_path: str, *,
             host_id: int, n_hosts: int, paired: bool,
             coordinator: str | None = None,
             sorted_output: bool = False, batch_size: int = 256,
             aligner_overrides: dict | None = None,
             command_line: str = "snap-rna-mh", device="cuda") -> dict:
    """One host's worth of a multi-host alignment run.

    inputs: fastq path (single) or (fq0, fq1) (paired); coordinator:
    "host:port" of rank 0's gloo store, or None for the file barrier.
    Returns the merged global stats dict on every host (host 0 also writes
    the merged output)."""
    import torch
    import torch.distributed as dist

    from ..index.hash_index import GenomeIndex
    from ..io import range_split as rs
    from ..models.single import resolve_device
    from ..ops import kernels

    dev = resolve_device(device)
    if coordinator is not None:
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                world_size=n_hosts, rank=host_id)
    try:
        index = GenomeIndex.load(index_dir)
        overrides = aligner_overrides or {}

        t0 = time.time()
        if paired:
            fq0, fq1 = inputs
            ranges = rs.split_paired_fastq_ranges(fq0, fq1, n_hosts)
            r0, r1 = ranges[host_id]
            supplier = rs.read_paired_fastq_range(fq0, fq1, r0, r1)
            from ..models.paired_pipeline import (PairedEndPipeline,
                                                  PairedPipelineOptions)
            opt = PairedPipelineOptions(batch_size=batch_size,
                                        sorted_output=sorted_output)
            pipe = PairedEndPipeline(index, options=opt, device=dev,
                                     **overrides)
            stats = pipe.run(supplier, None, part_path(out_path, host_id),
                             command_line=command_line)
        else:
            ranges = rs.split_fastq_ranges(inputs, n_hosts)
            supplier = rs.read_fastq_range(inputs, *ranges[host_id])
            from ..models.pipeline import PipelineOptions, SingleEndPipeline
            opt = PipelineOptions(batch_size=batch_size,
                                  sorted_output=sorted_output)
            pipe = SingleEndPipeline(index, options=opt, device=dev,
                                     **overrides)
            stats = pipe.run(supplier, part_path(out_path, host_id),
                             command_line=command_line)
        local_wall = time.time() - t0
        print("multihost worker: " + json.dumps(dict(
            host_id=host_id, device=str(dev), local_wall_s=local_wall,
            launches=dict(kernels.LAUNCHES),
            peak_device_bytes=(torch.cuda.max_memory_allocated(dev)
                               if dev.type == "cuda" else None),
            engine_counters={k: int(v) for k, v in
                             stats.engine_counters.items()})),
            file=sys.stderr, flush=True)

        # ---- cross-host stats merge ----
        vec = _stats_vector(stats)
        distributed = coordinator is not None and dist.get_world_size() > 1
        if distributed:
            t = torch.from_numpy(vec)
            all_vecs = [torch.zeros_like(t) for _ in range(n_hosts)]
            dist.all_gather(all_vecs, t)
            all_vecs = torch.stack(all_vecs).numpy()
            merged = {f: int(all_vecs[:, i].sum())
                      for i, f in enumerate(STATS_FIELDS)}
            # every host must reach this point before host 0 merges parts
            dist.barrier()
        else:
            # file barrier (no coordinator: e.g. shared-FS fleets)
            _write_part_stats(out_path, host_id, vec, local_wall)
            merged = _await_all_part_stats(out_path, n_hosts)

        if host_id == 0:
            merge_parts(out_path, n_hosts, sorted_output=sorted_output)
        if distributed:
            dist.barrier()
    finally:
        if coordinator is not None:
            dist.destroy_process_group()

    merged["local_wall_s"] = local_wall
    merged["host_id"] = host_id
    return merged


def _write_part_stats(out_path, host_id, vec, wall):
    p = f"{out_path}.stats{host_id:04d}.json"
    with open(p + ".tmp", "w") as f:
        json.dump({"vec": [int(x) for x in vec], "wall": wall}, f)
    os.replace(p + ".tmp", p)


def _await_all_part_stats(out_path, n_hosts, timeout=600.0):
    deadline = time.time() + timeout
    vecs = {}
    while len(vecs) < n_hosts:
        for k in range(n_hosts):
            if k in vecs:
                continue
            p = f"{out_path}.stats{k:04d}.json"
            if os.path.exists(p):
                with open(p) as f:
                    vecs[k] = json.load(f)["vec"]
        if len(vecs) < n_hosts:
            if time.time() > deadline:
                raise TimeoutError(f"only {len(vecs)}/{n_hosts} host stats")
            time.sleep(0.05)
    import numpy as np
    arr = np.array([vecs[k] for k in range(n_hosts)], np.int64)
    return {f: int(arr[:, i].sum()) for i, f in enumerate(STATS_FIELDS)}


def merge_parts(out_path: str, n_hosts: int, *, sorted_output: bool) -> None:
    """Merge per-host SAM parts into out_path.

    Unsorted: header of part 0 + streamed body concat (hosts hold
    contiguous input ranges, so concat preserves input order — the same
    ordering a single host would emit).  Sorted: k-way merge by
    (reference index, position) over the already-sorted parts
    (SortedDataWriter.cpp:90-478's merge phase, across hosts).
    BAM output stays per-part (samtools-cat-able); merging BGZF bodies
    needs no re-alignment work and is purely an output concern.
    """
    parts = [part_path(out_path, k) for k in range(n_hosts)]
    if out_path.endswith(".bam"):
        return   # per-part BAMs are the deliverable (documented above)
    with open(out_path, "wb") as out:
        if not sorted_output:
            for k, p in enumerate(parts):
                with open(p, "rb") as f:
                    for line in f:
                        if k > 0 and line[:1] == b"@":
                            continue
                        out.write(line)
            return
        import heapq

        def records(path, k):
            rname_order = {}
            with open(path, "rb") as f:
                for line in f:
                    if line[:1] == b"@":
                        if line.startswith(b"@SQ"):
                            for fld in line.split(b"\t"):
                                if fld.startswith(b"SN:"):
                                    rname_order[fld[3:].strip()] = \
                                        len(rname_order)
                        continue
                    fields = line.split(b"\t", 4)
                    rid = rname_order.get(fields[2], 1 << 30)
                    yield (rid, int(fields[3]), k), line

        with open(parts[0], "rb") as f:
            for line in f:
                if line[:1] != b"@":
                    break
                out.write(line)
        for _, line in heapq.merge(*(records(p, k)
                                     for k, p in enumerate(parts))):
            out.write(line)


def launch_local(n_hosts: int, index_dir: str, inputs, out_path: str, *,
                 paired: bool, sorted_output: bool = False,
                 batch_size: int = 64, aligner_args: dict | None = None,
                 use_distributed: bool = True, timeout: float = 900.0,
                 device="cuda") -> dict:
    """Spawn n_hosts local worker PROCESSES on `device` (each process is
    one 'host' with its own index copy; on a card they share it).
    Exercises the REAL multi-host code path: process-group init, per-
    process input ranges, cross-process stats all_gather, output part
    merge.  On a card the kernels are built here first, so the workers
    find them built.  Returns the merged stats printed by host 0."""
    import socket
    import subprocess
    import tempfile

    from ..models.single import resolve_device
    if resolve_device(device).type == "cuda":
        from ..ops import kernels
        kernels.build_all()

    coordinator = None
    if use_distributed:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            coordinator = f"127.0.0.1:{s.getsockname()[1]}"

    # worker output goes to files, not pipes: a worker blocked on a full
    # pipe would never reach the barrier the others wait at
    procs, logs = [], []
    for k in range(n_hosts):
        cmd = [sys.executable, "-m", "snap_rnaseq_tpu_torch.parallel.multihost",
               "--index", index_dir, "--out", out_path,
               "--host-id", str(k), "--n-hosts", str(n_hosts),
               "--batch-size", str(batch_size), "--device", str(device)]
        if paired:
            cmd += ["--r0", inputs[0], "--r1", inputs[1]]
        else:
            cmd += ["--r0", inputs]
        if coordinator:
            cmd += ["--coordinator", coordinator]
        if sorted_output:
            cmd += ["--sorted"]
        for arg, flag in ((aligner_args or {}).get("cand_per_read"),
                          "--cand-per-read"), \
                         ((aligner_args or {}).get("max_seed_slots"),
                          "--max-seed-slots"):
            if arg is not None:
                cmd += [flag, str(arg)]
        logs.append((tempfile.TemporaryFile("w+"),
                     tempfile.TemporaryFile("w+")))
        procs.append(subprocess.Popen(
            cmd, stdout=logs[k][0], stderr=logs[k][1], text=True,
            cwd=os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__))))))
    outs = []
    try:
        deadline = time.time() + timeout
        for k, p in enumerate(procs):
            try:
                p.wait(timeout=max(deadline - time.time(), 0))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"multihost worker {k} timed out")
            out, err = (_read_all(f) for f in logs[k])
            if p.returncode != 0:
                raise RuntimeError(f"multihost worker {k} failed "
                                   f"rc={p.returncode}:\n{err[-4000:]}")
            sys.stderr.write(err)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f_out, f_err in logs:
            f_out.close()
            f_err.close()
    merged = json.loads(outs[0].strip().splitlines()[-1])
    merged["n_hosts"] = n_hosts
    return merged


def _read_all(f) -> str:
    f.seek(0)
    return f.read()


def main(argv=None):
    """Worker entry: python -m snap_rnaseq_tpu_torch.parallel.multihost ..."""
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--index", required=True)
    ap.add_argument("--r0", required=True)
    ap.add_argument("--r1", default=None)
    ap.add_argument("--out", required=True)
    ap.add_argument("--host-id", type=int, required=True)
    ap.add_argument("--n-hosts", type=int, required=True)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--sorted", action="store_true")
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--cand-per-read", type=int, default=None)
    ap.add_argument("--max-seed-slots", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)

    overrides = {}
    if args.cand_per_read is not None:
        overrides["cand_per_read"] = args.cand_per_read
    if args.max_seed_slots is not None:
        overrides["max_seed_slots"] = args.max_seed_slots
    paired = args.r1 is not None
    merged = run_host(args.index,
                      (args.r0, args.r1) if paired else args.r0,
                      args.out, host_id=args.host_id, n_hosts=args.n_hosts,
                      paired=paired, coordinator=args.coordinator,
                      sorted_output=args.sorted, batch_size=args.batch_size,
                      aligner_overrides=overrides, device=args.device)
    print(json.dumps(merged), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
