"""Genome kinds, one file for each `kind` a configuration's `genome`
entry names.

    make(spec, workers) -> benchmark.gen.genome.Genome

made from the spec's own seed; a kind that makes pieces in processes
uses `workers` of them (None: one per core).
"""
