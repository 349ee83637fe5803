"""The parts of a cell found by name: one Python file each, which defines
the function the harness calls (its directory's __init__.py says what
that takes and returns).

part          directory      named by (default)               function
entry         entries/       config["entry"][traffic["mode"]] build
genome kind   gen/genomes/   config["genome"]["kind"]         make
extra input   gen/extras/    config["extras"][i]["kind"]      make
read source   gen/sources/   traffic["source"] ("genome")     make_batch
reference     reference/     config["reference"] ("aligner")  make
comparison    reference/     the reference's file ("compare") numbers

A name is the stem of its file; one with no file fails with the path it
looked for.
"""
from __future__ import annotations

import importlib
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_-]{0,63}")


def find(sub: str, name: str, needs: str):
    """benchmark/<sub>/<name>.py as a module, which defines `needs`."""
    path = os.path.join(HERE, *sub.split("/"), f"{name}.py")
    if not (isinstance(name, str) and NAME.fullmatch(name)
            and os.path.isfile(path)):
        raise LookupError(f"{sub}: no file {path} for the name {name!r}")
    mod = importlib.import_module(".".join([__package__, *sub.split("/"),
                                            name]))
    if not callable(getattr(mod, needs, None)):
        raise LookupError(f"{sub}: {path} defines no {needs}()")
    return mod


def entry(config: dict, traffic: dict):
    return find("entries", config["entry"][traffic["mode"]], "build")


def genome_kind(spec: dict):
    return find("gen/genomes", spec["kind"], "make")


def extras(config: dict) -> list:
    """(spec, module) for each of the configuration's extra inputs."""
    return [(x, find("gen/extras", x["kind"], "make"))
            for x in config.get("extras", [])]


def source(traffic: dict):
    return find("gen/sources", traffic.get("source", "genome"),
                "make_batch")


def reference(config: dict):
    return find("reference", config.get("reference", "aligner"), "make")


def comparison(config: dict):
    """The comparison that decides `correct`: numbers(got, want, paired)
    by name, and fields(got, want, paired), the reads that differ in
    each output, for the log; the reference's own where its file defines
    them, else compare.py's."""
    ref = reference(config)
    if callable(getattr(ref, "numbers", None)):
        return ref
    return find("reference", "compare", "numbers")


def cell(config: dict, traffic: dict) -> None:
    """Every part a cell names, found before any work is done."""
    genome_kind(config["genome"])
    extras(config)
    source(traffic)
    entry(config, traffic)
    reference(config)
