"""Loop sizes of the port's CUDA kernels, read from their SASS.

    python -m snap_rnaseq_tpu_torch.tools.sass_loops [library ...]

For each kernel of each named library of ops/kernels.py (default: all;
built first where needed) prints every innermost loop: its body's SASS
instruction count (from a label to the backward branch that returns to
it), its most frequent opcodes, and three timings of one iteration in
cycles, from the instructions' register and predicate dependences with
an assumed latency of ALU_CYCLES for an arithmetic result and
LOAD_CYCLES for a load (shared memory, or an L1 hit):
  * chain: the longest dependent path the iteration adds to the values
    the loop carries, issue slots ignored: the least time of one
    iteration whatever the schedule;
  * issue: one warp issuing the body in order, one instruction a cycle,
    each waiting for its operands: the time of an iteration when nothing
    else runs on the scheduler;
  * issue with loads as fast as arithmetic: where it is below `issue`,
    a load's latency waits in the loop.
K2's largest loop walks one packed word, 8 text columns, so an eighth of
its body is the instructions per column, and the difference between its
W = 4 and W = 3 instances the instructions per pattern word.  K4's walks
one staged word, 4 columns.  Needs the CUDA toolkit's cuobjdump.
"""
from __future__ import annotations

import argparse
import collections
import os
import re
import shutil
import subprocess
import sys

_FUNC = re.compile(r"Function : (\S+)")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][\w.]*)"
                    r"([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
# a branch target: a label, or an address in older cuobjdumps' output
_TARGET = re.compile(r"`\(?(\.L_x_\d+)\)?|\b0x([0-9a-f]+)\b")


def cuobjdump() -> str | None:
    """The CUDA toolkit's cuobjdump, or None where it is missing."""
    path = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return path if os.path.exists(path) else None


def parse(sass: str) -> dict:
    """{function: [(opcode, operands)]} and {function: {target: index}}
    (labels, and instruction addresses as hex) from `cuobjdump -sass`
    text."""
    funcs, labels, cur = {}, {}, None
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = m.group(1)
            funcs[cur], labels[cur] = [], {}
            continue
        if cur is None:
            continue
        m = _LABEL.match(line)
        if m:
            labels[cur][m.group(1)] = len(funcs[cur])
            continue
        m = _INSTR.search(line)
        if m:
            labels[cur][int(m.group(1), 16)] = len(funcs[cur])
            # the guard, if any, stays in front of the operands
            funcs[cur].append((m.group(3), (m.group(2) or "") + m.group(4)))
    return funcs, labels


def innermost_loops(instrs, labels) -> list:
    """(first, last) instruction indices of each loop that holds no other:
    a branch back to a target at or before it."""
    loops = []
    for i, (op, args) in enumerate(instrs):
        if not op.startswith("BRA"):
            continue
        m = _TARGET.search(args)
        if not m:
            continue
        target = m.group(1) or int(m.group(2), 16)
        if labels.get(target, i + 1) <= i:
            loops.append((labels[target], i))
    return [(a, b) for a, b in loops
            if not any(a <= c and d <= b and (c, d) != (a, b)
                       for c, d in loops)]


ALU_CYCLES = 4      # dependent-issue latency assumed for arithmetic
LOAD_CYCLES = 30    # and for a shared-memory load or an L1 hit
_REG = re.compile(r"\b(U?R\d+|U?P\d)\b")
_NO_DEST = ("ST", "BRA", "BAR", "EXIT", "RET", "NOP", "WARPSYNC", "BSYNC",
            "BSSY", "YIELD", "RED", "MEMBAR", "DEPBAR")


def _operands(op: str, args: str) -> tuple:
    """(destinations, sources) of one SASS instruction, registers and
    predicates only (RZ, PT and constants carry no dependence); a guard
    predicate is a source, and a .64 / .128 / .WIDE result fills 2 / 4
    consecutive registers."""
    g = re.match(r"\s*@!?(U?P\d)\s*", args)
    if g:
        args = args[g.end():]
    parts = [a.strip() for a in args.split(",")]
    regs = [_REG.findall(a) for a in parts]
    srcs = [g.group(1)] if g else []
    if op.startswith(_NO_DEST) or not parts[0] or "[" in parts[0]:
        return [], srcs + [r for rs in regs for r in rs]
    n_dest = 2 if "SETP" in op or (
        len(parts) > 1 and re.fullmatch(r"U?P(\d|T)", parts[1])) else 1
    dests = [r for rs in regs[:n_dest] for r in rs]
    width = 4 if ".128" in op else 2 if (".64" in op or ".WIDE" in op) else 1
    if width > 1 and dests and dests[0].startswith(("R", "UR")):
        pre = "UR" if dests[0].startswith("UR") else "R"
        base = int(dests[0][len(pre):])
        dests[:1] = [f"{pre}{base + k}" for k in range(width)]
    return dests, srcs + [r for rs in regs[n_dest:] for r in rs]


def timing(instrs, a: int, b: int, in_order: bool,
           load_cycles: int = LOAD_CYCLES, iterations: int = 8) -> float:
    """Cycles per iteration of the loop instrs[a..b] in steady state (the
    body run `iterations` times, the growth over the second half): with
    in_order, one instruction issued a cycle in program order, each when
    its sources are ready; without, each as soon as its sources are
    ready (the dependent chain)."""
    ready = collections.defaultdict(int)
    t, ends = 0, []
    for _ in range(iterations):
        for op, args in instrs[a:b + 1]:
            dests, srcs = _operands(op, args)
            start = max((ready[r] for r in srcs), default=0)
            if in_order:
                start = t = max(t + 1, start)
            lat = load_cycles if op.startswith("LD") else ALU_CYCLES
            for r in dests:
                ready[r] = start + lat
        ends.append(t if in_order else max(ready.values(), default=0))
    half = iterations // 2
    return (ends[-1] - ends[half - 1]) / (iterations - half)


def report(so_path: str) -> dict:
    """{function: [(body instructions, top opcodes, chain cycles, issue
    cycles, issue cycles with loads at ALU_CYCLES)]} for a library."""
    tool = cuobjdump()
    if tool is None:
        raise RuntimeError("cuobjdump not found: it comes with the CUDA "
                           "toolkit")
    sass = subprocess.run([tool, "-sass", so_path], check=True,
                          capture_output=True, text=True).stdout
    funcs, labels = parse(sass)
    out = {}
    for name, instrs in funcs.items():
        rows = []
        for a, b in innermost_loops(instrs, labels[name]):
            ops = collections.Counter(op.split(".")[0]
                                      for op, _ in instrs[a:b + 1])
            rows.append((b - a + 1, ops.most_common(8),
                         timing(instrs, a, b, False),
                         timing(instrs, a, b, True),
                         timing(instrs, a, b, True, ALU_CYCLES)))
        out[name] = rows
    return out


def main(argv=None):
    from ..ops import kernels as kx
    p = argparse.ArgumentParser(prog="sass_loops")
    p.add_argument("libraries", nargs="*", default=list(kx.SOURCES))
    a = p.parse_args(argv)
    paths = kx.build_all(a.libraries)
    for lib in a.libraries:
        for name, rows in report(paths[lib]).items():
            for n, ops, chain, issue, issue_fast in rows:
                top = " ".join(f"{o}:{c}" for o, c in ops)
                print(f"{lib} {name}: loop of {n} instructions ({top}); "
                      f"cycles an iteration: chain {chain:g}, issue "
                      f"{issue:g} ({issue_fast:g} with fast loads)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
