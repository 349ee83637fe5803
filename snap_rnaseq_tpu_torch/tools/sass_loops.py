"""Loop sizes of the port's CUDA kernels, read from their SASS.

    python -m snap_rnaseq_tpu_torch.tools.sass_loops [library ...]

For each kernel of each named library of ops/kernels.py (default: all;
built first where needed) prints every innermost loop: its body's SASS
instruction count (from a label to the backward branch that returns to
it) and its most frequent opcodes.  K2's largest loop walks one packed
word, 8 text columns, so an eighth of its body is the instructions per
column, and the difference between its W = 4 and W = 3 instances the
instructions per pattern word.  Needs the CUDA toolkit's cuobjdump.
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
            funcs[cur].append((m.group(3), m.group(4)))
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


def report(so_path: str) -> dict:
    """{function: [(body instructions, top opcodes)]} for a library."""
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
            rows.append((b - a + 1, ops.most_common(8)))
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
            for n, ops in rows:
                top = " ".join(f"{o}:{c}" for o, c in ops)
                print(f"{lib} {name}: loop of {n} instructions ({top})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
