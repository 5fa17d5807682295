"""Count the SASS instructions of the port's kernels on a CUDA machine.

    python -m posetpu_torch.tools.sass_report [SOURCE.cu ...] [--out DIR]

Builds each source (default: every kernel source of the port) with the
port's ``nvcc`` flags, disassembles the library with ``cuobjdump -sass``
and prints one JSON line per kernel function: its instruction count, its
loops (each backward branch, with the instructions between its target and
itself) and its basic blocks (address range, instruction count, last
instruction).  With ``--out`` the full listing of each
library is written there as ``<library>.sass``.  Reading the blocks on a
kernel's path gives the instructions one pixel costs.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess

from posetpu_torch.aug import cuda_kernels
from posetpu_torch.utils import cuda_build

_FUNCTION = re.compile(r"Function : (\S+)")
_INSTRUCTION = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_TARGET = re.compile(r"(0x[0-9a-f]+)\s*$")
_JUMPS = ("BRA", "CALL", "BSSY")  # their last operand is an address
_ENDS = ("BRA", "EXIT", "RET")  # a block ends after these


def parse_sass(text):
    """{function: [(address, instruction), ...]} from a listing."""
    functions, current = {}, None
    for line in text.splitlines():
        if m := _FUNCTION.search(line):
            current = functions.setdefault(m.group(1), [])
        elif current is not None and (m := _INSTRUCTION.match(line)):
            current.append((int(m.group(1), 16), m.group(2)))
    return functions


def _opcode(instruction):
    words = instruction.split()
    if words and words[0].startswith("@"):  # predicate
        words = words[1:]
    return words[0].split(".")[0] if words else ""


def _target(instruction):
    if _opcode(instruction) in _JUMPS and (m := _TARGET.search(instruction)):
        return int(m.group(1), 16)
    return None


def blocks(instructions):
    """Basic blocks: a block starts at a jump target or after a branch,
    exit or return.  [(start, end, count, last instruction), ...]"""
    leaders = {a for a, _ in instructions[:1]}
    for i, (_, ins) in enumerate(instructions):
        if (t := _target(ins)) is not None:
            leaders.add(t)
        if _opcode(ins) in _ENDS and i + 1 < len(instructions):
            leaders.add(instructions[i + 1][0])
    out = []
    for addr, ins in instructions:
        if addr in leaders or not out:
            out.append([addr, addr, 0, ins])
        out[-1][1:] = [addr, out[-1][2] + 1, ins]
    return [tuple(b) for b in out]


def summarize(functions):
    out = []
    for name, instructions in functions.items():
        loops = [
            {"from": f"{t:#06x}", "to": f"{a:#06x}",
             "instructions": sum(1 for b, _ in instructions if t <= b <= a)}
            for a, ins in instructions
            if _opcode(ins) == "BRA" and (t := _target(ins)) is not None and t < a
        ]
        out.append({
            "function": name,
            "instructions": len(instructions),
            "loops": loops,
            "blocks": [
                {"start": f"{s:#06x}", "end": f"{e:#06x}", "instructions": n,
                 "last": last}
                for s, e, n, last in blocks(instructions)
            ],
        })
    return out


def _cuobjdump():
    return os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*", default=list(cuda_kernels.SOURCES))
    ap.add_argument("--out", help="directory for the full listings")
    args = ap.parse_args(argv)
    libs = cuda_build.build(args.sources)
    for src in args.sources:
        text = subprocess.run(
            [_cuobjdump(), "-sass", libs[src]], capture_output=True, text=True,
            timeout=300, check=True,
        ).stdout
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            name = os.path.basename(libs[src]) + ".sass"
            with open(os.path.join(args.out, name), "w") as f:
                f.write(text)
        for entry in summarize(parse_sass(text)):
            print(json.dumps({"source": src, **entry}), flush=True)


if __name__ == "__main__":
    main()
