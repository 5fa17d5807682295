"""Count the SASS instructions of the port's kernels on a CUDA machine.

    python -m posetpu_torch.tools.sass_report [SOURCE.cu ...] [--out DIR]
        [--path START STOP [--taken ADDR ...]]

Builds each source (default: every CUDA source of
:data:`posetpu_torch.libraries.LIBRARIES`) with the port's ``nvcc`` flags,
disassembles the library with ``cuobjdump -sass`` and prints one JSON line
per kernel function: its instruction count, its loops (each backward
branch, with the instructions between its target and itself) and its basic
blocks (address range, instruction count, last instruction).  With
``--out`` the full listing of each library is written there as
``<library>.sass``.  Reading the blocks on a
kernel's path gives the instructions one pixel costs; ``--path START STOP
[--taken ADDR ...]`` counts them along one path through the listing (the
branches named taken, every other conditional branch falling through),
in all and by opcode.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
from collections import Counter

from posetpu_torch.libraries import LIBRARIES
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


def path(instructions, start, stop, taken=()):
    """The instructions issued on one path through a function's listing,
    from address ``start`` through ``stop``: an unconditional branch is
    followed, a conditional one (a predicate, or a modifier such as
    ``.DIV``) is taken where its address is in ``taken`` and falls through
    elsewhere.  Raises ValueError if the path runs off the listing or
    loops."""
    at = {a: i for i, (a, _) in enumerate(instructions)}
    if start not in at or stop not in at:
        raise ValueError(f"no instruction at {start:#x} or {stop:#x}")
    i, issued = at[start], []
    while True:
        addr, ins = instructions[i]
        issued.append(ins)
        if addr == stop:
            return issued
        if len(issued) > len(instructions):
            raise ValueError(f"the path from {start:#x} loops")
        words = ins.split()
        if _opcode(ins) == "EXIT" and not words[0].startswith("@"):
            raise ValueError(f"the path exits at {addr:#x} before {stop:#x}")
        target = _target(ins) if _opcode(ins) == "BRA" else None
        if target is not None:
            conditional = words[0].startswith("@") or words[0] != "BRA" or len(words) > 2
            if not conditional or addr in taken:
                if target not in at:
                    raise ValueError(f"branch to {target:#x} outside the listing")
                i = at[target]
                continue
        i += 1
        if i == len(instructions):
            raise ValueError(f"the path from {start:#x} runs off the listing")


def path_length(instructions, start, stop, taken=()):
    """The number of instructions :func:`path` issues."""
    return len(path(instructions, start, stop, taken))


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


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*",
                    default=[lib.source for lib in LIBRARIES if lib.toolchain == "nvcc"])
    ap.add_argument("--out", help="directory for the full listings")
    ap.add_argument("--path", nargs=2, metavar=("START", "STOP"),
                    help="also count the instructions from address START through STOP "
                         "(hex), in each function whose listing holds both")
    ap.add_argument("--taken", nargs="*", default=[], metavar="ADDR",
                    help="conditional branches (hex addresses) the path takes")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    span = [int(a, 16) for a in args.path] if args.path else None
    taken = {int(a, 16) for a in args.taken}
    libs = cuda_build.build([cuda_build.Library(src, {}) for src in args.sources])
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
        functions = parse_sass(text)
        for entry in summarize(functions):
            addresses = {a for a, _ in functions[entry["function"]]}
            if span and set(span) <= addresses:
                issued = path(functions[entry["function"]], *span, taken)
                entry["path"] = {"from": f"{span[0]:#06x}", "to": f"{span[1]:#06x}",
                                 "taken": sorted(f"{a:#06x}" for a in taken),
                                 "instructions": len(issued),
                                 "opcodes": dict(Counter(map(_opcode, issued)).most_common())}
            print(json.dumps({"source": src, **entry}), flush=True)


if __name__ == "__main__":
    main()
