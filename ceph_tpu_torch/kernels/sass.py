"""The instruction mix of one iteration of a kernel's loop, read from its
SASS, and the least time that mix can take on an H100.

:func:`loop_mix` takes ``cuobjdump -sass`` text, finds the kernel's
loop (its one backward branch) and walks one iteration from the
branch's target: a forward conditional branch falls through, an
unconditional one is followed, a ``CALL`` runs its subroutine to
``RET``.  So it counts the path on which every forward conditional
branch is not taken; the caller states which data takes that path.
Predicated instructions count: a warp issues them whatever the
predicate.

:func:`clocks_per_iteration` turns the mix into SM clocks per thread
and iteration under the H100's per-SM rates: four warp-instructions
issued a clock (128 threads), 64 threads a clock on the integer ALU
pipe (adds, logic, shifts, compares, selects), 64 on the FMA pipe's
integer multiplier (``IMAD`` in all its forms, which the compiler also
uses for shifts, moves and adds), 16 on the transcendental and
conversion unit.  An opcode whose pipe is not listed counts toward
issue only, so the result stays a least time.
"""

from __future__ import annotations

import re
import shutil
import subprocess
from collections import Counter
from pathlib import Path

# thread-instructions per SM and clock (H100, sm_90)
SM_RATES = {"issue": 128, "alu": 64, "fma": 64, "xu": 16}
PIPES = {
    "alu": {"IADD3", "LOP3", "SHF", "ISETP", "SEL", "LEA", "VIMNMX",
            "VIADDMNMX", "IMNMX", "IABS", "PRMT", "PLOP3", "FSEL",
            "FSETP", "BMSK", "SGXT"},
    "fma": {"IMAD", "IMUL", "FFMA", "FMUL", "FADD"},
    "xu": {"MUFU", "I2F", "F2I", "F2F", "I2I", "POPC", "FLO", "BREV"},
}
_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)\s*([^;]*);")


def disassemble(path: Path) -> str:
    """``cuobjdump -sass`` of an object, cubin or library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "-sass", str(path)], check=True,
                          capture_output=True, text=True).stdout


def function(text: str, name: str) -> list[tuple[int, str, str, str]]:
    """``(pc, predicate, opcode, operands)`` of every instruction of the
    one function whose mangled name contains ``name``."""
    parts = re.split(r"\n\s*Function : (\S+)", text)
    found = [body for fn, body in zip(parts[1::2], parts[2::2])
             if name in fn]
    if len(found) != 1:
        raise ValueError(f"{len(found)} functions named like {name!r}")
    return [(int(m[1], 16), (m[2] or "").strip(), m[3], m[4].strip())
            for m in _LINE.finditer(found[0])]


def _target(operands: str) -> int:
    return int(re.search(r"0x([0-9a-f]+)", operands)[1], 16)


def loop_mix(text: str, kernel: str) -> Counter:
    """Opcodes issued by one iteration of ``kernel``'s loop on the path
    where every forward conditional branch is not taken."""
    code = function(text, kernel)
    at = {pc: i for i, (pc, *_rest) in enumerate(code)}
    back = [(pc, _target(ops)) for pc, _p, op, ops in code
            if op.startswith("BRA") and _target(ops) < pc]
    if len(back) != 1:
        raise ValueError(f"{kernel}: {len(back)} backward branches, "
                         f"want one loop")
    end, head = back[0]
    mix: Counter = Counter()
    i, ret = at[head], []
    for _ in range(len(code) * 4):
        pc, pred, op, ops = code[i]
        mix[op] += 1
        base = op.split(".")[0]
        if pc == end:
            return mix
        if base == "CALL":
            ret.append(i + 1)
            i = at[_target(ops)]
        elif base == "RET":
            i = ret.pop()
        elif base == "BRA" and not pred:
            i = at[_target(ops)]
        else:
            i += 1
    raise ValueError(f"{kernel}: the walk did not come back to its loop")


def pipe_counts(mix: Counter) -> dict[str, int]:
    """Instructions of ``mix`` a pipe; ``issue`` counts all of them."""
    out = {"issue": sum(mix.values())}
    for pipe, ops in PIPES.items():
        out[pipe] = sum(n for op, n in mix.items()
                        if op.split(".")[0] in ops)
    return out


def clocks_per_iteration(mix: Counter) -> float:
    """Least SM clocks a thread's iteration takes: the most loaded of
    issue and the pipes, each at its rate."""
    return max(n / SM_RATES[pipe] for pipe, n in pipe_counts(mix).items())
