"""Reading collectives out of optimized HLO text.

The sharded solvers promise a communication pattern (one all-gather per
CG iteration, psum dot products, nothing else).  The compiled program is
the strongest evidence of it; these helpers count instructions in
``jax.jit(...).lower(...).compile().as_text()``.
"""
from __future__ import annotations

import re


def count_defs(text: str, op: str) -> int:
    """Count HLO instruction DEFINITIONS of ``op`` (``... = <shape> op(...)``).
    Operand references (`%op.7`) carry no opening paren, so ``" op("`` counts
    each instruction exactly once; `op-start`/`op-done` async pairs count as
    one via the -start form."""
    plain = len(re.findall(rf" {re.escape(op)}\(", text))
    start = len(re.findall(rf" {re.escape(op)}-start\(", text))
    return plain + start


def computations(text: str) -> dict:
    """Split optimized-HLO text into {computation_name: body_text}."""
    comps = {}
    name, lines = None, []
    for line in text.splitlines():
        m = re.match(r"^(?:ENTRY )?%?([\w.\-]+)(?: \([^)]*\))? .*{\s*$", line)
        if m and ("{" in line):
            name, lines = m.group(1), []
            continue
        if line.startswith("}") and name is not None:
            comps[name] = "\n".join(lines)
            name, lines = None, []
            continue
        if name is not None:
            lines.append(line)
    return comps


def while_body(text: str) -> str:
    """Return the text of the while-loop body computation (the per-iteration
    program). Fails loudly if no while op is present."""
    m = re.search(r"while\([^)]*\), condition=%?([\w.\-]+), body=%?([\w.\-]+)", text)
    assert m, "no while instruction found in optimized HLO"
    comps = computations(text)
    body_name = m.group(2)
    assert body_name in comps, f"while body {body_name} not found in {list(comps)[:8]}"
    return comps[body_name]
