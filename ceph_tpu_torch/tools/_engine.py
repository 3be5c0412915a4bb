"""Engine reporting for the port's CRUSH CLI tools.

The batched mapper (``crush.torch_mapper``) covers the common rule
shapes.  Where it declines a rule the tools stop with
:class:`BatchedRequired` and say why: the scalar Python oracle runs only
when the caller asks for it (``--scalar``), never on its own, so a run
that was meant to time the card never times pure Python.
"""

from __future__ import annotations

import sys


class BatchedRequired(RuntimeError):
    """The batched mapper declined a rule (or ``--require-batched`` met
    ``--scalar``)."""


def declined(tool: str, what: str, err: Exception):
    """Raise :class:`BatchedRequired` for a batched-mapper refusal."""
    raise BatchedRequired(
        f"{tool}: {what}: the batched mapper declines this rule ({err}); "
        f"pass --scalar to map it with the scalar Python oracle") from err


def announce(tool: str, engine: str):
    """One line saying which engine ran."""
    print(f"{tool}: engine: {engine}", file=sys.stderr)
