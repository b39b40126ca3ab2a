"""Shared ``--key=value`` argv parsing for the tools' CLIs (the port's copy
of tools/cli.py).

The tools use one flag style (``--run_id=strong-r2``). These helpers reject
an entry without '=' clearly, where a bare ``dict(a.split("=", 1) ...)``
raises an unhelpful ValueError, and serve the module docstring as usage.
Usage errors exit with status 2 (the argparse convention), so that scripts
never take a malformed invocation for success; ``--help`` exits 0.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Sequence, Tuple


def usage_error(message: str, usage: Optional[str] = None) -> "SystemExit":
    """Print ``message`` (and the usage) to stderr; the SystemExit(2) to
    raise."""
    print(message, file=sys.stderr)
    if usage:
        print(usage, file=sys.stderr)
    return SystemExit(2)


def parse_args(argv: Sequence[str], usage: Optional[str] = None,
               allow_positional: bool = True
               ) -> Tuple[Dict[str, str], List[str]]:
    """Parse ``--key=value`` flags and (optionally) bare positional values.

    Returns (flags, positionals). ``--help``/``-h`` prints the usage and
    exits 0; any other malformed argument exits 2 via :func:`usage_error`.
    """
    if any(a in ("--help", "-h") for a in argv):
        print(usage or "usage: --key=value ...")
        raise SystemExit(0)
    flags: Dict[str, str] = {}
    positional: List[str] = []
    for a in argv:
        if a.startswith("--") and "=" in a:
            key, value = a.split("=", 1)
            flags[key] = value
        elif allow_positional and not a.startswith("-"):
            positional.append(a)
        else:
            raise usage_error(
                f"bad argument {a!r}: tools take --key=value flags"
                + (" and positional values" if allow_positional else " only"),
                usage,
            )
    return flags, positional


def parse_kv_args(argv: Sequence[str], usage: Optional[str] = None
                  ) -> Dict[str, str]:
    flags, _ = parse_args(argv, usage, allow_positional=False)
    return flags
