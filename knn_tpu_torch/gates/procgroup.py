"""Process-group hygiene for the gates that boot ``serve``: the port's
copy of the JAX package's ``scripts/procgroup.py``.

A gate spawns each server through :func:`popen_group`: the child gets its
own session (its own process group), and an ``atexit`` sweep SIGKILLs
every group still alive, so a failed check, an uncaught exception or a
plain ``sys.exit(1)`` in the middle of a gate never strands a serving
process (and its hold on the card) for the next run.

Deliberate kills keep working: ``proc.kill()`` and ``proc.send_signal``
target the child itself, and :func:`kill_group` SIGKILLs a whole group on
demand. The sweep is a no-op for groups that already exited
(``ProcessLookupError`` is the success case).
"""

from __future__ import annotations

import atexit
import os
import signal
import subprocess

_SPAWNED: "list[subprocess.Popen]" = []


def popen_group(cmd, **kwargs) -> subprocess.Popen:
    """``subprocess.Popen`` in a fresh session and process group,
    registered for the atexit sweep. Same signature as Popen otherwise."""
    kwargs.setdefault("start_new_session", True)
    proc = subprocess.Popen(cmd, **kwargs)
    _SPAWNED.append(proc)
    return proc


def kill_group(proc: subprocess.Popen,
               sig: int = signal.SIGKILL) -> None:
    """Signal the child's whole process group (with start_new_session the
    group id is the child's pid). A group already gone is a no-op."""
    try:
        os.killpg(proc.pid, sig)
    except (ProcessLookupError, PermissionError, OSError):
        pass


def _sweep() -> None:
    # Even for a leader that exited, sweep the group: a grandchild may
    # linger in it (killpg on an empty group is the no-op success case).
    for proc in _SPAWNED:
        kill_group(proc)


atexit.register(_sweep)
