"""The processes this one started, read from ``/proc`` (Linux; standard
library only, so a script can audit itself before and after it imports
torch).

A pid is named with its start time (``/proc/<pid>/stat`` field 22) so that a
pid the kernel handed to an unrelated process after ours exited is not taken
for ours. A zombie (state Z) has exited and holds nothing: it is not alive.

Two helpers of ``multiprocessing`` outlive the work that started them:
the fork server (which forks the loader's workers) and the resource
tracker. Each exits when the last process holding its pipe exits, so a
loader worker that never exits keeps both alive; :func:`stop_mp_helpers`
stops them once nothing needs them.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Iterable, Optional, Tuple

Proc = Tuple[int, str]  # (start time in clock ticks, cmdline)


def _stat(pid: int) -> Optional[Tuple[str, int, int]]:
    """(state, parent pid, start time) of ``pid``, or None if it is gone."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            data = f.read()
    except OSError:
        return None
    fields = data[data.rindex(")") + 2:].split()  # the name may hold spaces
    return fields[0], int(fields[1]), int(fields[19])


def cmdline(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode(errors="replace").strip()
    except OSError:
        return ""


def descendants(pid: Optional[int] = None) -> Dict[int, Proc]:
    """{pid: (start time, cmdline)} of every live process below ``pid``
    (default: this one), found by walking the parent links of all
    processes once. Zombies are left out."""
    root = os.getpid() if pid is None else pid
    children: Dict[int, list] = {}
    stats = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        st = _stat(int(name))
        if st is None:
            continue
        stats[int(name)] = st
        children.setdefault(st[1], []).append(int(name))
    out: Dict[int, Proc] = {}
    todo = list(children.get(root, ()))
    while todo:
        p = todo.pop()
        todo.extend(children.get(p, ()))
        state, _, start = stats[p]
        if state != "Z":
            out[p] = (start, cmdline(p))
    return out


def alive(pid: int, start: Optional[int] = None) -> bool:
    """Whether ``pid`` runs and is not a zombie (and, given ``start``, is
    still the process that started then)."""
    st = _stat(pid)
    return st is not None and st[0] != "Z" and (start is None or st[2] == start)


def wait_gone(pids: Iterable[int] | Dict[int, Proc], timeout: float) -> Dict[int, str]:
    """Waits up to ``timeout`` seconds for ``pids`` to exit; returns
    {pid: cmdline} of those still alive (zombies count as gone). Given a
    :func:`descendants` dict, a pid counts only while its start time
    matches."""
    starts = ({p: v[0] for p, v in pids.items()} if isinstance(pids, dict)
              else {p: None for p in pids})
    deadline = time.monotonic() + timeout
    while True:
        left = {p: cmdline(p) for p, s in starts.items() if alive(p, s)}
        if not left or time.monotonic() >= deadline:
            return left
        time.sleep(0.05)


def stop_mp_helpers() -> None:
    """Stops ``multiprocessing``'s fork server, then its resource tracker
    (the fork server holds the tracker's pipe), if this process started
    them; each starts again on its next use. It raises, stopping neither,
    while a child started through ``multiprocessing`` (a loader worker, a
    spawned rank) is alive: the fork server's children would outlive it,
    and the tracker waits for every holder of its pipe."""
    import multiprocessing
    from multiprocessing import forkserver, resource_tracker

    alive = multiprocessing.active_children()
    if alive:
        raise RuntimeError(f"multiprocessing children still alive: {alive}")
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()
