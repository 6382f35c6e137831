"""No process the port starts outlives its owner.

The loader's workers are forked from a fork server, outlive an epoch and
ignore SIGTERM (``csts_torch/data/loader.py``). A script that still held a
loader when the interpreter exited never exited: ``multiprocessing``'s exit
handler SIGTERMs its daemonic children and then joins them without a
timeout, and these ignore the signal. The script here reproduces that;
``GazeLoader.close()`` and the module's ``atexit`` hook repair it.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from csts_torch import presets
from csts_torch.data import loader as loader_lib
from csts_torch.data.synthetic import write_dataset
from csts_torch.utils import procs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a loader held in a module global while the interpreter exits
SCRIPT = """
import json, os, sys
sys.path.insert(0, {root!r})
from csts_torch import presets
from csts_torch.data import loader as loader_lib
from csts_torch.utils import procs

LOADER = None


def main():
    global LOADER
    cfg = presets.small_cfg(2)
    cfg.DATA.PATH_PREFIX, cfg.DATA.PATH_TO_DATA_DIR = {prefix!r}, {splits!r}
    cfg.DATA.DECODING_BACKEND = "npy"
    cfg.DATA_LOADER.NUM_WORKERS = 2
    cfg.TEST.BATCH_SIZE = 2
    LOADER = loader_lib.construct_loader(cfg, "test")
    batch = next(iter(LOADER))
    assert batch["video"].shape[0] == 2
    with open({pids!r}, "w") as f:
        json.dump({{p: v[0] for p, v in procs.descendants().items()}}, f)


if __name__ == "__main__":
    main()
"""


def _session(sid: int) -> dict:
    """{pid: cmdline} of the live processes of session ``sid``."""
    out = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if fields[0] != "Z" and int(fields[3]) == sid:
            out[int(name)] = procs.cmdline(int(name))
    return out


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    return write_dataset(str(tmp_path_factory.mktemp("procs")), "ego4d", num_clips=2,
                         res=(32, 48), seed=0)


def _cfg(split, out, workers=2):
    cfg = presets.small_cfg(2)
    cfg.DATA.PATH_PREFIX, cfg.DATA.PATH_TO_DATA_DIR = split
    cfg.DATA.DECODING_BACKEND = "npy"
    cfg.DATA.GAUSSIAN_KERNEL = 5
    cfg.DATA.TRAIN_JITTER_SCALES = [32, 32]
    cfg.DATA_LOADER.NUM_WORKERS = workers
    cfg.SOLVER.MAX_EPOCH = 1
    cfg.TRAIN.CHECKPOINT_EPOCH_RESET = True
    cfg.TEST.BATCH_SIZE = 2
    cfg.OUTPUT_DIR = str(out)
    return cfg


def test_script_holding_a_loader_exits(split, tmp_path):
    """The script exits 0 within 30 s with its stdout in a file, and none of
    the processes it started (its loader's 2 workers, the fork server, the
    resource tracker) is alive 2 s later. Before the repair it had not
    exited after 90 s, the fork server, the tracker and both workers alive."""
    script, pids = tmp_path / "hold_loader.py", tmp_path / "pids.json"
    script.write_text(SCRIPT.format(root=ROOT, prefix=split[0], splits=split[1],
                                    pids=str(pids)))
    with open(tmp_path / "stdout.txt", "w") as out:
        proc = subprocess.Popen([sys.executable, str(script)], stdout=out,
                                stderr=subprocess.STDOUT, start_new_session=True)
    t0 = time.monotonic()
    try:
        rc = proc.wait(timeout=90)
        took = time.monotonic() - t0
        time.sleep(2)
        left = _session(proc.pid)
    finally:
        if proc.poll() is None:
            proc.kill()
        try:
            os.killpg(proc.pid, signal.SIGKILL)  # whatever it left behind
        except ProcessLookupError:
            pass
        proc.wait()
    log = (tmp_path / "stdout.txt").read_text()
    assert rc == 0, log
    assert took < 30, f"the script took {took:.1f} s to exit"
    started = {int(p): s for p, s in json.loads(pids.read_text()).items()}
    assert len(started) >= 3, started  # two workers, the fork server (and the tracker)
    assert not procs.wait_gone(list(started), 0) and not left, left


def test_close_stops_the_workers(split, tmp_path):
    """``close()`` leaves no worker; a closed loader raises on ``iter`` (a
    new epoch needs a loader built anew), and a second close does nothing."""
    loader = loader_lib.construct_loader(_cfg(split, tmp_path), "test")
    assert loader in loader_lib._LIVE
    with loader:
        next(iter(loader))
        workers = {w.pid for w in loader._iterator._workers}
        assert len(workers) == 2
    assert loader._iterator is None and loader not in loader_lib._LIVE
    assert not procs.wait_gone(workers, 0)
    with pytest.raises(RuntimeError, match="closed"):
        iter(loader)
    loader.close()


def test_workers_fork_from_a_server_that_imported_torch(split, tmp_path):
    """The workers' fork server imported torch and the loader once, when it
    started (its command line names them: ``loader.FORKSERVER_PRELOAD``),
    so a worker it forks does not import them itself. Python 3.12's server
    never imports ``__main__``, its default preload, and each worker took
    ~3 s on a CPU-only host (~20 s on an H100's host) to import torch."""
    with loader_lib.construct_loader(_cfg(split, tmp_path), "test") as loader:
        next(iter(loader))
        servers = set()
        for w in loader._iterator._workers:
            with open(f"/proc/{w.pid}/stat") as f:
                servers.add(int(f.read().rsplit(")", 1)[1].split()[1]))  # the parent
    assert len(servers) == 1
    cmd = procs.cmdline(servers.pop())
    assert "multiprocessing.forkserver import main" in cmd, cmd
    assert repr(loader_lib.FORKSERVER_PRELOAD) in cmd, cmd


def test_close_kills_a_stuck_worker(split, tmp_path, monkeypatch):
    """A worker that cannot take its stop message (stopped here with
    SIGSTOP; SIGTERM, which ``terminate()`` sends, would not move it
    either) is SIGKILLed after the join timeout."""
    from torch.utils.data import _utils

    monkeypatch.setattr(_utils, "MP_STATUS_CHECK_INTERVAL", 0.2)  # torch's own waits
    loader = loader_lib.construct_loader(_cfg(split, tmp_path), "test")
    next(iter(loader))
    workers = [w.pid for w in loader._iterator._workers]
    os.kill(workers[0], signal.SIGSTOP)
    t0 = time.monotonic()
    loader.close(timeout=0.5)
    assert time.monotonic() - t0 < 10
    assert not procs.wait_gone(workers, 0)


def test_train_and_test_leave_no_process(split, tmp_path):
    """``trainer.train`` (one epoch, a validation) and ``tester.test`` with
    2 workers each: when each returns, no process it started is alive but
    ``multiprocessing``'s fork server and resource tracker, and after
    ``stop_mp_helpers`` none is."""
    from csts_torch.eval.tester import test
    from csts_torch.train.trainer import train

    torch.manual_seed(0)
    before = procs.descendants()
    helpers = ("multiprocessing.forkserver", "multiprocessing.resource_tracker")
    for run in (lambda: train(_cfg(split, tmp_path / "t"), device="cpu"),
                lambda: test(_cfg(split, tmp_path / "e"), device="cpu")):
        run()
        new = {p: v for p, v in procs.descendants().items() if before.get(p) != v}
        assert all(any(h in cmd for h in helpers) for _, cmd in new.values()), new
    procs.stop_mp_helpers()
    new = {p: v for p, v in procs.descendants().items() if before.get(p) != v}
    assert not procs.wait_gone(new, 5), new


def test_wait_gone_reads_start_times():
    """A pid counts only while its start time matches (a reused pid is not
    ours); zombies are gone."""
    me = os.getpid()
    start = procs._stat(me)[2]
    assert procs.alive(me, start) and not procs.alive(me, start + 1)
    assert procs.wait_gone({me: (start + 1, "")}, 0) == {}
    child = subprocess.Popen([sys.executable, "-c", "pass"])
    deadline = time.monotonic() + 30
    while procs._stat(child.pid)[0] != "Z" and time.monotonic() < deadline:
        time.sleep(0.05)
    assert child.pid not in procs.descendants() and not procs.wait_gone([child.pid], 0)
    child.wait()
