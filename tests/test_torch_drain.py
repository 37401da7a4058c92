"""A preempted job's drain under the launcher: SIGTERM reaches
``python -m kubeflow_tpu_torch.parallel.launch``, which passes it to each
of its trainer processes (2 over gloo, ``--mesh dp=2``).  Every rank must
stop at the same step, one checkpoint must be written at that step, the
launcher must exit 0, and a restart must resume from it with the losses
of an unbroken run.  Then the launcher's grace: a process that outlives
it is killed, as are the others when one fails.

Each launcher has a watchdog of its own, which kills its whole session;
the file takes about half a minute on the CPU."""
import os
import re
import signal
import subprocess
import sys
import textwrap
import threading
import time

from kubeflow_tpu_torch.parallel import launch
from kubeflow_tpu_torch.train.checkpoint import CheckpointManager
from test_torch_multirank import REPO, worker_env

TRAIN = ["python", "-m", "kubeflow_tpu_torch.train.run", "--distributed",
         "--mesh", "dp=2", "--model", "llama_debug", "--device", "cpu",
         "--batch", "4", "--seq", "32", "--log-every", "1"]
# Both ranks print to the launcher's one stdout, and a line of one may
# land inside the other's: the patterns are searched, not anchored.
LOSS = re.compile(r"train_step step=(\d+) loss=([0-9.e+-]+)")
STOPPED = re.compile(r"preempted at step (\d+): checkpoint saved")
WATCHDOG_S = 90


def _launcher(steps, ckpt=None) -> subprocess.Popen:
    cmd = [sys.executable, "-m", "kubeflow_tpu_torch.parallel.launch",
           "--device", "cpu", "--", sys.executable] + TRAIN[1:] + [
               "--steps", str(steps)]
    if ckpt is not None:
        # Only the stop's own save: the interval never comes round.
        cmd += ["--checkpoint-dir", str(ckpt), "--checkpoint-every",
                "1000000"]
    return subprocess.Popen(
        cmd, cwd=REPO, env=worker_env({"KFT_GPUS_PER_HOST": "2"}),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)


def _kill_session(proc):
    """The launcher and every process under it (its own session)."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass


def _finish(proc, lines=()) -> list:
    """Every line ``proc`` printed (``lines`` already read), killing its
    session after ``WATCHDOG_S``."""
    watchdog = threading.Timer(WATCHDOG_S, _kill_session, (proc,))
    watchdog.start()
    try:
        out, _ = proc.communicate()
    finally:
        watchdog.cancel()
        _kill_session(proc)
    return list(lines) + out.splitlines()


def _losses(lines) -> dict:
    """step -> the loss each rank logged (every rank logs every step)."""
    by_step = {}
    for step, loss in LOSS.findall("\n".join(lines)):
        by_step.setdefault(int(step), []).append(loss)
    return by_step


def test_sigterm_drains_every_rank_at_one_step(tmp_path):
    ckpt = tmp_path / "ckpt"
    proc = _launcher(100000, ckpt)
    watchdog = threading.Timer(WATCHDOG_S, _kill_session, (proc,))
    watchdog.start()
    seen = []
    try:
        for line in proc.stdout:
            seen.append(line.rstrip("\n"))
            if "train_step step=3 " in line:
                proc.send_signal(signal.SIGTERM)
                break
    finally:
        watchdog.cancel()
    lines = _finish(proc, seen)
    text = "\n".join(lines[-60:])
    assert proc.returncode == 0, text
    stops = [int(n) for n in STOPPED.findall("\n".join(lines))]
    # 1. both ranks stop, and at the same step.
    assert len(stops) == 2 and stops[0] == stops[1], text
    at = stops[0]
    assert at >= 3, text
    # 2. one checkpoint, at that step.
    assert CheckpointManager(str(ckpt)).all_steps() == [at], text
    assert sorted(os.listdir(ckpt)) == [str(at)], text

    # 3. a restart resumes from it: its next two steps' losses are those
    # of an unbroken run of the same seed.
    resumed, unbroken = _launcher(at + 2, ckpt), _launcher(at + 2)
    resumed, unbroken = _finish(resumed), _finish(unbroken)
    again, whole = _losses(resumed), _losses(unbroken)
    assert sorted(again) == [at + 1, at + 2], "\n".join(resumed[-40:])
    for step in (at + 1, at + 2):
        assert len(whole[step]) == 2 and len(set(whole[step])) == 1
        assert again[step] == whole[step], (step, again[step], whole[step])
    assert CheckpointManager(str(ckpt)).latest_step() == at + 2


WORKER = textwrap.dedent("""
    import os, signal, sys, time
    rank, kind = int(os.environ["LOCAL_RANK"]), sys.argv[1]
    if kind == "stuck" and rank == 1:
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
    else:
        # Drains in 0.5 s.
        signal.signal(signal.SIGTERM,
                      lambda *a: (time.sleep(0.5), sys.exit(0)))
    print("up", rank, os.getpid(), flush=True)
    if kind == "fails" and rank == 1:
        sys.exit(3)
    time.sleep(60)
""")
UP = re.compile(r"^up (\d) (\d+)$", re.M)


def _supervise(kind, grace_s, signal_it=True):
    """``launch.supervise`` of WORKER on two local ranks in a process of
    its own, SIGTERMed once both are up; (exit code, seconds from the
    signal, output, the workers' pids)."""
    code = textwrap.dedent(f"""
        import sys
        from kubeflow_tpu_torch.parallel import launch
        sys.exit(launch.supervise(
            [sys.executable, "-c", {WORKER!r}, {kind!r}],
            [{{"LOCAL_RANK": "0"}}, {{"LOCAL_RANK": "1"}}],
            grace_s={grace_s}))
    """)
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                            env=worker_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    seen = []
    for line in proc.stdout:
        seen.append(line)
        if len(UP.findall("".join(seen))) == 2:
            break
    t0 = time.monotonic()
    if signal_it:
        proc.send_signal(signal.SIGTERM)
    text = "\n".join(_finish(proc, seen))
    pids = [int(pid) for _, pid in UP.findall(text)]
    return proc.returncode, time.monotonic() - t0, text, pids


def _gone(pid) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def test_launcher_passes_sigterm_to_its_processes_within_its_grace():
    """``supervise``: the SIGTERM goes to each process, the launcher
    exits 0 once they drain, and a process still running ``grace_s``
    after the signal is killed, and the launcher exits 1."""
    rc, seconds, out, pids = _supervise("drains", 30)
    assert rc == 0, out
    assert seconds < 20, out
    rc, seconds, out, pids = _supervise("stuck", 2)
    assert rc == 1 and "local ranks [1] still running 2 s after SIGTERM" \
        in out, out
    assert 2 <= seconds < 20, out
    assert len(pids) == 2 and all(_gone(pid) for pid in pids), out
    assert launch.SHUTDOWN_TIMEOUT_S >= 60


def test_launcher_ends_the_world_when_a_process_fails():
    """A process that exits non-zero ends the others at once (a world
    short of a rank can neither step nor save), and the launcher exits
    1."""
    rc, seconds, out, pids = _supervise("fails", 30, signal_it=False)
    assert rc == 1 and "local rank 1 exited with code 3" in out, out
    assert seconds < 20, out
    assert len(pids) == 2 and all(_gone(pid) for pid in pids), out
