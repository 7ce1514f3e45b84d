"""The run's own process on the host: the thread that drives the card gets
a CPU of its own for the window (and its helpers the CPUs off its core),
the affinities found come back after, and the run started from the
command line iterates sets of strings in one order (``PYTHONHASHSEED``)
and, without a card, prints no result."""
import os
import subprocess
import sys
import threading

import pytest

from bench import harness


def test_cpu_list_reads_the_kernels_format():
    assert harness.cpu_list("0-3,8\n") == {0, 1, 2, 3, 8}
    assert harness.cpu_list("5") == {5}


@pytest.mark.parametrize("allowed,cores,want", [
    (range(8), lambda c: {c % 4, c % 4 + 4}, (7, [0, 1, 2, 4, 5, 6])),
    (range(8), lambda c: {c}, (7, [0, 1, 2, 3, 4, 5, 6])),
    ({2, 3}, lambda c: {2, 3}, (3, [2])),
    ({6}, lambda c: {c}, None),
])
def test_the_driving_thread_gets_a_core_of_its_own(allowed, cores, want):
    assert harness.cpu_plan(allowed, cores) == want


def test_pinning_touches_only_this_process_and_comes_back():
    stop = threading.Event()
    helper = threading.Thread(target=stop.wait)
    helper.start()
    try:
        tid = helper.native_id
        pin = harness.HostPin()
        before = os.sched_getaffinity(0), os.sched_getaffinity(tid)
        pin.apply()
        if pin.plan is not None:
            main, others = pin.plan
            assert os.sched_getaffinity(0) == {main}
            assert os.sched_getaffinity(tid) == set(others)
        assert set(pin.counters()) == {"steal_cpu_s", "steal_all_s", "involuntary"}
        pin.restore()
        assert (os.sched_getaffinity(0), os.sched_getaffinity(tid)) == before
    finally:
        stop.set()
        helper.join()


def test_the_command_fixes_the_hash_seed_and_needs_a_card(tmp_path):
    # every interpreter start prints its hash seed: the command's first
    # start, then the one it hands over to
    (tmp_path / "sitecustomize.py").write_text(
        "import os, sys\nprint('hashseed', os.environ.get('PYTHONHASHSEED'), file=sys.stderr)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONHASHSEED"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PYTHONPATH"] = os.pathsep.join([str(tmp_path), env.get("PYTHONPATH", "")])
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", "mamba2.chat",
                          "--seed", str(2 ** 31 + 5), "--seconds", "1"],
                         capture_output=True, text=True, timeout=300, cwd=harness.ROOT, env=env)
    assert out.returncode != 0 and out.stdout.strip() == "", out
    lines = out.stderr.splitlines()
    assert lines[:2] == ["hashseed None", "hashseed 0"], out.stderr[-2000:]
    assert "mamba2.chat needs 1 CUDA card(s); found 0" in lines, out.stderr[-2000:]
