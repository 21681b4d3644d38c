"""Two processes on the CPU (``launch/mesh.py``: ``init_distributed``,
``ProcessWaveDispatcher``; ``launch/fl_train.py --coordinator``).

(1) The JAX package's two-process smoke workload
(``examples/distributed_waves.py``, arm ``tiny``: 2 overlapped async
rounds at S=0, a wave per mediator): the test hosts a ``TCPStore`` on port
0 and hands its port to two child processes, which join it as clients
(``TORCHELASTIC_USE_AGENT_STORE``, as under torchrun).  Each wave runs on
one process and crosses to the other through the store; the committed
params are bit for bit equal across the processes and to this process's
single-process run, and so are every per-key ledger total and the commit
logs.

(2) ``fl_train --coordinator`` at the reduced config on two processes
(rank 0 hosting the store): each process's WAN ledger equals the
single-process run's.

Each child has a hard timeout of its own; a child that fails or hangs
fails the test.
"""
import json
import os
import socket
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch.examples import distributed_waves as DW              # noqa: E402
from repro_torch.launch import fl_train                               # noqa: E402

CHILD_TIMEOUT_S = 240
SRC = str(Path(__file__).resolve().parents[1] / "src")


def _children(argvs, env_extra=None):
    """Run one child a command line, all at once; each must exit 0 within
    ``CHILD_TIMEOUT_S`` (every child is killed if one hangs)."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1", **(env_extra or {}))
    procs = [subprocess.Popen([sys.executable, *argv], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for argv in argvs]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=CHILD_TIMEOUT_S)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError(f"a child hung past {CHILD_TIMEOUT_S} s")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def test_waves_across_two_processes_equal_one(tmp_path):
    store = torch.distributed.TCPStore("127.0.0.1", 0, None, is_master=True,
                                       wait_for_workers=False,
                                       timeout=timedelta(seconds=CHILD_TIMEOUT_S))
    outs = _children(
        [["-m", "repro_torch.examples.distributed_waves", "--device", "cpu",
          "--coordinator", f"127.0.0.1:{store.port}", "--num-processes", "2",
          "--process-id", str(i), "--out", str(tmp_path / f"r{i}.npz")] for i in range(2)],
        {"TORCHELASTIC_USE_AGENT_STORE": "True"})
    solo = DW.summary(DW.run_waves("tiny", "cpu"))
    names = sorted(solo["params"])
    keys = sorted(solo["ledger"])
    for i, out in enumerate(outs):
        with np.load(tmp_path / f"r{i}.npz") as z:
            report = json.loads(str(z["report"]))
            assert report["failures"] == [] and report["commits"] == DW.ROUNDS, out
            assert report["num_published"] > 0 and report["num_received"] > 0
            assert list(z["names"]) == names and list(z["ledger_keys"]) == keys
            for j, k in enumerate(names):
                assert np.array_equal(z[f"p_{j}"], solo["params"][k]), k
            assert np.array_equal(z["ledger"], [solo["ledger"][k] for k in keys])
            assert json.loads(str(z["commit_log"])) == solo["commit_log"]
    # every wave was run once and received once
    reports = [json.loads(out.strip().splitlines()[-1]) for out in outs]
    waves = sum(r["num_published"] - 1 for r in reports)     # less the params' payloads
    assert waves == sum(len(c["staleness"]) for c in solo["commit_log"])
    assert [r["num_received"] - 1 for r in reports] == \
        [waves - (r["num_published"] - 1) for r in reports]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ledger(out: str) -> dict:
    lines = out.split("WAN ledger:\n", 1)[1].splitlines()
    return {k.strip(): float(v) for k, v in
            (line.split(":", 1) for line in lines if line.startswith("  ") and ":" in line)}


def test_fl_train_coordinator_two_processes(capsys):
    port = _free_port()
    outs = _children([["-m", "repro_torch.launch.fl_train", "--device", "cpu",
                       "--rounds", "2", "--coordinator", f"127.0.0.1:{port}",
                       "--num-processes", "2", "--process-id", str(i)] for i in range(2)])
    solo = fl_train.main(["--device", "cpu", "--rounds", "2"])
    capsys.readouterr()
    assert "distributed: 2 processes joined" in outs[0]
    assert "distributed:" not in outs[1]
    for out in outs:
        got = _ledger(out)
        assert got == {k: float(round(v)) for k, v in solo["ledger"].items()}
        assert got["wan_bytes_total"] > 0


def test_fl_train_refuses_the_model_axis():
    """``--model-parallel`` above 1 runs the round on a model axis for every
    family the round trains (tests/test_torch_tp_round.py); an audio
    model's round raises for its missing frames there as at one position
    (a round's batch holds tokens only), and a size below 1 raises before
    anything runs."""
    with pytest.raises(ValueError, match="enc_feats"):
        fl_train.main(["--device", "cpu", "--model-parallel", "2", "--rounds", "1",
                       "--arch", "whisper-base"])
    with pytest.raises(SystemExit, match="model-parallel"):
        fl_train.main(["--device", "cpu", "--model-parallel", "0"])


def test_waves_on_process_local_model_axis_equal_one(tmp_path):
    """``distributed_waves --model-parallel 2``: after the usual pair of
    rounds each child runs the workload again on its
    ``process_local_mesh(model=2)`` (two model positions on its device,
    the gather oracle on the CPU, TP rows with ``tp_rows=True``) through a
    second dispatcher namespace; both passes are bit for bit this
    process's runs of the same, and the model-axis pass the 1-D pass."""
    from repro_torch.launch.mesh import process_local_mesh
    store = torch.distributed.TCPStore("127.0.0.1", 0, None, is_master=True,
                                       wait_for_workers=False,
                                       timeout=timedelta(seconds=CHILD_TIMEOUT_S))
    outs = _children(
        [["-m", "repro_torch.examples.distributed_waves", "--device", "cpu",
          "--coordinator", f"127.0.0.1:{store.port}", "--num-processes", "2",
          "--process-id", str(i), "--model-parallel", "2",
          "--out", str(tmp_path / f"r{i}.npz")] for i in range(2)],
        {"TORCHELASTIC_USE_AGENT_STORE": "True"})
    solo = DW.summary(DW.run_waves("tiny", "cpu"))
    solo2 = DW.summary(DW.run_waves("tiny", "cpu", mesh=process_local_mesh(2, device="cpu")))
    names = sorted(solo["params"])
    for j, k in enumerate(names):
        assert np.array_equal(solo2["params"][k], solo["params"][k]), k
    for i, out in enumerate(outs):
        with np.load(tmp_path / f"r{i}.npz") as z:
            report = json.loads(str(z["report"]))
            assert report["failures"] == [], out
            run = report["model_axis_run"]
            assert run["model_axis"] == 2 and run["tp_rows"] is False
            assert run["num_published"] > 0 and run["num_received"] > 0
            for prefix, want in (("", solo), ("model_", solo2)):
                assert list(z[f"{prefix}names"]) == names
                for j, k in enumerate(names):
                    assert np.array_equal(z[f"{prefix}p_{j}"], want["params"][k]), (prefix, k)
                keys = sorted(want["ledger"])
                assert np.array_equal(z[f"{prefix}ledger"], [want["ledger"][k] for k in keys])
                assert json.loads(str(z[f"{prefix}commit_log"])) == want["commit_log"]
