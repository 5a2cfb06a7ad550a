"""The port's multi-process tier (dlimgedit_tpu_torch/parallel/multihost.py)
on the CPU; JAX's tests/test_multihost.py is the model.

One spawn of TWO processes joined by a gloo group through
``multihost.initialize``, 4 CPU devices each (tests/_torch_multihost_worker.py):
tp stays inside a process, dp and the train step's gradient all-reduce
cross the processes. Both ranks must report the same loss and bit-equal
parameters after the step. Also the two cheap cases of JAX's file:
``global_mesh`` with an explicit dp, and ``local_rows`` refusing a
trailing-axis sharding.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from dlimgedit_tpu_torch.parallel.mesh import (
    NamedSharding,
    P,
    make_mesh,
    put,
    replicated,
)
from dlimgedit_tpu_torch.parallel.multihost import global_mesh, local_rows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_multihost_worker.py")
CPU = torch.device("cpu")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_global_mesh_explicit_dp():
    """An explicit dp with tp unset derives tp = n // dp."""
    mesh = global_mesh(dp=8, devices=[CPU] * 8)
    assert mesh.shape == {"dp": 8, "tp": 1}
    mesh = global_mesh(dp=2, devices=[CPU] * 8)
    assert mesh.shape == {"dp": 2, "tp": 4}
    assert mesh.processes.tolist() == [[0] * 4] * 2
    with pytest.raises(AssertionError, match="dp\\(3\\)"):
        global_mesh(dp=3, tp=2, devices=[CPU] * 8)


def test_local_rows_rejects_trailing_axis_sharding():
    mesh = make_mesh(8, dp=4, tp=2, devices=[CPU] * 8)
    x = np.arange(4 * 8, dtype=np.float32).reshape(4, 8)
    ok = put(x, NamedSharding(mesh, P("dp", None)))
    np.testing.assert_array_equal(local_rows(ok), x)
    whole = put(x, replicated(mesh))  # every device holds all of it
    assert all(t.shape == (4, 8) for _, _, t in whole.shards)
    np.testing.assert_array_equal(local_rows(whole), x)
    bad = put(x, NamedSharding(mesh, P("dp", "tp")))
    with pytest.raises(ValueError, match="leading-axis"):
        local_rows(bad)


def test_two_process_mesh_encode_train_and_checkpoint(tmp_path):
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, f"localhost:{port}", "2", str(pid),
         str(tmp_path / "ckpt")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=REPO) for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multihost workers timed out:\n" + "\n".join(outs))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
        assert "MULTIHOST-OK" in out, out[-4000:]
    lines = [next(ln for ln in out.splitlines() if "MULTIHOST-OK" in ln)
             for out in outs]
    # Both ranks: the same globally reduced loss and the same parameters.
    assert len({ln.split("loss=")[1].split()[0] for ln in lines}) == 1, lines
    assert len({ln.split("params=")[1].split()[0] for ln in lines}) == 1, lines
