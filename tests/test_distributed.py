"""Multi-host SPMD test: 2 real jax.distributed processes on the CPU platform
(SURVEY.md section 2.3 "Distributed runtime"; BASELINE config 5 mechanism).

Spawns two worker processes (tests/distributed_worker.py), each with 4 virtual
CPU devices, that initialize jax.distributed against a local coordinator,
build the pod mesh through parallel.distributed.make_pod_mesh, feed their own
view shard of the targets through local_target_shards, and run one
sharded_train_step. The losses and gradient checksums must agree between the
two processes AND with the same problem run single-process on an 8-device
mesh — i.e. the multi-host code path computes exactly the single-controller
answer.
"""

import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _parse(out: str):
    loss = float(re.search(r"^LOSS (\S+)$", out, re.M).group(1))
    grads = dict(re.findall(r"^GRAD (\w+)=(\S+)$", out, re.M))
    mesh = re.search(r"^MESH (.+)$", out, re.M).group(1)
    return loss, {k: float(v) for k, v in grads.items()}, mesh


def test_two_process_train_step_matches_single_process():
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers set their own device count
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    worker = os.path.join(root, "tests", "distributed_worker.py")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=root,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=420)
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"

    results = [_parse(o) for o in outs]
    # both processes see the identical mesh and the identical (replicated) result
    assert results[0][2] == results[1][2] == "{'views': 2, 'tiles': 4}"
    assert results[0][0] == pytest.approx(results[1][0], rel=1e-6)
    for k in results[0][1]:
        assert results[0][1][k] == pytest.approx(results[1][1][k], rel=1e-5), k

    # single-process oracle on this process's own 8 virtual devices
    from splatapult_jax.parallel.mesh import (
        make_render_mesh, shard_targets, sharded_train_step,
    )
    from tests.distributed_worker import build_problem

    scene, cam_batch, targets, config = build_problem()
    mesh = make_render_mesh(num_tile_shards=4, num_view_shards=2)
    tgt = shard_targets(np.asarray(targets), config, mesh)
    loss, grads, _ = sharded_train_step(scene, cam_batch, tgt, config, mesh)
    assert float(loss) == pytest.approx(results[0][0], rel=1e-5)
    for name, want in results[0][1].items():
        got = float(np.sum(np.abs(np.asarray(getattr(grads, name)))))
        assert got == pytest.approx(want, rel=1e-4), name
