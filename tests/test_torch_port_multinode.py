"""Which rows a JAX run on several processes puts in its global batch
(ROADMAP Queue 3, "data parallelism on several nodes"), against the port's
rule.

The JAX Trainer places each process's host batch with ``jax.device_put``
under the global batch sharding (``_device_batch``, through
``parallel/mesh.py::batch_sharding``; ``shard_host_batch`` is the same
call).  Two real processes under ``jax.distributed`` on the CPU (one
device each; about 5 s) show what that does with the installed JAX:

* batches that differ between the processes, as the per-process shard
  loaders of a multi-node run give them, raise: ``device_put`` asserts
  that its numpy input is the same on every process;
* one batch on every process is the global batch itself, and process p
  holds rows ``p*b:(p+1)*b`` of it, which are the port's
  ``parallel.local_rows`` of that batch on rank p.

So JAX has no global batch made of per-process shards to follow; the port
keeps its rule (each rank's shard loader yields batch_size / world rows).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np

from pytorch_pose_estimation_tpu_torch import parallel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROCESS = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 1)
pid, port = int(sys.argv[1]), sys.argv[2]
jax.distributed.initialize(coordinator_address="127.0.0.1:" + port,
                           num_processes=2, process_id=pid)
import numpy as np
from pytorch_pose_estimation_tpu.parallel.mesh import (make_mesh,
                                                       shard_host_batch)
mesh = make_mesh()
out = {}
own = np.arange(8, dtype=np.float32).reshape(8, 1) + 100 * pid
try:
    shard_host_batch({"x": own}, mesh)
    out["own"] = "placed"
except Exception as e:
    out["own"] = f"{type(e).__name__}: {e}"
same = shard_host_batch(
    {"x": np.arange(8, dtype=np.float32).reshape(8, 1)}, mesh)["x"]
out["shape"] = list(same.shape)
out["rows"] = [np.asarray(s.data).ravel().tolist()
               for s in same.addressable_shards]
print("RESULT " + json.dumps(out), flush=True)
"""


def test_jax_global_batch_on_two_processes_and_the_port_rule():
    env = dict(os.environ, PYTHONPATH=REPO,
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    procs = [subprocess.Popen([sys.executable, "-c", _PROCESS, str(p), port],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for p in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    results = []
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-2000:]
        line = next(ln for ln in log.splitlines() if ln.startswith("RESULT"))
        results.append(json.loads(line[len("RESULT "):]))
    batch = np.arange(8, dtype=np.float32)
    for p, got in enumerate(results):
        assert "is not the same on each process" in got["own"], got["own"]
        assert got["shape"] == [8, 1]
        assert got["rows"] == [parallel.local_rows(batch, p, 2).tolist()]
