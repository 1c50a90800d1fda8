"""Data parallelism over GPUs: one process per GPU, joined by
``torch.distributed``.

Counterpart of pytorch_pose_estimation_tpu/parallel/mesh.py.  The JAX
package shards the batch over a 1-D device mesh and lets GSPMD insert the
all-reduces of the gradients and of the BatchNorm statistics.  Here every
collective is explicit, and the contract is the JAX package's: a train step
on N ranks gives the same loss, parameters, BN running statistics and
optimizer state as one process's step on the global batch.

* Rank r of N holds rows ``r*b:(r+1)*b`` of each global batch of B = N*b
  rows (``local_rows``), as the mesh splits a batch into contiguous rows.
* The train steps average the gradients (and the loss) over the ranks in
  one all-reduce (``average_gradients``); ``models.layers.BatchNorm2d``
  takes its train-mode statistics over the global batch.
* ``gather_rows`` gives every rank the rows of all ranks (the sharded
  validation), as an all-reduce of a zero-filled buffer: it is the one
  collective that both backends run on CUDA tensors (gloo does no
  all-gather on the GPU).

The backend is explicit: ``nccl`` when each rank owns its own GPU,
``gloo`` on the CPU and when several ranks share one card, which NCCL
refuses (``default_backend``).  With one GPU selected, nothing here
creates a process group and every helper is the identity.
"""

from __future__ import annotations

import datetime
import os
import pickle
import socket
import sys
import time
import traceback
from multiprocessing import process
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

# the longest any rank waits for the others in one collective, the group's
# rendezvous included
TIMEOUT = datetime.timedelta(minutes=30)
# the variables torchrun sets in each process it starts
TORCHRUN_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")


def under_torchrun() -> bool:
    return all(k in os.environ for k in TORCHRUN_ENV)


def world_size() -> int:
    """The ranks of the default process group, 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    return rank() == 0


def multi_node(cfg: Optional[dict] = None) -> bool:
    """Whether the ranks span more than one node: ``cfg['multihost']``, or
    torchrun's local world smaller than its world.  Then each rank loads a
    per-process shard of the train set, and ``cache_device`` falls back to
    streaming (as in the JAX package)."""
    if world_size() == 1:
        return False
    if cfg and cfg.get("multihost"):
        return True
    local = os.environ.get("LOCAL_WORLD_SIZE")
    return local is not None and int(local) != world_size()


def select_devices(devices_cfg: Union[str, int, Sequence[int], None],
                   available: Optional[int] = None) -> List[torch.device]:
    """Resolve the config's ``devices`` over the GPUs present
    (``available``, default ``torch.cuda.device_count()``), as the JAX
    package resolves it over ``jax.devices()``: 'auto' or None = all, an
    int n = the first n, a list = those indices.  Prints the world size,
    so that a short count shows."""
    n = torch.cuda.device_count() if available is None else int(available)
    present = list(range(n))
    if devices_cfg in (None, "auto"):
        chosen = present
    elif isinstance(devices_cfg, int):
        chosen = present[:devices_cfg]
    else:
        chosen = [present[i] for i in devices_cfg]
    print(f"devices: {devices_cfg!r} selects {len(chosen)} of {n} GPUs: "
          f"world size {len(chosen)}", flush=True)
    return [torch.device("cuda", i) for i in chosen]


def default_backend(devices: Sequence) -> str:
    """``nccl`` when every rank owns its own GPU, else ``gloo`` (the CPU,
    or several ranks on one card)."""
    devices = [torch.device(d) for d in devices]
    own_cards = all(d.type == "cuda" and d.index is not None
                    for d in devices) and \
        len({d.index for d in devices}) == len(devices)
    return "nccl" if own_cards else "gloo"


def maybe_init_distributed(cfg: Optional[dict] = None,
                           backend: Optional[str] = None) -> Tuple[int, int]:
    """Join torchrun's process group when its environment is set, or when
    ``cfg['multihost']`` asks for one (which then needs that environment);
    returns (rank, world) either way, (0, 1) without a group.  ``backend``
    defaults to nccl with a GPU and gloo without; under nccl the process's
    GPU is ``LOCAL_RANK``."""
    if dist.is_initialized():
        return rank(), world_size()
    if not (under_torchrun() or (cfg and cfg.get("multihost"))):
        return 0, 1
    if not under_torchrun():
        raise RuntimeError(
            "multihost needs torchrun's environment: "
            + ", ".join(TORCHRUN_ENV))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT)
    return rank(), world_size()


def free_port() -> int:
    """A TCP port on the loopback interface that is free now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn: Callable, args: tuple, r: int, world: int,
               device: torch.device, backend: str, port: int,
               timeout: datetime.timedelta, results) -> None:
    """One spawned rank: join the group, run ``fn(*args)``, send back
    (rank, ok, result or traceback)."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=r, world_size=world, timeout=timeout)
    try:
        # pickled by value here: torch would share a tensor through a file
        # descriptor that dies with this process
        results.put((r, True, pickle.dumps(fn(*args))))
    except BaseException:
        results.put((r, False, traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()


def _check_main_importable() -> None:
    """Raise unless spawn can re-import the main module in a rank.  A
    program read from standard input has a ``__file__`` that names no
    file: its ranks die on start-up, and spawn's parent then blocks for
    good writing arguments larger than a pipe's buffer to them."""
    main = sys.modules.get("__main__")
    path = getattr(main, "__file__", None)
    if path is not None and not os.path.isabs(path):  # as spawn resolves it
        path = os.path.join(process.ORIGINAL_DIR or "", path)
    if getattr(getattr(main, "__spec__", None), "name", None) is None and \
            path is not None and not os.path.exists(path):
        raise RuntimeError(
            f"parallel.launch starts its ranks with spawn, which re-imports "
            f"the main module from {path!r}: run the program from a file")


def launch(fn: Callable, devices: Sequence, backend: Optional[str] = None,
           args: tuple = (), timeout: datetime.timedelta = TIMEOUT
           ) -> List[Any]:
    """Run ``fn(*args)`` as ranks 0..N-1 of one process group, one rank per
    entry of ``devices`` (``torch.device``s or their names; each rank's GPU
    is made current, so ``"cuda"`` means it), and return the ranks'
    results in rank order.

    * Under torchrun: join its group, run ``fn`` once here, return
      ``[result]``.
    * One device: run ``fn`` here with no process group.
    * Several: start one process per device (``torch.multiprocessing``,
      start method spawn) and wait for all of them; ``fn`` and its results
      must pickle (results on the CPU).  If a rank fails, the others are
      stopped and the first failure's traceback is raised.  ``timeout``
      bounds the group's rendezvous and each collective.

    ``backend`` defaults to ``default_backend(devices)``."""
    if under_torchrun():
        cuda = all(torch.device(d).type == "cuda" for d in devices)
        maybe_init_distributed(None, backend or ("nccl" if cuda else "gloo"))
        try:
            return [fn(*args)]
        finally:
            dist.destroy_process_group()
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("launch needs at least one device")
    if len(devices) == 1:
        if devices[0].type == "cuda" and devices[0].index is not None:
            torch.cuda.set_device(devices[0])
        return [fn(*args)]
    backend = backend or default_backend(devices)
    _check_main_importable()
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.SimpleQueue()
    port = free_port()
    world = len(devices)
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, args, r, world, devices[r], backend, port,
                               timeout, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out, failure = {}, None
    try:
        # read the results while the ranks run: a rank blocks on a full pipe
        while len(out) < world and failure is None:
            if not results.empty():
                r, ok, value = results.get()
                if ok:
                    out[r] = pickle.loads(value)
                else:
                    failure = f"rank {r} failed:\n{value}"
            elif any(p.exitcode not in (None, 0) for p in procs) and \
                    results.empty():
                failure = "ranks exited with codes " + str(
                    [p.exitcode for p in procs])
            else:
                time.sleep(0.05)
        for p in procs:
            p.join(timeout.total_seconds() if failure is None else 5)
    finally:
        for p in procs:  # after a failure the others may wait on it
            if p.is_alive():
                p.terminate()
                p.join(10)
    if failure is None and any(p.exitcode != 0 for p in procs):
        failure = "ranks exited with codes " + str(
            [p.exitcode for p in procs])
    if failure is not None:
        raise RuntimeError(failure)
    return [out[r] for r in range(world)]


def _discard(fn: Callable, *args) -> None:
    fn(*args)


def run(fn: Callable, cfg: dict, device, *args) -> Any:
    """The training CLIs' entry: ``fn(*args)`` once per GPU that
    ``cfg['devices']`` selects (``launch``), or once in this process under
    torchrun, with one GPU selected and with ``device`` 'cpu'.  Returns
    ``fn``'s result where it ran in this process, else None."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU by default; "
            "pass device='cpu' to run on the CPU")
    if device.type == "cpu" or under_torchrun():
        return launch(fn, [device], args=args)[0]
    devices = select_devices(cfg.get("devices", "auto"))
    if len(devices) == 1:
        return launch(fn, devices, args=args)[0]
    launch(_discard, devices, args=(fn,) + args)
    return None


# --------------------------------------------------------------------------
# collectives of the default group; each is the identity with one rank
# --------------------------------------------------------------------------

def local_rows(x, r: Optional[int] = None, world: Optional[int] = None):
    """Rows ``r*b:(r+1)*b`` of a global batch ``x`` of B = world*b rows
    (a tensor or an array); raises unless world divides B."""
    r = rank() if r is None else r
    world = world_size() if world is None else world
    if world == 1:
        return x
    b = per_rank(len(x), world)
    return x[r * b:(r + 1) * b]


def per_rank(batch: int, world: Optional[int] = None) -> int:
    """B / world, raising unless world divides the global batch B (as the
    JAX package's device cache requires)."""
    world = world_size() if world is None else world
    if batch % world:
        raise ValueError(f"batch {batch} is not divisible by the "
                         f"{world} ranks")
    return batch // world


def average_gradients(params, *values: torch.Tensor
                      ) -> Tuple[torch.Tensor, ...]:
    """Replace every gradient of ``params`` by its mean over the ranks, in
    one all-reduce that also averages the 0-dim ``values`` (the loss);
    returns the averaged values.  Every rank gets the same sums, so the
    ranks' updates stay bitwise equal."""
    world = world_size()
    if world == 1:
        return values
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [v.detach().reshape(1).to(grads[0].dtype)
                        for v in values])
    dist.all_reduce(flat)
    flat.div_(world)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return tuple(flat[offset + i].to(v.dtype) for i, v in enumerate(values))


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks (a new tensor)."""
    t = t.clone()
    if world_size() > 1:
        dist.all_reduce(t)
    return t


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """The rows of every rank's ``t`` (all of the same shape), in rank
    order: [world * b, ...] on every rank.  An all-reduce of a zero-filled
    buffer that holds ``t`` at this rank's rows: adding zeros is exact."""
    world = world_size()
    if world == 1:
        return t
    b = t.shape[0]
    buf = torch.zeros((world * b,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    buf[rank() * b:(rank() + 1) * b] = t
    dist.all_reduce(buf)
    return buf


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank ``src``'s ``obj`` on every rank (picklable objects)."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]

