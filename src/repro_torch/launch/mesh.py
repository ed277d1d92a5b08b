"""Meshes of ranks on ``torch.distributed``, and the helper that starts
them. Port of ``repro/launch/mesh.py``.

The port is SPMD: every rank is a process that runs the same model code.
A ``Mesh`` lays the ranks of the default process group out on named axes
(``("data", "model")``), as the reference's mesh lays out devices, and
holds this rank's device and its process subgroup along each axis: the
ranks that share every other coordinate with it. ``substrate/prepared.py``
gathers a tensor-parallel leaf's columns over the ``"model"`` subgroup.

Subgroups are made with ``use_local_synchronization=True``: only the
members of a group take part in making it, so a rank that a degraded mesh
drops (``make_elastic_mesh``) need not call in, and the survivors do not
wait on it. A group is made once per process for each set of ranks and
reused by every mesh that needs that set: the surviving rows of an
elastic mesh keep their model-axis groups.

``run_ranks`` starts ``world`` ranks as spawned processes over a
file-based rendezvous; on a machine with one card they all run on
``cuda:0`` over gloo. The reference's ``mesh_context`` (a jax-version
shim for the ambient mesh) has no counterpart.
"""
from __future__ import annotations

import datetime
import os
import pickle
import queue as queue_lib
import shutil
import tempfile
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# one process group per set of ranks, made once in this process
_GROUPS: Dict[Tuple[int, ...], object] = {}


def _group(ranks: Tuple[int, ...]):
    if ranks not in _GROUPS:
        _GROUPS[ranks] = dist.new_group(list(ranks), use_local_synchronization=True)
    return _GROUPS[ranks]


def _this_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


class Mesh:
    """Ranks of the default group on named axes.

    ``ranks`` is the grid of global ranks (the reference's ``devices``),
    ``axis_names`` its axes, ``shape`` axis name -> size. ``coords`` is
    this rank's place in the grid, None when the mesh does not hold it
    (``member`` False): such a rank makes no group of the mesh and takes
    no part in its collectives. ``device`` is the member's device."""

    def __init__(self, ranks, axis_names: Sequence[str], device=None):
        self.ranks = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.ranks.ndim != len(self.axis_names):
            raise ValueError(f"a {self.ranks.ndim}-D grid of ranks for axes {self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.ranks.shape))
        self.device = torch.device("cpu" if device is None else device)
        here = np.argwhere(self.ranks == _this_rank())
        self.coords = tuple(int(c) for c in here[0]) if len(here) else None
        self._groups = {}
        if self.member and dist.is_initialized():
            for axis in self.axis_names:
                self._groups[axis] = _group(self.axis_ranks(axis))

    @property
    def member(self) -> bool:
        return self.coords is not None

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        if not self.member:
            raise ValueError(f"rank {_this_rank()} is not in this mesh")
        return self.coords[self.axis_names.index(axis)]

    def axis_ranks(self, axis: str) -> Tuple[int, ...]:
        """The global ranks of this rank's line along ``axis``, in order."""
        idx = list(self.coords)
        idx[self.axis_names.index(axis)] = slice(None)
        return tuple(int(r) for r in self.ranks[tuple(idx)])

    def group(self, axis: str):
        """This rank's process subgroup along ``axis``."""
        if not self.member:
            raise ValueError(f"rank {_this_rank()} is not in this mesh")
        return self._groups[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ranks={self.ranks.tolist()}, device={self.device})"


def _local_device(device=None) -> torch.device:
    """The device of this rank: ``device``, else ``cuda:<current>`` when a
    card is set for the process, else the CPU."""
    if device is not None:
        return torch.device(device)
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_host_mesh(shape: Tuple[int, ...] = (1, 8), axes=("data", "model"), *,
                   device=None) -> Mesh:
    """A mesh over the first ``prod(shape)`` ranks of the default group.
    Every rank of the group calls it; those past ``prod(shape)`` get a mesh
    that does not hold them."""
    n = int(np.prod(shape))
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n > world:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the group has {world}")
    return Mesh(np.arange(n).reshape(shape), axes, _local_device(device))


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The reference's production shapes: (16, 16) ("data", "model"), or
    (2, 16, 16) ("pod", "data", "model") multi-pod. Raises unless the
    default group has that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_host_mesh(shape, axes, device=device)


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes of a mesh (batch sharding)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def tp_axis(mesh) -> str:
    return "model"


def make_elastic_mesh(n_failed_hosts: int = 0, *, multi_pod: bool = False,
                      base_mesh: Optional[Mesh] = None, device=None) -> Mesh:
    """Degraded mesh after losing ``n_failed_hosts`` hosts: shrink the data
    axis, keep the model axis (so the parameter placement is stable).

    With ``base_mesh`` the degraded mesh keeps the surviving ranks of that
    mesh (each data-axis row is one host): the trailing ``n_failed_hosts``
    rows drop, the model axis keeps its exact rank order, and every
    survivor keeps its device. Without it, the production (16, 16) (or
    (32, 16) multi-pod) shape is rebuilt over the default group."""
    if base_mesh is not None:
        names = base_mesh.axis_names
        if "data" not in names:
            raise ValueError(f"base_mesh has no 'data' axis: {names}")
        ranks = base_mesh.ranks
        rows = ranks.shape[names.index("data")] - n_failed_hosts
        if rows < 1:
            raise ValueError("no capacity left")
        idx = [slice(None)] * ranks.ndim
        idx[names.index("data")] = slice(0, rows)
        return Mesh(ranks[tuple(idx)], names,
                    base_mesh.device if device is None else device)
    rows = (32 if multi_pod else 16) - n_failed_hosts
    if rows < 1:
        raise ValueError("no capacity left")
    return make_host_mesh((rows, 16), ("data", "model"), device=device)


# ---------------------------------------------------------------------------
# starting ranks
# ---------------------------------------------------------------------------


def rank_device(device, rank: int) -> torch.device:
    """Rank ``rank``'s device for a run on ``device``: the CPU, or card
    ``rank % device_count`` (every rank on ``cuda:0`` with one card)."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run the "
                           "ranks on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _rank_main(fn, rank, world, device, backend, init, results, args, timeout):
    """One spawned rank: join the group, run ``fn``, report to the parent."""
    try:
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        t0 = time.perf_counter()
        dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout))
        init_s = time.perf_counter() - t0
        out = fn(rank, world, dev, *args)
        # by value: a tensor put on the queue as is would travel as a
        # shared-memory handle that dies with this process
        results.put((rank, True, pickle.dumps((out, init_s))))
    except Exception:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class RankError(RuntimeError):
    """A rank of ``run_ranks`` raised, died or overran the time limit."""


def run_ranks(fn: Callable, world: int, *, device="cuda", backend: str = "gloo",
              timeout: float = 600.0, args: tuple = (), stats: Optional[dict] = None) -> List:
    """Run ``fn(rank, world, device, *args)`` in ``world`` spawned
    processes joined in one process group (``backend`` over a file-based
    rendezvous in a fresh temporary directory) and return each rank's
    result, in rank order. ``fn`` and ``args`` must pickle (``fn`` a
    module-level function), and so must the results, which travel by
    value (keep them on the host).

    Every rank runs on ``rank_device(device, rank)``. With ``stats`` (a
    dict), each rank's seconds in ``init_process_group`` go to
    ``stats["init_seconds"]``, in rank order. The first rank to fail, die
    or leave the
    time limit (``timeout`` seconds for the whole run) ends the run: every
    rank still alive is stopped and ``RankError`` raised with that rank's
    traceback. Every process started is joined before the call returns."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="rimc_ranks_")
    init = "file://" + os.path.join(tmp, "rendezvous")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                         args=(fn, r, world, device, backend, init, results, args, timeout))
             for r in range(world)]
    deadline = time.monotonic() + timeout
    got: Dict[int, tuple] = {}
    error = None
    try:
        for p in procs:
            p.start()
        while len(got) < world and error is None:
            try:
                rank, ok, payload = results.get(timeout=0.2)
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    error = f"rank {dead[0]} died with exit code {procs[dead[0]].exitcode}"
                elif time.monotonic() > deadline:
                    left = [r for r in range(world) if r not in got]
                    error = f"ranks {left} still running after {timeout} s"
                continue
            if ok:
                got[rank] = pickle.loads(payload)
            else:
                error = f"rank {rank} raised:\n{payload}"
        if error is None:
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
                if p.is_alive():
                    error = f"{p.name} did not exit after its result"
                    break
                if p.exitcode != 0:
                    error = f"{p.name} exited with code {p.exitcode}"
                    break
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if error is not None:
        raise RankError(error)
    if stats is not None:
        stats["init_seconds"] = [got[r][1] for r in range(world)]
    return [got[r][0] for r in range(world)]

