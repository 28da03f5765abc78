"""Device meshes over torch.distributed (counterpart of
gp_tpu/parallel/mesh.py:22-46).

gp_tpu's parallel layer runs as per-device code inside jax.shard_map over
a jax.sharding.Mesh.  Here each device is one process of a
torch.distributed group, and every process runs the same program (gp_tpu's
multi-process mode, parallel/multihost.py): NCCL between CUDA cards, gloo
on the CPU.  A Mesh names its axes as gp_tpu's do:

  "rows"    block-rows of the N x N kernel matrix (parallel/pchol.py);
  "starts"  hyperparameter restarts (parallel/pgp.pfit_multistart);
  "rowg", "colg"  the 2-D block grid (parallel/pchol2d.py): "rowg" runs
            down a grid column, "colg" along a grid row.

`mesh.shape[axis]` is the axis' size and `mesh.axis(name)` this process's
handle on it (its group, its index along the axis and the group's global
ranks), what a shard_map body reads through axis_name.  `mesh.whole` is
the handle on all of the mesh's processes at once (the group of a
reduction over every axis, and of a broadcast from one process to all).

Starting the processes: under torchrun (env://) call
torch.distributed.init_process_group("nccl" or "gloo") in each process
(parallel.multihost.initialize does), then make_mesh() or
make_mesh_grid(pr, pc); or let `spawn(fn, world_size, device)` start
world_size processes on this host, each running fn(mesh, *args) on the
1-D mesh (a grid program builds its grid inside fn).

Not carried: `replicated` and `row_sharded` (NamedSharding placements: a
process holds its own shard, there is no global array to place).
"""

from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback
from datetime import timedelta
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist


class Axis(NamedTuple):
    """This process's handle on one mesh axis."""
    name: str
    group: object           # the ProcessGroup of this process's slice
    size: int
    index: int              # this process's position along the axis
    ranks: tuple            # the group's global ranks, in axis order


class Mesh:
    """A 1-D or 2-D grid of processes, one device each.  `whole` is the
    handle on all of its processes (a 1-D mesh's one axis)."""

    def __init__(self, axes: list, device: torch.device,
                 whole: Axis | None = None):
        self.axes = {a.name: a for a in axes}
        self.axis_names = tuple(a.name for a in axes)
        self.shape = {a.name: a.size for a in axes}
        self.device = device
        self.whole = axes[0] if whole is None else whole

    def axis(self, name: str) -> Axis:
        try:
            return self.axes[name]
        except KeyError:
            raise ValueError(f"mesh has axes {self.axis_names}, not "
                             f"{name!r}") from None


def _require_init() -> None:
    if not dist.is_initialized():
        raise RuntimeError(
            "torch.distributed is not initialized: start one process per "
            "device (torchrun --nproc-per-node=P script.py, then "
            "torch.distributed.init_process_group('nccl' or 'gloo') in "
            "each), or run the program through "
            "gp_tpu_torch.parallel.mesh.spawn(fn, P, device)")


def _rank_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(n_devices: int | None = None,
              axis_name: str = "rows") -> Mesh:
    """1-D mesh over the first n_devices processes of the default group
    (all of them by default).  Every process of the default group calls
    it; one outside the first n_devices gets a ValueError."""
    _require_init()
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"n_devices={n} with {world} processes")
    ranks = tuple(range(n))
    group = dist.group.WORLD if n == world else dist.new_group(list(ranks))
    if rank >= n:
        raise ValueError(f"process {rank} is not in a mesh of the first "
                         f"{n} processes")
    return Mesh([Axis(axis_name, group, n, rank, ranks)], _rank_device())


def make_mesh_2d(n_starts: int, n_rows: int) -> Mesh:
    """2-D ("starts", "rows") mesh: process r sits at (r // n_rows,
    r % n_rows).  Every process creates every group, in the same order, as
    torch.distributed.new_group requires."""
    _require_init()
    rank = dist.get_rank()
    if n_starts * n_rows > dist.get_world_size():
        raise ValueError(f"a ({n_starts}, {n_rows}) mesh needs "
                         f"{n_starts * n_rows} processes, have "
                         f"{dist.get_world_size()}")
    grid = np.arange(n_starts * n_rows).reshape(n_starts, n_rows)
    row_groups = [dist.new_group(grid[s].tolist()) for s in range(n_starts)]
    start_groups = [dist.new_group(grid[:, q].tolist())
                    for q in range(n_rows)]
    if rank >= grid.size:
        raise ValueError(f"process {rank} is not in the "
                         f"({n_starts}, {n_rows}) mesh")
    s, q = divmod(rank, n_rows)
    return Mesh([Axis("starts", start_groups[q], n_starts, s,
                      tuple(grid[:, q].tolist())),
                 Axis("rows", row_groups[s], n_rows, q,
                      tuple(grid[s].tolist()))], _rank_device(),
                _whole(grid.size, rank))


def _whole(n: int, rank: int) -> Axis:
    """The axis over the first n processes; made by every process (a
    group of the first n is a new_group call on each), its handle valid
    on the first n."""
    group = (dist.group.WORLD if n == dist.get_world_size()
             else dist.new_group(list(range(n))))
    return Axis("whole", group, n, rank, tuple(range(n)))


def make_mesh_grid(pr: int, pc: int) -> Mesh:
    """2-D ("rowg", "colg") grid of pr x pc processes, gp_tpu's
    Mesh(devs.reshape(pr, pc), ("rowg", "colg")): process r sits at
    (r // pc, r % pc).  Its "colg" axis is its grid row (ranks r pc ...
    r pc + pc - 1, index its column), its "rowg" axis its grid column
    (index its row).  Every process of the default group calls it: each
    creates every row group and every column group, in the same order, as
    torch.distributed.new_group requires; one outside the first pr pc
    gets a ValueError."""
    _require_init()
    rank = dist.get_rank()
    if pr < 1 or pc < 1 or pr * pc > dist.get_world_size():
        raise ValueError(f"a ({pr}, {pc}) grid needs {pr * pc} processes, "
                         f"have {dist.get_world_size()}")
    grid = np.arange(pr * pc).reshape(pr, pc)
    row_groups = [dist.new_group(grid[r].tolist()) for r in range(pr)]
    col_groups = [dist.new_group(grid[:, c].tolist()) for c in range(pc)]
    whole = _whole(grid.size, rank)
    if rank >= grid.size:
        raise ValueError(f"process {rank} is not in the ({pr}, {pc}) grid")
    r, c = divmod(rank, pc)
    return Mesh([Axis("rowg", col_groups[c], pr, r,
                      tuple(grid[:, c].tolist())),
                 Axis("colg", row_groups[r], pc, c,
                      tuple(grid[r].tolist()))], _rank_device(), whole)


# --------------------------------------------------------------------------
# A launcher for one host
# --------------------------------------------------------------------------

def _rank_main(fn, rank, world_size, device, init_file, timeout, args, out):
    try:
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        else:
            # one thread a process: P processes on one host, each of which
            # would otherwise start a thread per core
            torch.set_num_threads(1)
        dist.init_process_group(
            "nccl" if device == "cuda" else "gloo",
            init_method=f"file://{init_file}", world_size=world_size,
            rank=rank, timeout=timedelta(seconds=timeout))
        try:
            result = fn(make_mesh(), *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))


def spawn(fn, world_size: int, device: str = "cpu", timeout: float = 300.0,
          args: tuple = ()) -> list:
    """Run fn(mesh, *args) in world_size new processes (start method
    "spawn") on a 1-D "rows" mesh of all of them, NCCL with one card each
    (device="cuda"; process r on card r) or gloo on the CPU (one thread
    each).  They meet
    through a FileStore in a temporary directory (no ports).  Returns the
    processes' return values in rank order (they must pickle: numpy arrays
    and Python scalars).  A process's exception is raised here as a
    RuntimeError naming its rank, with its traceback; past `timeout`
    seconds (the collectives' timeout too) the processes are killed and
    TimeoutError is raised.  fn must be importable by name (a module-level
    function)."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="gp_tpu_torch_spawn_") as tmp:
        init_file = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world_size, device, init_file,
                                   timeout, args, out))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        results, deadline = {}, time.monotonic() + timeout
        try:
            while len(results) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    late = sorted(set(range(world_size)) - set(results))
                    raise TimeoutError(f"spawn: ranks {late} did not finish "
                                       f"within {timeout:.0f} s")
                try:
                    rank, ok, value = out.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode is not None and r not in results]
                    if dead:
                        # a result may still be in flight: one last look
                        try:
                            rank, ok, value = out.get(timeout=5.0)
                        except queue.Empty:
                            raise RuntimeError(
                                f"spawn: rank {dead[0]} exited with code "
                                f"{procs[dead[0]].exitcode} and no "
                                f"result") from None
                    else:
                        continue
                if not ok:
                    raise RuntimeError(f"spawn: rank {rank} failed:\n{value}")
                results[rank] = value
        finally:
            for p in procs:
                p.join(timeout=10)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    return [results[r] for r in range(world_size)]
