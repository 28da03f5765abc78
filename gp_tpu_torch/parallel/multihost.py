"""Jobs of processes on several hosts (counterpart of
gp_tpu/parallel/multihost.py:38-430).

Every process of a job holds one device, and every process runs the same
program (the port's distributed layer is written so from the start), so
of gp_tpu's module only the start of the job and the meshes over it are
left:

  initialize       torch.distributed.init_process_group from the
                   environment torchrun sets (env://: MASTER_ADDR,
                   MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK), each
                   process on its card LOCAL_RANK; NCCL on CUDA, gloo on
                   the CPU
  is_multiprocess  more than one process in the job
  global_mesh      the 1-D "rows" mesh over the job (mesh.make_mesh)
  global_mesh_2d   the ("rowg", "colg") grid with each host on its own
                   grid row: Pr = hosts, Pc = processes per host
                   (LOCAL_WORLD_SIZE), so that only the column exchange
                   crosses hosts, which is the point of the layout
                   (gp_tpu multihost.py:73-89)

The entry points gp_tpu wraps here (pnll_vg, pfit, pset_k, ppredict*,
and their grid twins) are the functions of parallel/pgp.py and
parallel/pchol2d.py themselves, exported under gp_tpu's names: each
process passes the same x, y and hyps, and each holds its own shards.

Not carried: `replicate` (gp_tpu converts host-local arrays to global
replicated jax arrays; here each process holds its own tensors and there
is no global array), the hosted fits `pfit_hosted` / `pfit2d` /
`lbfgsb_hosted` (a split for XLA:TPU's execution watchdog; the port's
optimizer always runs on the host, one distributed evaluation a step),
and `check_shard_addressable` (XLA:TPU's int32 bound).
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

from .mesh import make_mesh, make_mesh_grid
from .pchol2d import (pfit2d, pnll_vg2d, ppredict2d, ppredict2d_with_grad,
                      pset_k2d)
from .pgp import pfit, pnll_vg, ppredict, ppredict_with_grad, pset_k

__all__ = ["initialize", "is_multiprocess", "global_mesh", "global_mesh_2d",
           "pnll_vg", "pfit", "pset_k", "ppredict", "ppredict_with_grad",
           "pnll_vg2d", "pfit2d", "pset_k2d", "ppredict2d",
           "ppredict2d_with_grad"]


def initialize(backend: str | None = None,
               timeout: float = 1800.0) -> None:
    """Join the job torchrun started (env://); call it first in every
    process.  NCCL when CUDA is available (the process on card
    LOCAL_RANK), else gloo."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend, init_method="env://",
                            timeout=timedelta(seconds=timeout))


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def global_mesh(n_devices: int | None = None, axis_name: str = "rows"):
    """1-D mesh over the job's processes (all of them by default)."""
    return make_mesh(n_devices, axis_name=axis_name)


def global_mesh_2d(pr: int | None = None, pc: int | None = None):
    """("rowg", "colg") grid over the job.  By default Pr = the number of
    hosts and Pc = the processes per host (LOCAL_WORLD_SIZE, all of the
    job's when unset): torchrun numbers a host's processes consecutively,
    so each host is one grid row and the row broadcasts stay on it."""
    world = dist.get_world_size()
    if pc is None:
        pc = (world // pr if pr is not None
              else int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    if pr is None:
        pr = world // pc
    return make_mesh_grid(pr, pc)
