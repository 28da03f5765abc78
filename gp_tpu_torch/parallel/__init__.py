"""The distributed layer (counterpart of gp_tpu/parallel/), one process per
device under torch.distributed (NCCL on CUDA cards, gloo on the CPU):

  mesh         meshes of processes ("rows", "starts"), and `spawn`, a
               launcher for one host
  pchol        block-cyclic distributed Cholesky, TRSM, logdet, inverse
  pgp          distributed exact GP: NLL and analytic gradient, fit,
               posterior, predictions (with input gradients), the 2-D
               multi-start
  psparse      data-sharded FITC / VFE
  pmultistart  restart populations spread over processes

Not ported yet (ROADMAP module 14, part 2): pchol2d (the 2-D grid) and
multihost (what of it a process group spanning hosts still needs).
"""
