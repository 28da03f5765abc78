"""The distributed layer (counterpart of gp_tpu/parallel/), one process per
device under torch.distributed (NCCL on CUDA cards, gloo on the CPU):

  mesh         meshes of processes ("rows", "starts", the ("rowg",
               "colg") grid), and `spawn`, a launcher for one host
  multihost    a job of processes on several hosts (torchrun's env://)
               and its meshes
  pchol        block-cyclic distributed Cholesky, TRSM, logdet, inverse
  pchol2d      the 2-D block-cyclic grid: Cholesky, solves, L^-1, the
               SUMMA K^-1, and the exact GP on it (fit, posterior,
               predictions)
  pgp          distributed exact GP: NLL and analytic gradient, fit,
               posterior, predictions (with input gradients), the 2-D
               multi-start
  psparse      data-sharded FITC / VFE
  pmultistart  restart populations spread over processes
"""
