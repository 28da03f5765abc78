"""gpbench: the benchmark of gp_tpu_torch on the H100 (see README.md)."""
