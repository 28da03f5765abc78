"""The plain reference (reference/gp.py) that judges the port: plain
PyTorch, no import of the program, of gp_tpu or of JAX."""
