"""The chip's peaks and the operation and byte counts the per-layer
metrics divide by.  se_bound_ms and chol_bound_ms are copies of
chip_smoke.py's, kept here so that the yardstick cannot move with the
program.

H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): HBM3
3.35 TB/s; float32 67 TFLOP/s outside the tensor cores (their TF32 is
not the same work: it rounds the operands); float64 67 TFLOP/s on the
tensor cores (DMMA), whose products are exact IEEE float64 FMAs.
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}

# operations per output entry beside the cross term, each sqrt, log1p and
# exp counted as one: expansion and clamp (3), then the map
MAP_OPS = {"se": 2, "m52": 10, "m32": 7, "rq": 6}


def se_bound_ms(m: int, n: int, d: int, dtype: str, symmetric: bool,
                form: str = "se"):
    """Least time of one build: each input read once, the output written
    once; 2 m n d flops of cross term, 2 (m + n) d of norms, and per
    output 3 for the expansion and clamp plus MAP_OPS[form] for the map
    (SE: scale, exp).  Returns (ms, "bytes" | "operations")."""
    size = 4 if dtype == "float32" else 8
    rows_in = m if symmetric else m + n
    nbytes = size * (rows_in * d + m * n + 1 + (form == "rq")
                     + (m if symmetric else 0))
    flops = 2 * m * n * d + 2 * rows_in * d + (3 + MAP_OPS[form]) * m * n
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def chol_bound_ms(b: int, dtype: str, inverse: bool):
    """Least time of one b x b block Cholesky (K4, K5): b^3 / 3 flops, as
    much again for the inverse (K3); L (and L^-1) written once, and the
    block's lower triangle read once."""
    size = 4 if dtype == "float32" else 8
    flops = (2 if inverse else 1) * b ** 3 / 3
    nbytes = size * (b * (b + 1) // 2 + (2 if inverse else 1) * b * b)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def fit_eval_flops(n: int, d: int) -> float:
    """Model operations of one SE-ARD NLL + gradient evaluation: the
    Cholesky factor (n^3 / 3), the inverse from it (2 n^3 / 3), the K
    build (2 n^2 d cross term, 5 per entry), and the gradient contraction
    against K and K^-1 (two (n, n) x (n, d + 1) products, 4 n^2 (d + 1)).
    Counted at n, not at the blocked route's padded size."""
    return n ** 3 + (2 * d + 5) * n ** 2 + 4 * n ** 2 * (d + 1)


def predict_request_flops(n: int, d: int, m: int, refactors: bool) -> float:
    """Model operations of one mean-and-variance prediction of m rows:
    the (m, n) cross covariance, the mean's matvec and one triangular
    solve of the m columns (n^2 m); where the posterior caches no factor
    (`refactors`), also the K build and its Cholesky factor (n^3 / 3)."""
    head = n ** 3 / 3 + (2 * d + 5) * n ** 2 if refactors else 0
    return head + (2 * d + 5) * m * n + 2 * m * n + n ** 2 * m
