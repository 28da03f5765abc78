"""Shared by the benchmark's tests: each cell shrunk to a size the CPU
runs in seconds, in float64, with the harness's device check skipped."""

from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SMALL = {
    "bundled8k_fit": {"config": {"n": 300, "dtype": "float64"},
                      "traffic": {"heldout": 30, "pool": 2,
                                  "profile_evals": 6}},
    "bundled8k_bo": {"config": {"n": 100, "dtype": "float64", "bucket": 16},
                     "traffic": {"steps": 12, "candidates": 16,
                                 "judge_steps": 4}},
    "stream51k_predict": {"config": {"n": 1000, "dtype": "float64"},
                          "traffic": {"rows": 40}},
}

# the stream cell's rows sit above this in the shrunk cell, so that its
# posterior is the factor-free one, as at N = 51200
STREAM_MIN_N = 64


def small(workload: str) -> dict:
    return {k: dict(v) for k, v in SMALL[workload].items()}
