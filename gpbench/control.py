"""The control and the readings that the limits of cells/<cell>.json are
set from.

`Control` is the reference of the configuration's model family
(families/<family>.py Reference) put in the program's place, one
precision below the float32 (TF32 off) that the configurations state:
float32 storage with every matrix product's operands rounded to TF32
(prec="tf32").  It answers the same calls as program.Port.  A fit it
cannot run (the reference has no optimizer): it takes the point at which
the program's fit of the same data ended and answers there (the NLL,
gradient and predictions at that point are what the fit cell judges).
Where the control's factor fails it raises the noise as the library's
posterior does, so that it still gives numbers.

The planted faults that the limits are held against: `Capped`, every
fit stopped at CAPPED_EVALS evaluations (a quarter of the library's
160), `steepest_descent`, the optimizer's L-BFGS direction replaced by
the negative gradient, and `Frozen`, a BO step's absorb() left out.

    python3 -m gpbench.control --workload <cell> --seconds <s> \\
        --seeds 1,2,... [--control-seeds 7,8,9] \\
        [--fault capped:4,5,6 --fault steepest:4,5,6 --fault frozen:4] \\
        [--override '{"traffic": {"pool": 1}}']

runs the cell once per seed with the program, then once per control seed
with the control, then once per seed of each fault, all in one process
and at the cell's own sizes (`--override` merges into the configuration's
and the traffic's values), and prints one JSON line per run: {"who",
"seed", "correct", "checks"}.  The benchmark's own runs never run the
control or a fault.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .program import NO_SPANS, Port, _np

TF32 = "tf32"


class Control:
    def __init__(self, family, config: dict, device, spans=NO_SPANS):
        self.family, self.config = family, config
        self.device = torch.device(device)
        self.ref = family.Reference(config)
        self.port = None
        self.model = None

    def _t(self, a):
        return torch.as_tensor(np.asarray(a, np.float64),
                               dtype=torch.float32, device=self.device)

    def close(self):
        self.model = None
        if self.port is not None:
            self.port.close()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def fit(self, X, y, Xte, max_evals=None, segment=None) -> dict:
        if self.port is None:
            self.port = Port(self.family, {**self.config, "dtype": "float32"},
                             self.device)
        ans = self.port.fit(X, y, Xte, max_evals=max_evals)
        ref, x, yv = self.ref, self._t(X), self._t(y)
        post = ref.posterior(x, yv, self._t(ans["hyp"]), TF32)
        mu, s2 = ref.predict(post, self._t(Xte), TF32)
        h = post.hyp
        del post
        ys, _, _ = ref.standardized(yv)
        _, g = ref.nll_grad(x, ys, self._t(ans["x"]), TF32)
        return {**ans, "nll": ref.nll(x, yv, h, TF32), "hyp": _np(h),
                "g": _np(g), "mu": _np(mu), "s2": _np(s2)}

    def serve_setup(self, X, y, hyp) -> None:
        self.model = self.ref.posterior(self._t(X), self._t(y),
                                        self._t(hyp), TF32)

    def serve_predict(self, Xq):
        mu, s2 = self.ref.predict(self.model, self._t(Xq), TF32)
        return _np(mu), _np(s2)

    def bo_build(self, X, y, hyp) -> None:
        self.rows, self.ys, self.hyp = [X], [y], self._t(hyp)

    def bo_acquire(self, C):
        x = self._t(np.concatenate(self.rows))
        y = self._t(np.concatenate(self.ys))
        post = self.ref.posterior(x, y, self.hyp, TF32)
        return tuple(_np(t) for t in
                     self.ref.predict_with_grad(post, C, TF32))

    def bo_absorb(self, x, y) -> None:
        self.rows.append(np.asarray(x, np.float64).reshape(1, -1))
        self.ys.append(np.asarray([y], np.float64))

    def candidates(self, C: np.ndarray):
        return self._t(C)


CAPPED_EVALS = 40


class Capped(Port):
    """A planted fault: every fit stopped at CAPPED_EVALS evaluations."""

    def fit(self, X, y, Xte, max_evals=None, segment=None) -> dict:
        return super().fit(X, y, Xte, CAPPED_EVALS, segment)


@contextlib.contextmanager
def steepest_descent():
    """A planted fault: the optimizer steps along -g, its two-loop
    recursion left out."""
    from gp_tpu_torch.optim import lbfgsb
    orig = lbfgsb._two_loop
    lbfgsb._two_loop = lambda st: -st.g
    try:
        yield
    finally:
        lbfgsb._two_loop = orig


class Frozen(Port):
    """A planted fault of the BO cell: absorb() leaves the model as it
    was."""

    def bo_absorb(self, x, y) -> None:
        pass


FAULTS = {"capped": (Capped, contextlib.nullcontext),
          "steepest": (Port, steepest_descent),
          "frozen": (Frozen, contextlib.nullcontext)}


def main(argv=None) -> int:
    from . import harness

    p = argparse.ArgumentParser(prog="gpbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", action="append", default=[])
    p.add_argument("--override", default="{}")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("gpbench.control: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)
    root = Path(__file__).resolve().parent.parent
    plain = contextlib.nullcontext
    runs = [("program", s, Port, plain) for s in a.seeds.split(",") if s]
    runs += [("control", s, Control, plain)
             for s in a.control_seeds.split(",") if s]
    for spec in a.fault:
        name, seeds = spec.split(":")
        runs += [(name, s, *FAULTS[name]) for s in seeds.split(",") if s]
    overrides = json.loads(a.override)
    for who, seed, prog, planted in runs:
        t0 = time.perf_counter()
        with planted():
            line = harness.run(root, a.workload, int(seed), a.seconds,
                               False, "cuda", program=prog,
                               overrides=overrides)
        print(json.dumps({"who": who, "seed": int(seed),
                          "correct": line["correct"],
                          "attempted": line["attempted"],
                          "seconds": time.perf_counter() - t0,
                          "metrics": line["metrics"],
                          "checks": line["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
