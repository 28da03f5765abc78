"""The system under test, behind the three calls each traffic kind makes.

`Port` drives gp_tpu_torch through its public entry points: the model
that the configuration's family builds for each traffic kind
(families/<family>.py `model`), then its GP surface (train,
batch_predict, absorb, the *_with_grad predictions).  It and the
families' program side are the only code of the benchmark that imports
the program, and they import it on first use.  Every answer comes back
as float64 numpy on the host, so that the judge (judge.py) and the
reference never see the program's tensors.

`Spans` times a call into a layer on the host's clock, adding no
synchronization: the calls it wraps end with their results read back on
the host (in a --trace 1 run only; `NO_SPANS` else).
"""

from __future__ import annotations

import contextlib
import gc
import time
from collections import defaultdict

import numpy as np
import torch


class Spans:
    """Host-clock spans by name: `with spans("absorb"): ...`."""

    def __init__(self):
        self.seconds = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        yield
        self.seconds[name].append(time.perf_counter() - t0)


class _NoSpans:
    seconds: dict = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        yield


NO_SPANS = _NoSpans()


def _np(t) -> np.ndarray:
    return t.detach().to("cpu", torch.float64).numpy()


class Port:
    """gp_tpu_torch on `device`: the models of `family` for `config`, in
    the configuration's dtype."""

    def __init__(self, family, config: dict, device, spans=NO_SPANS):
        import gp_tpu_torch  # noqa: F401  (sets the precision policy)
        from gp_tpu_torch.ops import _build

        self.family, self.config = family, config
        self.device = torch.device(device)
        self.dtype = getattr(torch, config["dtype"])
        self.spans = spans
        self.model = None
        if self.device.type == "cuda":
            # both kernel libraries at once, into the checkout's
            # gp_tpu_torch/_build/ (a no-op once they are there)
            _build.build(("se_tile", "chol_block"))

    def close(self) -> None:
        self.model = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _model(self, kind: str, X, y):
        return self.family.model(kind, X, y, self.config, self.dtype,
                                 self.device)

    # -- a fit: train() from the defaults, then the held-out predictions --
    def fit(self, X, y, Xte, max_evals=None, segment=None) -> dict:
        """`max_evals` caps the optimizer's budget; `segment` (a
        trace.Segment) is profiled around train() alone."""
        gp = self._model("fit", X, y)
        if max_evals is not None:
            gp._MAX_EVAL = max_evals
        self.model = gp
        if segment is not None:
            segment.start()
        nll = gp.train()
        if segment is not None:
            segment.stop()
        mu, s2 = gp.batch_predict(Xte)
        res = gp.last_opt_result
        out = {"nll": float(nll), "hyp": _np(torch.as_tensor(gp.get_hyp())),
               "x": _np(res.x), "g": _np(res.g), "evals": int(res.evals),
               "mu": _np(mu), "s2": _np(s2)}
        self.model = None
        return out

    # -- serving from a posterior at fixed hyperparameters ---------------
    def serve_setup(self, X, y, hyp) -> None:
        gp = self._model("predict", X, y)
        gp.set_fixed(True)
        gp.train(init_hyps=np.asarray(hyp, np.float64))
        self.model = gp

    def serve_predict(self, Xq):
        mu, s2 = self.model.batch_predict(Xq)
        return _np(mu), _np(s2)

    # -- the BO loop: a model that absorbs, at fixed hyperparameters -----
    def bo_build(self, X, y, hyp) -> None:
        self.model = None
        bo = self._model("bo", X, y)
        bo.set_fixed(True)
        bo.train(init_hyps=np.asarray(hyp, np.float64))
        self.model = bo

    def bo_acquire(self, C):
        """Mean, variance and their input gradients at the candidates C
        (a tensor on the device), read back on the host."""
        with self.spans("acq"):
            mu, gmu = self.model.batch_predict_y_with_grad(C)
            s2, gs2 = self.model.batch_predict_s2_with_grad(C)
            return _np(mu), _np(gmu), _np(s2), _np(gs2)

    def bo_absorb(self, x, y) -> None:
        with self.spans("absorb"):
            self.model.absorb(x, y)

    def candidates(self, C: np.ndarray):
        """The candidates as the program takes them: a tensor on its
        device in its dtype (moved once per episode)."""
        return torch.as_tensor(C, dtype=self.dtype, device=self.device)
