"""The comparison that decides `correct`: each traffic kind's answers,
taken from the timed window, against the plain reference of the
configuration's model family (`ref`, families/<family>.py Reference: for
the exact family reference/gp.py) in float64 on the same inputs,
regenerated from the seed.  Nothing here depends on the family.

Every number is a gap where lower is better, held to `value <= limit`
(the cell's limits, cells/<cell>.json); each function returns
{name: worst value over the answers compared}:

  nll    |NLL - NLL_ref| / |NLL_ref| at the hyperparameters a fit returned
  grad   max |g - g_ref| / N: the optimizer's last gradient, in its
         standardized units, against the reference's at the same point
  stall  (NLL_ref(returned) - NLL_ref(start)) / N: a fit that did not
         descend from the library's start reads 0 or more
  pgrad  the reference's gradient of NLL / N at the point the fit
         returned, in the optimizer's standardized units, projected onto
         the library's box (ref.projected_gradient): how far from
         a stationary point the fit stopped
  mu, s2, dmu, ds2
         max |a - a_ref| / max |a_ref| of the posterior mean, variance and
         their input gradients over the rows or candidates of an answer
"""

from __future__ import annotations

import numpy as np
import torch

F64 = "float64"


def _t(a, device):
    return torch.as_tensor(np.asarray(a, np.float64), dtype=torch.float64,
                           device=device)


def rel_gap(a, b) -> float:
    b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else b
    scale = np.max(np.abs(b))
    return float(np.max(np.abs(np.asarray(a) - b)) / scale)


def _worst(acc: dict, nums: dict) -> None:
    for k, v in nums.items():
        v = float(v)
        if np.isnan(v):
            v = float("inf")
        acc[k] = max(acc.get(k, -np.inf), v)


def fit(ref, answers, data, device) -> dict:
    """answers: [(key, answer)]; data(key) -> (X, y, Xte) of that fit."""
    acc = {}
    for key, ans in answers:
        X, y, Xte = data(key)
        x, yv = _t(X, device), _t(y, device)
        n = x.shape[0]
        h = _t(ans["hyp"], device)
        nll_ref = ref.nll(x, yv, h, F64)
        post = ref.posterior(x, yv, h, F64)
        mu, s2 = ref.predict(post, _t(Xte, device), F64)
        del post
        ys, y_mu, y_sigma = ref.standardized(yv)
        v = _t(ans["x"], device)
        _, g = ref.nll_grad(x, ys, v, F64)
        g = g.cpu()
        lb, ub = (ref.to_standardized(b, y_mu, y_sigma)
                  for b in ref.hyp_bounds(x, yv))
        start = ref.nll(x, yv, ref.default_hyp(x, yv), F64)
        _worst(acc, {
            "nll": abs(ans["nll"] - nll_ref) / abs(nll_ref),
            "grad": np.max(np.abs(ans["g"] - g.numpy())) / n,
            "stall": (nll_ref - start) / n,
            "pgrad": ref.projected_gradient(v.cpu(), g / n, lb, ub),
            "mu": rel_gap(ans["mu"], mu), "s2": rel_gap(ans["s2"], s2)})
    return acc


def predict(ref, answers, X, y, hyp, query, device) -> dict:
    """answers: [(i, (mu, s2))]; query(i) -> the rows of request i."""
    x, yv, h = _t(X, device), _t(y, device), _t(hyp, device)
    post = ref.posterior(x, yv, h, F64)
    acc = {}
    for i, (mu_p, s2_p) in answers:
        mu, s2 = ref.predict(post, _t(query(i), device), F64)
        _worst(acc, {"mu": rel_gap(mu_p, mu), "s2": rel_gap(s2_p, s2)})
    return acc


def bo(ref, answers, rows, cands, hyp, device) -> dict:
    """answers: [((e, p), (mu, dmu, s2, ds2))]; rows(e, p) -> (X, y) the
    model held at step p of episode e; cands(e, p) -> its candidates."""
    h = _t(hyp, device)
    acc = {}
    for (e, p), got in answers:
        X, y = rows(e, p)
        x, yv = _t(X, device), _t(y, device)
        post = ref.posterior(x, yv, h, F64)
        want = ref.predict_with_grad(post, _t(cands(e, p), device), F64)
        _worst(acc, {k: rel_gap(a, b) for k, a, b
                     in zip(("mu", "dmu", "s2", "ds2"), got, want)})
    return acc
