"""CLI drivers of the reference's demo executables (counterpart of
gp_tpu/cli.py):

    python -m gp_tpu_torch gp   [num_train]                 (mygp.cpp:9-39)
    python -m gp_tpu_torch fitc [num_train [num_inducing]]  (test_fitc.cpp)
    python -m gp_tpu_torch vfe  [num_train [num_inducing]]  (test_vfe.cpp)

File contract (util.cpp:29-62, mygp.cpp:31-36): whitespace text matrices
``train_x`` (N x d), ``train_y`` (N x 1) and ``test_x`` (T x d) are read
from the working directory; ``pred`` is written with two columns,
posterior mean and posterior standard deviation.

As the reference and gp_tpu: FITC and VFE take the LAST num_inducing
training rows as inducing points (test_fitc.cpp:36, rightCols); VFE starts
from log-noise log(std(y)) (test_vfe.cpp:39); fitc and vfe print the
`test_obj` table (hyp, analytic and numeric gradient) before predicting
(test_fitc.cpp:44, test_vfe.cpp:48).

Extras, as gp_tpu's: --kernel (any of gp_tpu's twelve names), --starts K
(multi-start training), --seed.  The run is on the CUDA card; --cpu runs
on the CPU (float64).  Without --cpu and without a card the CLI fails: it
never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

KERNEL_CHOICES = ("se_ard", "se_iso", "matern52", "matern32", "rq",
                  "matern52_iso", "matern32_iso", "rq_iso", "se_ard_pallas",
                  "se_iso_pallas", "se_ard_xla", "se_iso_xla")


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="gp_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="model", required=True)
    for name in ("gp", "fitc", "vfe"):
        sp = sub.add_parser(name)
        sp.add_argument("num_train", nargs="?", type=int, default=None)
        if name != "gp":
            sp.add_argument("num_inducing", nargs="?", type=int, default=None)
        sp.add_argument("--kernel", default="se_ard", choices=KERNEL_CHOICES)
        sp.add_argument("--starts", type=int, default=0,
                        help="multi-start restarts (0 = single local fit, "
                             "the reference pipeline)")
        sp.add_argument("--cpu", action="store_true",
                        help="run on the CPU (float64) instead of the card")
        sp.add_argument("--seed", type=int, default=0)
    return p


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)

    from . import FITC, GP, VFE
    from .utils.io import read_matrix, write_pred

    device = "cpu" if args.cpu else None
    train_x = read_matrix("train_x")
    train_y = read_matrix("train_y").ravel()
    test_x = read_matrix("test_x")

    num_train = (train_x.shape[0] if args.num_train is None
                 else args.num_train)
    if num_train > train_x.shape[0]:
        print(f"Num train > {train_x.shape[0]}", file=sys.stderr)
        return 1

    X, y = train_x[:num_train], train_y[:num_train]

    if args.model == "gp":
        model = GP(X, y, kernel=args.kernel, seed=args.seed, device=device)
    else:
        cls = FITC if args.model == "fitc" else VFE
        model = cls(X, y, kernel=args.kernel, seed=args.seed, device=device)
        num_inducing = (num_train if args.num_inducing is None
                        else args.num_inducing)
        if num_inducing > train_x.shape[0]:
            print(f"Num inducing > {train_x.shape[0]}", file=sys.stderr)
            return 1
        # the reference: rightCols(num_inducing) of the FULL train matrix
        model.set_inducing(train_x[-num_inducing:])

    init = model.get_default_hyps()
    if args.model == "vfe":
        init[-2] = np.log(np.std(y, ddof=1))     # test_vfe.cpp:39

    t1 = time.perf_counter()
    if args.starts > 0:
        nlz = model.train_multistart(n_starts=args.starts, init_hyps=init)
    else:
        nlz = model.train(init)
    t2 = time.perf_counter()
    print(f"Training time: {t2 - t1:.0f} seconds")
    res = getattr(model, "last_opt_result", None)
    if res is not None:               # explain_nlopt analog (util.cpp:87-109)
        from .optim.lbfgsb import explain_result
        print(explain_result(res, max_evals=model._MAX_EVAL))
    print(f"Negative log likelihood: {nlz:.9g}")
    print("Optimized hyperparameters:")
    for v in model.get_hyp():
        print(f"{v:.9g}")

    if args.model != "gp":
        # the gradient self-check table, as the reference prints it
        # (FITC::test_obj, FITC.cpp:324-352: hyp | analytic | numeric)
        nll_chk, g, fd = model.test_obj(model.get_hyp())
        print(f"test_obj nll: {nll_chk:.9g}")
        print(f"{'hyp':>15s} {'analytic':>15s} {'numeric':>15s}")
        for h, a, b in zip(model.get_hyp(), g, fd):
            print(f"{h:15.6g} {a:15.6g} {b:15.6g}")

    t3 = time.perf_counter()
    # the predictions are tensors on the model's device: to the host here,
    # where gp_tpu writes its arrays (inside the timed region: it waits
    # for the card)
    predy = model.batch_predict_y(test_x).cpu().numpy()
    preds2 = model.batch_predict_s2(test_x).cpu().numpy()
    t4 = time.perf_counter()
    print(f"Prediction time: {t4 - t3:.6g} seconds")

    write_pred("pred", predy, np.sqrt(preds2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
