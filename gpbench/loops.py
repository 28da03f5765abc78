"""The general traffic generator: one loop per traffic kind, driven by the
parameters of a traffic file (traffic/<mix>.json, its "kind" picks the
loop) and the sizes of a configuration file (configs/<config>.json).

Every input comes from the run's --seed through numpy streams keyed
(seed, tag, index...), so the same seed gives the same inputs on any
device.  Each loop:

  setup()      builds what the cell serves from and warms up the shapes
               its window uses (and no others);
  window()     runs units of work back to back (one closed-loop client)
               until --seconds have passed, closing at the end of the
               unit that crosses it: fills run.window_s, run.units,
               run.unit_s (each unit's latency), run.answers and the
               counters;
  profile(seg) runs a bounded piece of the same work under the profiler
               (trace.Segment), after the window;
  judge()      compares the window's answers with the plain reference of
               the configuration's model family (judge.py).
"""

from __future__ import annotations

import time

import numpy as np

from . import judge
from .synth import make_data, uniform_rows

# stream tags, and the two streams of an episode
DATA, FIT, QUERY, EPISODE, SAMPLE, WARM, PROFILE, FRESH = range(8)
POOL, CAND = range(2)


def stream(run, *idx):
    return (run.seed & (2 ** 64 - 1), *idx)


class _Loop:
    def __init__(self, run, prog):
        self.run, self.prog = run, prog
        self.cfg, self.tr = run.config, run.traffic
        self.n, self.d = self.cfg["n"], self.cfg["d"]

    def _over(self, t0) -> bool:
        return time.perf_counter() - t0 >= self.run.seconds

    def close(self):
        self.prog.close()

    def reference(self):
        """The plain reference of the run's model family."""
        return self.run.family.Reference(self.cfg)


class FitLoop(_Loop):
    """Back-to-back fits: the family's model of (X, y) (GP in the exact
    family), train() from the library's start, then the held-out rows'
    mean and variance.  The data sets are a fixed pool of `pool` (drawn
    from `pool_seed`), fitted in passes, each pass in an order drawn from
    --seed; the window closes at the end of the pass that crosses
    --seconds.  A fit's work (its evaluations) depends on its data, so
    every seed gets the same set of fits, in another order.
    After the window, untimed, one more fit of a data set drawn from
    --seed itself, so that the judged answers differ from seed to seed."""

    def data(self, j, tag=FIT):
        m = self.tr["heldout"]
        key = (stream(self.run, tag, j) if tag != FIT
               else (self.tr["pool_seed"], FIT, j))
        X, y = make_data(self.n + m, self.d, key)
        return X[:self.n], y[:self.n], X[self.n:]

    def _fit(self, tag, j) -> None:
        run = self.run
        run.attempted += 1
        try:
            ans = self.prog.fit(*self.data(j, tag))
        except RuntimeError as exc:  # a fit the program could not end
            run.failed += 1
            run.log(f"fit {tag, j} failed: {exc}")
            return
        run.answers.append(((tag, j), ans))
        if tag == FIT:
            run.counters["evals"].append(ans["evals"])

    def order(self, p):
        rng = np.random.default_rng(stream(self.run, FIT, p))
        return rng.permutation(self.tr["pool"])

    def setup(self):
        self.prog.fit(*self.data(0, WARM), max_evals=self.tr["warm_evals"])

    def window(self):
        run, t0, p, fits = self.run, time.perf_counter(), 0, 0
        while not (p and self._over(t0)):
            for j in self.order(p):
                t = time.perf_counter()
                self._fit(FIT, int(j))
                run.unit_s.append(time.perf_counter() - t)
                fits += 1
            p += 1
        run.window_s = time.perf_counter() - t0
        run.units = fits
        self._fit(FRESH, 0)

    def profile(self, seg):
        """train() of the window's first fit, capped at profile_evals
        evaluations, profiled whole."""
        ans = self.prog.fit(*self.data(int(self.order(0)[0])),
                            max_evals=self.tr["profile_evals"], segment=seg)
        self.run.counters["profile_evals"].append(ans["evals"])

    def judge(self, device):
        return judge.fit(self.reference(), self.run.answers,
                         lambda key: self.data(key[1], key[0]), device)


class PredictLoop(_Loop):
    """A posterior at the configuration's hyperparameters, then back-to-back
    requests for the mean and variance at fresh rows."""

    def setup(self):
        X, y = make_data(self.n, self.d, stream(self.run, DATA, 0))
        self.prog.serve_setup(X, y, self.cfg["hyp"])
        self.prog.serve_predict(self.query(WARM, 0))

    def query(self, tag, i):
        return uniform_rows(self.tr["rows"], self.d, stream(self.run, tag, i))

    def window(self):
        run, t0, i = self.run, time.perf_counter(), 0
        while True:
            q = self.query(QUERY, i)
            t = time.perf_counter()
            run.answers.append((i, self.prog.serve_predict(q)))
            run.unit_s.append(time.perf_counter() - t)
            i += 1
            if self._over(t0):
                break
        run.window_s = time.perf_counter() - t0
        run.units = run.attempted = i

    def profile(self, seg):
        q = self.query(PROFILE, 0)
        seg.start()
        self.prog.serve_predict(q)
        seg.stop()

    def judge(self, device):
        X, y = make_data(self.n, self.d, stream(self.run, DATA, 0))
        return judge.predict(self.reference(), self.run.answers, X, y,
                             self.cfg["hyp"], lambda i: self.query(QUERY, i),
                             device)


class BoLoop(_Loop):
    """Episodes of a BO loop at the configuration's hyperparameters.  An
    episode rebuilds the model (BucketedGP in the exact family) at the
    set-up rows (its first step), then runs `steps` steps: the mean,
    variance and their input gradients at `candidates` rows, read back,
    then absorb() of the step's pool row.
    The pool rows do not depend on the answers, so every run of a seed
    serves the same traffic."""

    def setup(self):
        self.X0, self.y0 = make_data(self.n, self.d,
                                     stream(self.run, DATA, 0))
        # one whole episode: every row count the window's steps meet
        px, py, C = self.episode(WARM, 0)
        self._build()
        for p in range(self.tr["steps"]):
            self.prog.bo_acquire(C[p])
            self.prog.bo_absorb(px[p], py[p])

    def _build(self):
        self.prog.bo_build(self.X0, self.y0, self.cfg["hyp"])

    def episode(self, tag, e):
        s, c = self.tr["steps"], self.tr["candidates"]
        px, py = make_data(s, self.d, stream(self.run, tag, e, POOL))
        C = uniform_rows(s * c, self.d, stream(self.run, tag, e, CAND))
        return px, py, self.prog.candidates(C.reshape(s, c, self.d))

    def window(self):
        run = self.run
        t0, e, steps, done = time.perf_counter(), 0, 0, False
        self.answered = {}
        while not done:
            px, py, C = self.episode(EPISODE, e)
            t = time.perf_counter()
            self._build()
            run.unit_s.append(time.perf_counter() - t)
            steps += 1
            done = self._over(t0)
            for p in range(0 if done else self.tr["steps"]):
                t = time.perf_counter()
                try:
                    got = self.prog.bo_acquire(C[p])
                    self.prog.bo_absorb(px[p], py[p])
                except RuntimeError as exc:
                    run.failed += 1
                    run.log(f"episode {e} step {p} failed: {exc}")
                    got = None
                run.unit_s.append(time.perf_counter() - t)
                steps += 1
                if got is not None:
                    self.answered[(e, p)] = got
                if self._over(t0) or got is None:
                    done = self._over(t0)
                    break
            e += 1
        run.window_s = time.perf_counter() - t0
        run.units = run.attempted = steps

    def profile(self, seg):
        px, py, C = self.episode(PROFILE, 0)
        seg.start()
        self._build()
        for p in range(self.tr["steps"]):
            self.prog.bo_acquire(C[p])
            self.prog.bo_absorb(px[p], py[p])
        seg.stop()

    def sample(self):
        """The steps judged: the one with the most absorbed rows, then up
        to judge_steps - 1 more drawn from the seed."""
        keys = sorted(self.answered, key=lambda k: (k[1], -k[0]))
        if not keys:
            return []
        rng = np.random.default_rng(stream(self.run, SAMPLE))
        rest = keys[:-1]
        k = min(len(rest), self.tr["judge_steps"] - 1)
        picks = [rest[j] for j in rng.choice(len(rest), k, replace=False)]
        return [keys[-1], *sorted(picks)]

    def judge(self, device):
        s, c = self.tr["steps"], self.tr["candidates"]

        def rows(e, p):
            px, py = make_data(s, self.d, stream(self.run, EPISODE, e, POOL))
            return (np.concatenate([self.X0, px[:p]]),
                    np.concatenate([self.y0, py[:p]]))

        def cands(e, p):
            C = uniform_rows(s * c, self.d, stream(self.run, EPISODE, e, CAND))
            return C.reshape(s, c, self.d)[p]

        self.run.answers = [(k, self.answered[k]) for k in self.sample()]
        return judge.bo(self.reference(), self.run.answers, rows, cands,
                        self.cfg["hyp"], device)


KINDS = {"fit": FitLoop, "predict": PredictLoop, "bo": BoLoop}
