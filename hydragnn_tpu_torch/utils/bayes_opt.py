"""In-tree Bayesian optimization, the CBO the HPO search runs without
optuna (counterpart: hydragnn_tpu/utils/bayes_opt.py, held bitwise:
the same seed and the same tells give the same asks).

A numpy Gaussian-process surrogate (Matern-5/2, Cholesky solve), UCB
acquisition maximized over a random candidate sweep, and the constant
liar, so several trials can be asked before any result returns (the
reference's DeepHyper CBO, `multi_point_strategy="cl_min"`).

    opt = CBO(space, seed=42)
    params = opt.ask()            # constant liar: call repeatedly
    opt.tell(params, objective)   # lower is better by default
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


class _Encoder:
    """Maps a SearchSpace dict to/from [0, 1]^d vectors: floats
    log-uniform, ints linear, categoricals one-hot."""

    def __init__(self, space: Dict[str, Any]):
        self.space = space
        self.dims: List[Tuple[str, str, Any]] = []
        for k, v in space.items():
            if isinstance(v, list):
                self.dims.append((k, "cat", v))
            elif isinstance(v, tuple) and len(v) == 2 \
                    and all(isinstance(x, int) for x in v):
                self.dims.append((k, "int", v))
            elif isinstance(v, tuple) and len(v) == 2:
                self.dims.append((k, "float", v))
            else:
                self.dims.append((k, "const", v))
        self.d = sum(len(spec) if kind == "cat" else
                     (0 if kind == "const" else 1)
                     for _, kind, spec in self.dims)

    def encode(self, params: Dict[str, Any]) -> np.ndarray:
        x = []
        for k, kind, spec in self.dims:
            if kind == "cat":
                one = [0.0] * len(spec)
                one[spec.index(params[k])] = 1.0
                x += one
            elif kind == "int":
                lo, hi = spec
                x.append((params[k] - lo) / max(hi - lo, 1))
            elif kind == "float":
                lo, hi = spec
                if lo > 0:  # log scale for positive ranges (lr-like)
                    x.append((math.log10(params[k]) - math.log10(lo))
                             / max(math.log10(hi) - math.log10(lo), 1e-12))
                else:  # linear for ranges touching 0 or negative
                    x.append((params[k] - lo) / max(hi - lo, 1e-12))
        return np.asarray(x, np.float64)

    def sample(self, rng: np.random.RandomState) -> Dict[str, Any]:
        out = {}
        for k, kind, spec in self.dims:
            if kind == "cat":
                out[k] = spec[rng.randint(len(spec))]
            elif kind == "int":
                out[k] = int(rng.randint(spec[0], spec[1] + 1))
            elif kind == "float":
                if spec[0] > 0:
                    out[k] = float(10 ** rng.uniform(math.log10(spec[0]),
                                                     math.log10(spec[1])))
                else:
                    out[k] = float(rng.uniform(spec[0], spec[1]))
            else:
                out[k] = spec
        return out


def _matern52(a: np.ndarray, b: np.ndarray, ls: float) -> np.ndarray:
    d = np.sqrt(np.maximum(
        np.sum((a[:, None, :] - b[None, :, :]) ** 2, -1), 1e-16)) / ls
    s5 = math.sqrt(5.0) * d
    return (1.0 + s5 + 5.0 / 3.0 * d * d) * np.exp(-s5)


class _GP:
    """Matern-5/2 GP with y standardization and jittered Cholesky."""

    def __init__(self, lengthscale: float = 0.3, noise: float = 1e-3):
        self.ls = lengthscale
        self.noise = noise

    def fit(self, X: np.ndarray, y: np.ndarray):
        self.X = X
        self.mu = float(y.mean())
        self.sd = float(y.std() + 1e-12)
        yn = (y - self.mu) / self.sd
        K = _matern52(X, X, self.ls) + self.noise * np.eye(len(X))
        self.L = np.linalg.cholesky(K)
        self.alpha = np.linalg.solve(
            self.L.T, np.linalg.solve(self.L, yn))
        return self

    def predict(self, Xs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        Ks = _matern52(Xs, self.X, self.ls)
        mean = Ks @ self.alpha
        v = np.linalg.solve(self.L, Ks.T)
        var = np.maximum(1.0 - np.sum(v * v, axis=0), 1e-12)
        return mean * self.sd + self.mu, np.sqrt(var) * self.sd


class CBO:
    """Ask/tell Bayesian optimizer (minimization by default).

    `ask()` before any `tell` (or during the warmup) returns random
    samples; afterwards it fits the GP on (encoded params, objective) and
    maximizes UCB over a random candidate sweep. Pending (asked but
    untold) points participate via the constant-liar value — the
    reference's `multi_point_strategy="cl_min"`."""

    def __init__(self, space: Dict[str, Any], seed: int = 42,
                 kappa: float = 1.96, n_warmup: int = 8,
                 n_candidates: int = 512, maximize: bool = False):
        self.enc = _Encoder(space)
        self.rng = np.random.RandomState(seed)
        self.kappa = kappa
        self.n_warmup = n_warmup
        self.n_candidates = n_candidates
        self.maximize = maximize
        self.X: List[np.ndarray] = []
        self.y: List[float] = []
        self.params_done: List[Dict[str, Any]] = []
        self.pending: List[Tuple[Dict[str, Any], np.ndarray]] = []

    def ask(self) -> Dict[str, Any]:
        if len(self.y) + len(self.pending) < self.n_warmup or not self.y:
            params = self.enc.sample(self.rng)
            self.pending.append((params, self.enc.encode(params)))
            return params
        # constant liar: pending points pinned at the current best
        # (minimum) so parallel asks spread out instead of clustering
        sign = -1.0 if self.maximize else 1.0
        ys = [sign * v for v in self.y]
        liar = min(ys)
        X = np.stack(self.X + [x for _, x in self.pending])
        y = np.asarray(ys + [liar] * len(self.pending))
        gp = _GP().fit(X, y)
        cands = [self.enc.sample(self.rng)
                 for _ in range(self.n_candidates)]
        Xc = np.stack([self.enc.encode(p) for p in cands])
        mean, std = gp.predict(Xc)
        ucb = -(mean - self.kappa * std)  # maximize improvement over min
        best = int(np.argmax(ucb))
        params = cands[best]
        self.pending.append((params, Xc[best]))
        return params

    def tell(self, params: Dict[str, Any], value: float):
        x = self.enc.encode(params)
        for i, (_, xp) in enumerate(self.pending):
            if np.allclose(xp, x):
                del self.pending[i]
                break
        value = float(value)
        if not math.isfinite(value):
            # failed trials score worst-finite, not inf — an inf poisons
            # the GP's y standardization into NaN and silently degrades
            # the search to random (DeepHyper maps failures the same way)
            finite = [v for v in self.y if math.isfinite(v)]
            span = (max(finite) - min(finite) + 1.0) if finite else 1.0
            if self.maximize:
                value = (min(finite) if finite else 0.0) - span
            else:
                value = (max(finite) if finite else 0.0) + span
        self.X.append(x)
        self.y.append(value)
        self.params_done.append(dict(params))

    @property
    def best(self) -> Optional[Tuple[Dict[str, Any], float]]:
        if not self.y:
            return None
        idx = (int(np.argmax(self.y)) if self.maximize
               else int(np.argmin(self.y)))
        return self.params_done[idx], self.y[idx]
