"""Automated parallelism strategy search (paper §5), a copy of
``repro.core.autotune``.

Bayesian optimization over (PP, TP, MBS, GAS) with a Gaussian-process
surrogate (RBF kernel, fitted in numpy) and Expected Improvement
acquisition.  Failed / infeasible configurations receive a penalized
objective value exactly as in the paper, so the optimizer learns to avoid
the OOM region.  Host-side numpy, bit for bit the reference's: the same
objective and seed give the same trials.

The objective is pluggable, e.g. the analytic cost model
(``cost_model.estimate_step``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

PENALTY = -1.0  # TFLOP/s value assigned to failed (OOM/invalid) trials


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """The paper's Table 2 space."""
    pp: Sequence[int] = (12, 16, 20, 24)
    tp: Sequence[int] = (4, 8)
    mbs: Sequence[int] = tuple(range(1, 11))
    gas: Sequence[int] = (25, 50, 100)

    def enumerate(self) -> List[Dict[str, int]]:
        return [dict(pp=p, tp=t, mbs=m, gas=g)
                for p in self.pp for t in self.tp for m in self.mbs for g in self.gas]

    def encode(self, c: Dict[str, int]) -> np.ndarray:
        def norm(v, seq):
            seq = list(seq)
            return seq.index(v) / max(1, len(seq) - 1)
        return np.array([norm(c["pp"], self.pp), norm(c["tp"], self.tp),
                         norm(c["mbs"], self.mbs), norm(c["gas"], self.gas)])


# ---------------------------------------------------------------------------
# minimal GP regression
# ---------------------------------------------------------------------------

class GP:
    def __init__(self, length_scale: float = 0.35, noise: float = 1e-4):
        self.ls = length_scale
        self.noise = noise
        self.X: Optional[np.ndarray] = None

    def _k(self, A, B):
        d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / self.ls**2)

    def fit(self, X: np.ndarray, y: np.ndarray):
        self.X = X
        self.ymu, self.ystd = float(y.mean()), float(y.std() + 1e-9)
        yn = (y - self.ymu) / self.ystd
        K = self._k(X, X) + self.noise * np.eye(len(X))
        self.L = np.linalg.cholesky(K)
        self.alpha = np.linalg.solve(self.L.T, np.linalg.solve(self.L, yn))

    def predict(self, Xs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        Ks = self._k(Xs, self.X)
        mu = Ks @ self.alpha
        v = np.linalg.solve(self.L, Ks.T)
        var = np.clip(1.0 - (v**2).sum(0), 1e-12, None)
        return mu * self.ystd + self.ymu, np.sqrt(var) * self.ystd


def expected_improvement(mu: np.ndarray, sigma: np.ndarray, best: float) -> np.ndarray:
    z = (mu - best) / sigma
    phi = np.exp(-0.5 * z**2) / math.sqrt(2 * math.pi)
    Phi = 0.5 * (1 + np.vectorize(math.erf)(z / math.sqrt(2)))
    return (mu - best) * Phi + sigma * phi


# ---------------------------------------------------------------------------
# the BO loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Trial:
    config: Dict[str, int]
    value: float          # TFLOP/s per device; PENALTY if failed
    failed: bool


def bayesian_search(objective: Callable[[Dict[str, int]], Tuple[float, bool]],
                    space: SearchSpace = SearchSpace(), *,
                    budget: int = 40, n_init: int = 8,
                    seed: int = 0) -> Tuple[List[Trial], Trial]:
    """objective(config) → (tflops_per_device, failed).  Maximizes."""
    rng = np.random.default_rng(seed)
    candidates = space.enumerate()
    X_all = np.stack([space.encode(c) for c in candidates])
    order = rng.permutation(len(candidates))

    trials: List[Trial] = []
    tried = set()

    def run(idx: int):
        c = candidates[idx]
        val, failed = objective(c)
        trials.append(Trial(config=c, value=PENALTY if failed else val, failed=failed))
        tried.add(idx)

    for idx in order[:n_init]:
        run(int(idx))

    while len(trials) < budget and len(tried) < len(candidates):
        X = np.stack([space.encode(t.config) for t in trials])
        y = np.array([t.value for t in trials])
        gp = GP()
        gp.fit(X, y)
        mu, sig = gp.predict(X_all)
        best = max(t.value for t in trials)
        ei = expected_improvement(mu, sig, best)
        ei[[i for i in range(len(candidates)) if i in tried]] = -np.inf
        run(int(np.argmax(ei)))

    ok = [t for t in trials if not t.failed]
    best_trial = max(ok, key=lambda t: t.value) if ok else trials[0]
    return trials, best_trial


def best_so_far(trials: List[Trial]) -> List[float]:
    """Fig-4 trajectory: best observed value after each evaluation."""
    out, cur = [], float("-inf")
    for t in trials:
        if not t.failed:
            cur = max(cur, t.value)
        out.append(cur if cur != float("-inf") else float("nan"))
    return out
