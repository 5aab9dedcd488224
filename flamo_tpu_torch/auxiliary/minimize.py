"""Bounded least-squares minimization (counterpart of
``flamo_tpu/auxiliary/minimize.py``).

The mean-least-squares objective of a gain fit is minimized with scipy's
L-BFGS-B (true box constraints) on the host in float64: these fits run at
design time, never inside a training step.
"""

from __future__ import annotations

import numpy as np


class MLS:
    """Mean-least-squares objective ``mean((G x - y)^2)`` and its
    gradient, in float64."""

    def __init__(self, G, target_interp):
        self.G = np.asarray(G, dtype=np.float64)
        self.target_interp = np.asarray(target_interp, dtype=np.float64)

    def __call__(self, x):
        r = self.G @ x - self.target_interp
        return float(np.mean(r ** 2))

    def grad(self, x):
        r = self.G @ x - self.target_interp
        return (2.0 / len(r)) * (self.G.T @ r)


def minimize_LBFGS(G, target_interp, lower_bound, upper_bound, num_freq: int,
                   max_iter: int = 100):
    """Minimize the MLS loss under box constraints from x0 = 1 with
    L-BFGS-B; returns the optimized gain vector (num_freq + 1,)."""
    from scipy.optimize import minimize

    lower = np.asarray(lower_bound, dtype=np.float64)
    upper = np.asarray(upper_bound, dtype=np.float64)
    x0 = np.ones(num_freq + 1)
    if not len(lower) == len(upper) == len(x0):
        raise AssertionError(
            "The number of bounds must be equal to the number of gains.")
    obj = MLS(G, target_interp)
    res = minimize(obj, x0, jac=obj.grad, method="L-BFGS-B",
                   bounds=list(zip(lower, upper)),
                   options={"maxiter": max_iter})
    return res.x
