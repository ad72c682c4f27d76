"""Parameter prior distributions for Bayesian inference (a port of
pint_tpu/models/priors.py; reference: src/pint/models/priors.py).

A prior is a small object with a ``logpdf`` of torch float64 ops and a
``ppf`` (for nested-sampling prior transforms). ``logpdf`` takes a Python
float or a float64 tensor of any shape and returns a float64 tensor of
that shape, so the posterior can call it per walker under
``torch.func.vmap``. ``Parameter.prior`` is None by default, the improper
flat prior.
"""

from __future__ import annotations

import math

import torch

__all__ = ["Prior", "UniformPrior", "UniformUnboundedPrior",
           "GaussianPrior", "Log10TransformedPrior"]

_LN10 = math.log(10.0)


def _f64(x) -> torch.Tensor:
    """``x`` as a float64 tensor (a float64 tensor is passed through, so
    a batched tensor under vmap stays batched)."""
    if torch.is_tensor(x):
        return x if x.dtype == torch.float64 else x.to(torch.float64)
    return torch.as_tensor(x, dtype=torch.float64)


class Prior:
    """Base prior: improper flat over the whole real line (reference:
    Prior with UniformUnboundedRV)."""

    def logpdf(self, x):
        return torch.zeros_like(_f64(x))

    def pdf(self, x):
        return torch.exp(self.logpdf(x))

    def ppf(self, q):
        raise ValueError(
            f"{type(self).__name__} is improper: no prior transform; "
            "give the parameter a bounded prior for nested sampling")

    def __repr__(self):
        return f"{type(self).__name__}()"


class UniformUnboundedPrior(Prior):
    """Explicit alias of the default improper flat prior."""


class UniformPrior(Prior):
    """Proper uniform on [lower, upper] (reference: UniformBoundedRV)."""

    def __init__(self, lower: float, upper: float):
        if not upper > lower:
            raise ValueError("need upper > lower")
        self.lower, self.upper = float(lower), float(upper)

    def logpdf(self, x):
        x = _f64(x)
        inside = (x >= self.lower) & (x <= self.upper)
        return torch.where(
            inside, torch.full_like(x, -math.log(self.upper - self.lower)),
            torch.full_like(x, -math.inf))

    def ppf(self, q):
        return self.lower + (self.upper - self.lower) * _f64(q)

    def __repr__(self):
        return f"UniformPrior({self.lower}, {self.upper})"


class Log10TransformedPrior(Prior):
    """Change-of-variables adapter for a dimension SAMPLED as
    eta = log10(v) whose declared prior is over the linear value v
    (the ECORR convention in ``sampling.likelihood``: the parameter's
    prior is in microseconds, the sampled dimension is log10(us)):
    p_eta(eta) = p_v(10**eta) * 10**eta * ln(10). The base prior must
    have positive support for ``ppf`` to be meaningful."""

    def __init__(self, base: Prior):
        self.base = base

    def logpdf(self, eta):
        eta = _f64(eta)
        return (self.base.logpdf(10.0 ** eta) + eta * _LN10
                + math.log(_LN10))

    def ppf(self, q):
        return torch.log10(_f64(self.base.ppf(q)))

    def __repr__(self):
        return f"Log10TransformedPrior({self.base!r})"


class GaussianPrior(Prior):
    """Gaussian prior N(mu, sigma) (reference: GaussianBoundedRV without
    the truncation; add bounds by composing with UniformPrior support if
    needed)."""

    def __init__(self, mu: float, sigma: float):
        if not sigma > 0:
            raise ValueError("need sigma > 0")
        self.mu, self.sigma = float(mu), float(sigma)

    def logpdf(self, x):
        z = (_f64(x) - self.mu) / self.sigma
        return -0.5 * z * z - math.log(
            self.sigma * math.sqrt(2.0 * math.pi))

    def ppf(self, q):
        return self.mu + self.sigma * torch.special.ndtri(_f64(q))

    def __repr__(self):
        return f"GaussianPrior({self.mu}, {self.sigma})"
