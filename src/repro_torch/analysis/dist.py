"""The distribution DSL as a namespace — ``from repro_torch.analysis import dist``.

The implementations live in :mod:`repro_torch.analysis.scenarios` next to the
scenario builders they compose with; this module is the ergonomic spelling
used throughout docs and examples::

    from repro_torch.analysis import dist, scenarios

    spec = scenarios.override({
        "dl1.link": dist.lognormal(sigma=0.2),        # cap jitter
        "task1.cpu": dist.uniform(0.7, 1.3),
    }, data={"dl1.remote": dist.triangular(0.8, 1.0, 1.1)})
    mc = plan.mc(spec, n=10_000, seed=0)
"""

from .scenarios import (Discrete, Dist, DistRamp, LogNormal, Triangular,
                        Uniform, discrete, lognormal, triangular, uniform)

__all__ = ["Discrete", "Dist", "DistRamp", "LogNormal", "Triangular",
           "Uniform", "discrete", "lognormal", "triangular", "uniform"]
