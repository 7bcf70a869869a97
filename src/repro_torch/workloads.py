"""The paper's Black-Scholes and Haversine workloads (Table 2, Fig. 4a/4b)
and the quickstart chain, over the port's annotated torch ops.

Each workload builds its dataflow lazily under the ambient Mozart context;
callers force the returned futures.  The data generators draw the same
numpy ``RandomState`` numbers as the JAX package's benchmark generators and
hand them to the device, so both packages see bit-identical inputs.  The
numpy float64 oracles are the correctness references.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from repro_torch.core import Along, Generic, Reduce, splittable
from repro_torch.core import annotated_numpy as anp

INV_SQRT2 = 1.0 / math.sqrt(2.0)


def _to(a: np.ndarray, device: torch.device | str) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


# -- Black Scholes (32 vector ops, paper Listing 1 / Fig 4a) -----------------

def black_scholes(price, strike, t, rate, vol):
    rsig = anp.add(rate, anp.multiply(anp.multiply(vol, vol), 2.0))
    vol_sqrt = anp.multiply(vol, anp.sqrt(t))
    d1 = anp.divide(
        anp.add(anp.log(anp.divide(price, strike)), anp.multiply(rsig, t)),
        vol_sqrt)
    d2 = anp.subtract(d1, vol_sqrt)
    nd1 = anp.multiply(anp.add(anp.erf(anp.multiply(d1, INV_SQRT2)), 1.0), 0.5)
    nd2 = anp.multiply(anp.add(anp.erf(anp.multiply(d2, INV_SQRT2)), 1.0), 0.5)
    e_rt = anp.exp(anp.negative(anp.multiply(rate, t)))
    call = anp.subtract(anp.multiply(price, nd1),
                        anp.multiply(anp.multiply(e_rt, strike), nd2))
    put = anp.subtract(
        anp.multiply(anp.multiply(e_rt, strike), anp.subtract(1.0, nd2)),
        anp.multiply(price, anp.subtract(1.0, nd1)))
    return call, put


def black_scholes_data(n: int, seed: int = 0,
                       device: torch.device | str = "cuda") -> dict[str, torch.Tensor]:
    r = np.random.RandomState(seed)
    return dict(
        price=_to(r.uniform(10, 60, n), device),
        strike=_to(r.uniform(10, 60, n), device),
        t=_to(r.uniform(0.5, 2.0, n), device),
        rate=_to(np.full(n, 0.02), device),
        vol=_to(r.uniform(0.1, 0.6, n), device),
    )


def black_scholes_np(d, erf: Callable | None = None):
    """Float64 oracle; ``erf`` defaults to ``math.erf`` elementwise (pass a
    vectorised erf, e.g. scipy's, for large inputs)."""
    p, k, t, r, v = (np.asarray(_host(d[x]), np.float64)
                     for x in ("price", "strike", "t", "rate", "vol"))
    if erf is None:
        erf = np.vectorize(math.erf)
    rsig = r + v * v * 2.0
    vs = v * np.sqrt(t)
    d1 = (np.log(p / k) + rsig * t) / vs
    d2 = d1 - vs
    nd1 = 0.5 * (erf(d1 * INV_SQRT2) + 1)
    nd2 = 0.5 * (erf(d2 * INV_SQRT2) + 1)
    ert = np.exp(-r * t)
    return p * nd1 - ert * k * nd2, ert * k * (1 - nd2) - p * (1 - nd1)


# -- Haversine (18 ops, Fig 4b) ------------------------------------------------

def haversine(lat2, lon2, lat1=0.70984286, lon1=1.23892197):  # radians
    miles = 3959.0
    dlat = anp.subtract(lat2, lat1)
    dlon = anp.subtract(lon2, lon1)
    a = anp.add(
        anp.square(anp.sin(anp.multiply(dlat, 0.5))),
        anp.multiply(
            anp.multiply(anp.cos(lat2), math.cos(lat1)),
            anp.square(anp.sin(anp.multiply(dlon, 0.5)))))
    c = anp.multiply(anp.arcsin(anp.sqrt(a)), 2.0)
    return anp.multiply(c, miles)


def haversine_data(n: int, seed: int = 0,
                   device: torch.device | str = "cuda") -> dict[str, torch.Tensor]:
    r = np.random.RandomState(seed)
    return dict(lat2=_to(r.uniform(-1.5, 1.5, n), device),
                lon2=_to(r.uniform(-3.1, 3.1, n), device))


def haversine_np(lat2, lon2, lat1=0.70984286, lon1=1.23892197):
    lat2 = np.asarray(_host(lat2), np.float64)
    lon2 = np.asarray(_host(lon2), np.float64)
    a = (np.sin((lat2 - lat1) / 2) ** 2
         + np.cos(lat2) * np.cos(lat1) * np.sin((lon2 - lon1) / 2) ** 2)
    return 2 * 3959.0 * np.arcsin(np.sqrt(a))


# -- the quickstart chain: saxpy -> exp -> * 0.5 -> sum ------------------------

@splittable(x=Along(0), y=Along(0), ret=Along(0), elementwise=True)
def saxpy(x, y):
    return 2.0 * x + y


@splittable(x=Generic("S"), ret=Reduce("add"))
def total(x):
    return torch.sum(x)


def quickstart(x, y):
    return total(anp.multiply(anp.exp(saxpy(x, y)), 0.5))


def quickstart_data(n: int, device: torch.device | str = "cuda") -> dict[str, torch.Tensor]:
    return dict(x=torch.arange(n, dtype=torch.float32, device=device) / 1e6,
                y=torch.ones(n, dtype=torch.float32, device=device))


def quickstart_np(x, y) -> float:
    x = np.asarray(_host(x), np.float64)
    y = np.asarray(_host(y), np.float64)
    return float(np.sum(np.exp(2 * x + y) * 0.5))


def _host(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else v
