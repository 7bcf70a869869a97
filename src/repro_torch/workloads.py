"""The paper's workloads (Table 2) over the port's annotated torch
libraries: Black-Scholes and Haversine (Fig. 4a/4b) and the quickstart
chain on the NumPy integration, the DataFrame workloads (Fig. 4e-h) on the
Table integration and the ImageMagick filters (Fig. 4n-o) on the Image
integration.

Each workload builds its dataflow lazily under the ambient Mozart context;
callers force the returned futures.  The data generators draw the same
numpy ``RandomState`` numbers as the JAX package's benchmark generators and
hand them to the device, so both packages see bit-identical inputs (the
tables keep fig4's float64/int64 columns).  The numpy float64 oracles are
the correctness references.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from repro_torch.core import Along, Generic, Reduce, splittable
from repro_torch.core import annotated_image as img
from repro_torch.core import annotated_numpy as anp
from repro_torch.core import annotated_table as tb

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


# -- Pandas-style (Fig 4e-h) ---------------------------------------------------

def crime_index(table: tb.Table):
    """Fig 4f: per-city crime index = avg(crime*100/pop) over big cities."""
    pop = tb.col(table, "pop")
    crime = tb.col(table, "crime")
    big = anp.greater(pop, 500.0)
    kept = tb.filter_rows(table, big)
    pop2 = tb.col(kept, "pop")
    crime2 = tb.col(kept, "crime")
    idx = anp.divide(anp.multiply(crime2, 100.0), pop2)
    total = anp.sum(idx)
    return total


def crime_index_np(table: tb.Table):
    pop = np.asarray(_host(table.cols["pop"]))
    crime = np.asarray(_host(table.cols["crime"]))
    m = pop > 500.0
    return (crime[m] * 100.0 / pop[m]).sum()


def data_cleaning(table: tb.Table):
    """Fig 4e: replace broken values with NaN, then count valid per column."""
    vals = tb.col(table, "value")
    bad = anp.logical_or(anp.less(vals, 0.0), anp.greater(vals, 1e6))
    nan = torch.tensor(math.nan, dtype=torch.float32, device=table.cols["value"].device)
    clean = anp.where(bad, nan, vals)
    valid = anp.sum(anp.where(anp.isnan(clean), 0.0, 1.0))
    total = anp.sum(anp.where(anp.isnan(clean), 0.0, clean))
    return valid, total


def data_cleaning_np(table: tb.Table):
    v = np.asarray(_host(table.cols["value"]), np.float64)
    bad = (v < 0) | (v > 1e6)
    c = np.where(bad, np.nan, v)
    return float((~np.isnan(c)).sum()), float(np.nansum(c))


def birth_analysis(table: tb.Table):
    """Fig 4g: groupBy aggregation (no pipelined ops, pure parallel agg)."""
    return tb.groupby_agg(table, key="year", val="births", op="sum")


def movielens(ratings: tb.Table, movies: tb.Table):
    """Fig 4h: join + grouped means."""
    joined = tb.join_inner(ratings, movies, on="movie")
    g = tb.groupby_agg(joined, key="movie", val="rating", op="mean")
    return g


def _table(cols: dict[str, np.ndarray], device) -> tb.Table:
    return tb.Table({k: torch.from_numpy(v).to(device) for k, v in cols.items()})


def crime_table(n: int, seed: int = 0, device: torch.device | str = "cuda") -> tb.Table:
    """``benchmarks/fig4_dataframes.py``'s crime table (int64 city,
    float64 pop and crime)."""
    r = np.random.RandomState(seed)
    return _table({"city": r.randint(0, 500, n).astype(np.int64),
                   "pop": (r.rand(n) * 1000).astype(np.float64),
                   "crime": (r.rand(n) * 10).astype(np.float64)}, device)


def cleaning_table(n: int, seed: int = 0, device: torch.device | str = "cuda") -> tb.Table:
    """fig4's data-cleaning column: float64, 5% broken (-5.0)."""
    r = np.random.RandomState(seed)
    vals = r.randn(n) * 1e5
    vals[r.rand(n) < 0.05] = -5.0
    return _table({"value": vals}, device)


def birth_table(n: int, seed: int = 0, device: torch.device | str = "cuda") -> tb.Table:
    r = np.random.RandomState(seed)
    return _table({"year": r.randint(1950, 2010, n).astype(np.int64),
                   "births": r.randint(1, 50, n).astype(np.float64)}, device)


def movielens_tables(n: int, n_movies: int = 4000, seed: int = 0,
                     device: torch.device | str = "cuda") -> tuple[tb.Table, tb.Table]:
    r = np.random.RandomState(seed)
    ratings = _table({"movie": r.randint(0, n_movies, n).astype(np.int64),
                      "rating": (r.rand(n) * 5).astype(np.float64)}, device)
    movies = _table({"movie": np.arange(n_movies, dtype=np.int64),
                     "year": r.randint(1950, 2020, n_movies).astype(np.float64)}, device)
    return ratings, movies


# -- ImageMagick (Fig 4n-o) -----------------------------------------------------

def nashville(im):
    a = img.colortone(im, (0.8, 0.2, 0.2), 0.2, True)
    b = img.level(a, 0.02, 0.95)
    c = img.gamma(b, 1.1)
    d = img.modulate(c, 100.0, 150.0, 100.0)
    e = img.contrast(d, 1.1)
    f = img.colortone(e, (0.1, 0.1, 0.5), 0.15, False)
    return f


def gotham(im):
    a = img.modulate(im, 120.0, 10.0, 100.0)
    b = img.colortone(a, (0.13, 0.13, 0.35), 0.3, True)
    c = img.gamma(b, 0.9)
    d = img.contrast(c, 1.4)
    e = img.level(d, 0.05, 0.95)
    return e


def image(h: int, w: int, seed: int = 0, device: torch.device | str = "cuda") -> torch.Tensor:
    """``benchmarks/fig4_images.py``'s image: (h, w, 3) float32 in [0, 1)."""
    return _to(np.random.RandomState(seed).rand(h, w, 3), device)


def _host(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else v
