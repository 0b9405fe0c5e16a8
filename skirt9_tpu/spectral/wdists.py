"""WavelengthDistribution family: configurable wavelength-bias sampling.

Batched counterpart of the reference's WavelengthDistribution hierarchy
(ref: SKIRT/core/WavelengthDistribution.hpp; LinWavelengthDistribution.cpp:21,
LogWavelengthDistribution, FileWavelengthDistribution,
ListWavelengthDistribution, DiscreteWavelengthDistribution.cpp:38-55).

Instead of virtual probability()/generateWavelength() calls, every
continuous distribution is normalized into the same tabulated
(lam, pdf, cdf) device form sampled with the shared log-log cdf inversion;
the discrete distribution keeps per-bin borders + probability densities and
samples a uniform bin index. The composite-bias weight formula in
sources/base._sample_wavelength consumes either form.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class TabulatedWavelengthDistribution:
    """Continuous distribution as a normalized density table.

    The cdf uses the same log-log convention as the SED sampler
    (ops.sampling.cdf_loglog) so the evaluated density is exactly the
    sampled one — a mismatch there biases the composite-bias weights.
    Sparse user tables are densified onto a log grid first because the
    device pdf evaluation interpolates log-log between points.
    """

    lam: np.ndarray
    pdf: np.ndarray

    def tables(self) -> dict:
        from ..ops import sampling
        lam = np.asarray(self.lam, np.float64)
        pdf = np.maximum(np.asarray(self.pdf, np.float64), 0.0)
        if lam.size < 48:
            dense = np.geomspace(lam[0], lam[-1], 192)
            pdf = np.interp(dense, lam, pdf)
            lam = dense
        # normalize by the SAME log-log segment integral that builds the
        # sampling cdf so evaluated density == sampled density exactly
        # (a trapezoid normalization here would bias composite weights).
        cdf, total = sampling.cdf_loglog(lam, pdf)
        pdf = pdf / total
        return {"lam": jnp.asarray(lam, jnp.float32),
                "pdf": jnp.asarray(pdf, jnp.float32),
                "cdf": jnp.asarray(cdf, jnp.float32)}


def lin_distribution(lmin: float, lmax: float):
    """Constant density over the range (ref: LinWavelengthDistribution)."""
    lam = np.geomspace(lmin, lmax, 64)
    return TabulatedWavelengthDistribution(lam, np.ones_like(lam))


def log_distribution(lmin: float, lmax: float):
    """Log-uniform: density ~ 1/lam (ref: LogWavelengthDistribution)."""
    lam = np.geomspace(lmin, lmax, 64)
    return TabulatedWavelengthDistribution(lam, 1.0 / lam)


def list_distribution(lams, pdfs, lrange=None):
    """Tabulated density from explicit value pairs, clipped to the source
    range (ref: ListWavelengthDistribution / TabulatedWavelengthDistribution)."""
    lam = np.asarray(lams, np.float64)
    pdf = np.asarray(pdfs, np.float64)
    order = np.argsort(lam)
    lam, pdf = lam[order], pdf[order]
    if lrange is not None:
        lo, hi = max(lrange[0], lam[0]), min(lrange[1], lam[-1])
        grid = np.unique(np.clip(np.concatenate([lam, [lo, hi]]), lo, hi))
        pdf = np.interp(grid, lam, pdf)
        lam = grid
    return TabulatedWavelengthDistribution(lam, pdf)


def file_distribution(path: str, lrange=None):
    d = np.loadtxt(path)
    return list_distribution(d[:, 0] * 1e-6, d[:, 1], lrange)


@dataclasses.dataclass(frozen=True)
class DiscreteWavelengthDistribution:
    """Equal-probability discrete wavelengths from a wavelength grid
    (ref: DiscreteWavelengthDistribution.cpp:38-55: density within a grid
    bin is 1/(N * effectiveWidth))."""

    borders: np.ndarray          # (N+1,) grid borders [m]
    lrange: tuple | None = None  # source range clip

    def tables(self) -> dict:
        b = np.asarray(self.borders, np.float64)
        lam_c = np.sqrt(b[1:] * b[:-1])
        keep = np.ones(lam_c.size, bool)
        if self.lrange is not None:
            keep = (lam_c >= self.lrange[0]) & (lam_c <= self.lrange[1])
        if not keep.any():
            raise ValueError("no grid wavelengths inside the source range")
        lo, hi, lam_c = b[:-1][keep], b[1:][keep], lam_c[keep]
        n = lam_c.size
        return {"lams": jnp.asarray(lam_c, jnp.float32),
                "lo": jnp.asarray(lo, jnp.float32),
                "hi": jnp.asarray(hi, jnp.float32),
                "pdens": jnp.asarray(1.0 / (n * (hi - lo)), jnp.float32)}


def from_ski(el, lrange, base_dir: str = "."):
    """Build a distribution from a ski wavelengthBiasDistribution child."""
    from ..config.ski import build_wavelength_grid
    from ..utils import units as U
    t = el.tag
    a = el.attrib

    def _rng():
        # explicit range intersected with the source range (ref:
        # RangeWavelengthDistribution::setupSelfBefore)
        if "minWavelength" in a:
            lo = U.parse("wavelength", a["minWavelength"])
            hi = U.parse("wavelength", a["maxWavelength"])
            if lrange is not None:
                lo, hi = max(lo, lrange[0]), min(hi, lrange[1])
            return lo, hi
        return lrange

    if t == "LinWavelengthDistribution":
        return lin_distribution(*_rng())
    if t == "LogWavelengthDistribution":
        return log_distribution(*_rng())
    if t == "UniformWavelengthDistribution":
        return lin_distribution(*_rng())
    if t == "ListWavelengthDistribution":
        lams = U.parse_list("wavelength", a["wavelengths"])
        pdfs = [float(v) for v in a["probabilities"].split(",")]
        return list_distribution(lams, pdfs, lrange)
    if t == "FileWavelengthDistribution":
        import os
        fn = a["filename"]
        if not os.path.isabs(fn):
            fn = os.path.join(base_dir, fn)
        return file_distribution(fn, lrange)
    if t == "DiscreteWavelengthDistribution":
        wlg = el.find("wavelengthGrid")
        borders = build_wavelength_grid(list(wlg)[0])
        return DiscreteWavelengthDistribution(borders, lrange)
    raise NotImplementedError(f"wavelength distribution '{t}'")
