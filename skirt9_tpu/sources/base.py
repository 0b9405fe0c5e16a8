"""Primary sources: packet launching as batched pure functions.

Batched redesign of the reference's Source hierarchy + SourceSystem
(ref: SKIRT/core/Source.hpp:56, SourceSystem.cpp:75,101): the source system
precomputes (host-side) the deterministic history-index -> source allocation
with the luminosity/uniform composite bias (xi = sourceBias), exactly like
the reference's prepareForLaunch index map; launching a batch is then a pure
device function of the per-packet RNG keys.

Wavelength sampling uses the composite-bias scheme of NormalizedSource
(ref: SKIRT/core/NormalizedSource.cpp:73-110): with probability 1-xi draw
from the SED, else from a bias distribution (log-uniform over the source
range); the packet weight corrects by s(lam) / ((1-xi) s + xi b).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import rng, sampling
from ..transport.packets import PacketBatch


@dataclasses.dataclass(frozen=True)
class TabulatedSED:
    """Normalized SED on a wavelength grid; host-built cdf, device sampling.

    lam (T,), flux density s_lambda (T,) [arbitrary units, normalized
    internally over the source range]. (ref: SKIRT/core/TabulatedSED and
    ContSED machinery.)
    """

    lam: np.ndarray
    s: np.ndarray

    def tables(self) -> dict:
        cdf, _ = sampling.cdf_loglog(self.lam, self.s)
        norm, _ = sampling.cdf_linlin(self.lam, self.s)  # unused; keep simple
        s_arr = np.asarray(self.s, np.float64)
        # normalized pdf s(lam) such that integral over range = 1
        total = np.trapezoid(s_arr, self.lam)
        return {
            "lam": jnp.asarray(self.lam, jnp.float32),
            "cdf": jnp.asarray(cdf, jnp.float32),
            "pdf": jnp.asarray(s_arr / total, jnp.float32),
        }


@dataclasses.dataclass(frozen=True)
class SineSquarePolarizationProfile:
    """Axisymmetric linear polarization of source emission: degree
    P = Pmax sin^2(theta) about a symmetry axis, polarization angle gamma
    about the meridian (ref: SineSquarePolarizationProfile.cpp:
    polarizationForDirection — Q = PL cos2g, U = PL sin2g, reference
    normal n = sym x k)."""

    symmetry: tuple = (0.0, 0.0, 1.0)
    max_polarization: float = 1.0
    angle: float = 0.0

    def stokes_for(self, kdir: jax.Array):
        """(B,3) directions -> (stokes (B,4), normal (B,3))."""
        sym = np.asarray(self.symmetry, np.float64)
        sym = sym / np.linalg.norm(sym)
        symj = jnp.asarray(sym, jnp.float32)
        ct = jnp.sum(kdir * symj, axis=-1)
        ok = jnp.abs(ct) <= 0.99999
        PL = jnp.where(ok, self.max_polarization * (1.0 - ct) * (1.0 + ct),
                       0.0)
        Q = PL * np.cos(2.0 * self.angle)
        U = PL * np.sin(2.0 * self.angle)
        n = jnp.cross(jnp.broadcast_to(symj, kdir.shape), kdir)
        nn = jnp.linalg.norm(n, axis=-1, keepdims=True)
        # degenerate pole directions: unpolarized, arbitrary valid normal
        fallback = jnp.zeros_like(kdir).at[..., 0].set(1.0)
        n = jnp.where(nn > 1e-6, n / jnp.maximum(nn, 1e-30), fallback)
        st = jnp.stack([jnp.ones_like(PL), Q, U, jnp.zeros_like(PL)],
                       axis=-1)
        return st, n


@dataclasses.dataclass(frozen=True)
class PointSource:
    """Isotropic point source with a given bolometric luminosity [W] over
    the source wavelength range (ref: SKIRT/core/PointSource.hpp).

    sed=None -> monochromatic at lam0 (oligochromatic regime); luminosity is
    then interpreted as the total packet luminosity at that wavelength
    (per-wavelength normalization is the writer's concern).
    """

    position: tuple = (0.0, 0.0, 0.0)
    luminosity: float = 1.0
    lam0: float = 0.55e-6
    sed: TabulatedSED | None = None
    wavelength_bias: float = 0.5
    angular: object = None  # AngularDistribution (ref: SpecialtySource
                            # angular emission, SKIRT/core/PointSource.hpp)
    bias_dist: object = None  # WavelengthDistribution (spectral/wdists.py)
    polarization: object = None  # PolarizationProfile (ref:
                                 # PointSource.hpp:44 polarizationProfile)

    def tables(self) -> dict:
        t = {"pos": jnp.asarray(np.asarray(self.position), jnp.float32)}
        if self.sed is not None:
            t["sed"] = self.sed.tables()
        _add_bias_tables(t, self.bias_dist)
        return t

    def launch(self, tabs: dict, keys: jax.Array, n_total: int) -> dict:
        """Launch fields for a batch: lam (B,), lum (B,), pos (B,3), dir (B,3).

        keys: per-packet event-0 keys (B,2).
        """
        B = keys.shape[0]
        pos = jnp.broadcast_to(tabs["pos"], (B, 3))
        if self.angular is not None:
            dirn = self.angular.sample_direction(keys, rng.LAUNCH_DIRECTION)
        else:
            dirn = rng.isotropic_direction(keys, rng.LAUNCH_DIRECTION)
        lum = jnp.full((B,), self.luminosity / n_total, jnp.float32)
        lam, lum = _sample_wavelength(
            tabs, keys, lum, self.sed, self.lam0, self.wavelength_bias)
        out = {"lam": lam, "lum": lum, "pos": pos, "dir": dirn}
        if self.polarization is not None:
            out["stokes"], out["normal"] = self.polarization.stokes_for(dirn)
        return out


@dataclasses.dataclass(frozen=True)
class GeometricSource:
    """Source with an arbitrary geometry and SED: positions sampled from the
    normalized density profile (ref: SKIRT/core/GeometricSource.hpp —
    Geometry x SED x LuminosityNormalization)."""

    geometry: object
    luminosity: float = 1.0
    lam0: float = 0.55e-6
    sed: TabulatedSED | None = None
    wavelength_bias: float = 0.5
    velocity: tuple = (0.0, 0.0, 0.0)  # bulk velocity (kinematics, later)
    bias_dist: object = None  # WavelengthDistribution (spectral/wdists.py)

    def tables(self) -> dict:
        t = {}
        if self.sed is not None:
            t["sed"] = self.sed.tables()
        _add_bias_tables(t, self.bias_dist)
        return t

    def launch(self, tabs: dict, keys: jax.Array, n_total: int) -> dict:
        B = keys.shape[0]
        pos = self.geometry.sample(keys, rng.LAUNCH_POSITION)
        dirn = rng.isotropic_direction(keys, rng.LAUNCH_DIRECTION)
        lum = jnp.full((B,), self.luminosity / n_total, jnp.float32)
        lam, lum = _sample_wavelength(
            tabs, keys, lum, self.sed, self.lam0, self.wavelength_bias)
        return {"lam": lam, "lum": lum, "pos": pos, "dir": dirn}


def _add_bias_tables(t: dict, bias_dist):
    """Attach a configurable wavelength-bias distribution's device tables
    under the key the sampler dispatches on (continuous vs discrete)."""
    if bias_dist is None:
        return
    from ..spectral.wdists import DiscreteWavelengthDistribution
    key = ("bias_disc"
           if isinstance(bias_dist, DiscreteWavelengthDistribution)
           else "bias_tab")
    t[key] = bias_dist.tables()


def _sample_wavelength(tabs, keys, lum, sed, lam0, xi):
    """Composite-bias wavelength sampling shared by sources
    (ref: NormalizedSource.cpp:73-110)."""
    if sed is None:
        return jnp.full(lum.shape, lam0, jnp.float32), lum
    sedt = tabs["sed"]
    u = rng.uniform(keys, rng.LAUNCH_WAVELENGTH)
    lam_sed = sampling.sample_cdf_loglog(u, sedt["lam"], sedt["cdf"])
    if xi <= 0:
        return lam_sed, lum
    u2 = rng.uniform(keys, rng.LAUNCH_CELL)
    u3 = rng.uniform(keys, rng.LAUNCH_SOURCE)
    if "bias_tab" in tabs:
        # configurable continuous bias distribution (ref:
        # WavelengthDistribution hierarchy; spectral/wdists.py)
        bt = tabs["bias_tab"]
        lam_bias = sampling.sample_cdf_loglog(u2, bt["lam"], bt["cdf"])
        lam = jnp.where(u3 < xi, lam_bias, lam_sed)
        b = sampling.interp_loglog(lam, bt["lam"], bt["pdf"])
        # outside the bias support the density is zero
        b = jnp.where((lam >= bt["lam"][0]) & (lam <= bt["lam"][-1]), b, 0.0)
    elif "bias_disc" in tabs:
        # discrete distribution: uniform pick among grid wavelengths; the
        # density is per-bin (ref: DiscreteWavelengthDistribution.cpp:38-55)
        bd = tabs["bias_disc"]
        n = bd["lams"].shape[0]
        idx = jnp.minimum((u2 * n).astype(jnp.int32), n - 1)
        lam_bias = sampling.take_small(bd["lams"], idx)
        lam = jnp.where(u3 < xi, lam_bias, lam_sed)
        j = jnp.clip(sampling.searchsorted_right(bd["lo"], lam) - 1, 0, n - 1)
        inside = (lam >= sampling.take_small(bd["lo"], j)) \
            & (lam < sampling.take_small(bd["hi"], j))
        b = jnp.where(inside, sampling.take_small(bd["pdens"], j), 0.0)
    else:
        lmin = sedt["lam"][0]
        lmax = sedt["lam"][-1]
        lam_bias = lmin * jnp.exp(u2 * jnp.log(lmax / lmin))
        lam = jnp.where(u3 < xi, lam_bias, lam_sed)
        b = 1.0 / (lam * jnp.log(lmax / lmin))
    s = sampling.interp_loglog(lam, sedt["lam"], sedt["pdf"])
    w = s / jnp.maximum((1.0 - xi) * s + xi * b, 1e-37)
    return lam, lum * w


def launch_batch(source, tabs: dict, grid, seed_key: jax.Array,
                 history: jax.Array, n_total: int,
                 hist_end: "jax.Array | int | None" = None) -> PacketBatch:
    """Assemble a full PacketBatch from a source launch.

    history: (B,) absolute history indices (int32); n_total is THIS source's
    packet count (normalizes per-packet luminosity). Histories are globally
    unique across sources (RNG decorrelation), so the validity cutoff for
    last-batch padding is hist_end = hist_base + n_total, not n_total
    (ref: SourceSystem.cpp:75 history-index ranges per source).
    """
    hkeys = rng.history_keys(seed_key, history)
    keys0 = rng.event_keys(hkeys, rng.LAUNCH_EVENT)  # launch-time stream
    f = source.launch(tabs, keys0, n_total)
    pos, cell, _ = grid.move_inside(f["pos"], f["dir"])
    valid = history < (n_total if hist_end is None else hist_end)
    B = history.shape[0]
    return PacketBatch(
        lam=f["lam"],
        lum=jnp.where(valid, f["lum"], 0.0),
        lum0=jnp.maximum(f["lum"], 1e-37),
        pos=pos,
        dir=f["dir"],
        cell=cell,
        nscat=jnp.zeros((B,), jnp.int32),
        alive=valid & (f["lum"] > 0),
        hkey=hkeys,
        stokes=f.get("stokes",
                     jnp.zeros((B, 4), jnp.float32).at[:, 0].set(1.0)),
        normal=f.get("normal",
                     jnp.zeros((B, 3), jnp.float32).at[:, 0].set(1.0)),
        v_emit=f.get("v_emit", jnp.zeros((B, 3), jnp.float32)),
        dist=jnp.zeros((B,), jnp.float32),
    )
