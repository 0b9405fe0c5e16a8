"""Polarization: batched Stokes-vector algebra and Mueller scattering.

Batched counterpart of the reference's StokesVector + polarized
scattering machinery (ref: SKIRT/utils/StokesVector.hpp:26, DustMix
SphericalPolarization mode per Peest & Hoang 2017, DipolePhaseFunction
polarized Thomson scattering). All functions are batched over (B,).

Conventions (matching the reference):
  * Stokes (I,Q,U,V) with I kept normalized to 1 on the packet; the
    luminosity carries the magnitude;
  * the reference direction n is perpendicular to the propagation k and
    defines the plane for +Q;
  * rotations follow the IAU/right-handed convention: rotating the
    reference frame by phi around k transforms
    Q' = Q cos2phi + U sin2phi, U' = -Q sin2phi + U cos2phi.

Spherical-particle Mueller matrices reduce to (S11, S12, S33, S34):
    [S11 S12  0    0 ]
    [S12 S11  0    0 ]
    [ 0   0  S33  S34]
    [ 0   0 -S34  S33]
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class MuellerTables(NamedTuple):
    """Tabulated spherical-particle Mueller matrix vs scattering angle,
    per medium component (and per wavelength bin if lam-resolved).

    theta (T,), S (H, T) each; values need not be normalized — the engine
    normalizes the phase function internally.
    """

    theta: jax.Array
    S11: jax.Array
    S12: jax.Array
    S33: jax.Array
    S34: jax.Array
    # sampling tables built from S11
    ct_grid: jax.Array   # (T,) cos(theta) decreasing? stored increasing
    ct_cdf: jax.Array    # (H, T) cdf over cos(theta) weighted by S11


def electron_mueller(n_theta: int = 181) -> MuellerTables:
    """Thomson-scattering Mueller matrix (exact dipole; ref:
    DipolePhaseFunction.cpp): S11=(1+c^2)/2, S12=(c^2-1)/2, S33=c, S34=0."""
    theta = np.linspace(0.0, np.pi, n_theta)
    c = np.cos(theta)
    S11 = 0.5 * (1 + c**2)
    S12 = 0.5 * (c**2 - 1)
    S33 = c
    S34 = np.zeros_like(c)
    return build_mueller(theta[None, :].repeat(1, 0), S11[None, :],
                         S12[None, :], S33[None, :], S34[None, :])


def rayleigh_like_mueller(pmax: float = 1.0, n_theta: int = 181) -> MuellerTables:
    """Parametrized dust polarization: dipole-shaped with peak linear
    polarization pmax (test stand-in for resource-backed grain Mueller
    tables; exact for pmax=1 electrons)."""
    theta = np.linspace(0.0, np.pi, n_theta)
    c = np.cos(theta)
    S11 = 0.5 * (1 + c**2)
    S12 = -pmax * 0.5 * (1 - c**2)
    S33 = c
    S34 = np.zeros_like(c)
    return build_mueller(theta[None, :], S11[None, :], S12[None, :],
                         S33[None, :], S34[None, :])


def build_mueller(theta, S11, S12, S33, S34) -> MuellerTables:
    """Assemble tables + S11-weighted cos(theta) sampling cdf (host)."""
    theta = np.atleast_2d(np.asarray(theta, np.float64))[0]
    S11 = np.atleast_2d(np.asarray(S11, np.float64))
    ct = np.cos(theta)[::-1].copy()          # increasing in cos
    w = S11[:, ::-1]
    # cdf over cos(theta): integrate S11 d(cos)
    seg = 0.5 * (w[:, 1:] + w[:, :-1]) * np.diff(ct)[None, :]
    cdf = np.concatenate([np.zeros((S11.shape[0], 1)), np.cumsum(seg, axis=1)],
                         axis=1)
    cdf /= cdf[:, -1:]
    return MuellerTables(
        theta=jnp.asarray(theta, jnp.float32),
        S11=jnp.asarray(S11, jnp.float32),
        S12=jnp.asarray(np.atleast_2d(S12), jnp.float32),
        S33=jnp.asarray(np.atleast_2d(S33), jnp.float32),
        S34=jnp.asarray(np.atleast_2d(S34), jnp.float32),
        ct_grid=jnp.asarray(ct, jnp.float32),
        ct_cdf=jnp.asarray(cdf, jnp.float32),
    )


# --------------------------------------------------------------- Stokes math

def rotate_stokes(stokes: jax.Array, phi: jax.Array) -> jax.Array:
    """Rotate the reference frame by phi around k (B,4)."""
    c2 = jnp.cos(2 * phi)
    s2 = jnp.sin(2 * phi)
    I, Q, U, V = stokes[..., 0], stokes[..., 1], stokes[..., 2], stokes[..., 3]
    return jnp.stack([I, Q * c2 + U * s2, -Q * s2 + U * c2, V], axis=-1)


def apply_mueller(stokes: jax.Array, S11, S12, S33, S34) -> jax.Array:
    """Apply a spherical-particle Mueller matrix (all args (B,))."""
    I, Q, U, V = stokes[..., 0], stokes[..., 1], stokes[..., 2], stokes[..., 3]
    return jnp.stack([
        S11 * I + S12 * Q,
        S12 * I + S11 * Q,
        S33 * U + S34 * V,
        -S34 * U + S33 * V,
    ], axis=-1)


def normalize_stokes(stokes: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Renormalize I to 1; return (stokes', I) (the packet keeps I=1 and
    the luminosity absorbs the magnitude, ref: PhotonPacket convention)."""
    I = stokes[..., 0]
    safe = jnp.maximum(I, 1e-37)
    return stokes / safe[..., None], I


def rotate_normal_into_plane(k: jax.Array, normal: jax.Array,
                             kobs: jax.Array) -> jax.Array:
    """Angle phi rotating the current reference normal into the scattering
    plane spanned by (k, kobs) (ref: PhotonPacket::rotateIntoPlane)."""
    # plane normal of the scattering plane
    pn = jnp.cross(k, kobs)
    pn_norm = jnp.linalg.norm(pn, axis=-1, keepdims=True)
    # degenerate (forward/backward) -> keep current normal
    ok = pn_norm[..., 0] > 1e-12
    pn = jnp.where(ok[..., None], pn / jnp.maximum(pn_norm, 1e-30), normal)
    cosphi = jnp.clip(jnp.sum(normal * pn, axis=-1), -1.0, 1.0)
    # sign via the triple product
    sinphi = jnp.sum(jnp.cross(normal, pn) * k, axis=-1)
    phi = jnp.arctan2(sinphi, cosphi)
    return jnp.where(ok, phi, 0.0), pn


def _take_comp(tab, h, i):
    """tab[h, i] per lane WITHOUT the (B, T) row gather: XLA lowers row
    gathers to the serialized ~7 ns/element path (measured — this one call
    made the polarized peel-off 8x slower than the whole transport); the
    dense compare-reduce take over the small theta table is VPU work."""
    from . import sampling
    H = tab.shape[0]
    out = sampling.take_small(tab[0], i)
    for c in range(1, H):
        out = jnp.where(h == c, sampling.take_small(tab[c], i), out)
    return out


def mueller_at(tabs: MuellerTables, h: jax.Array, costheta: jax.Array):
    """Interpolate (S11,S12,S33,S34) at cos(theta) for component h (B,)."""
    from . import sampling
    th = jnp.arccos(jnp.clip(costheta, -1.0, 1.0))
    tgrid = tabs.theta
    i = jnp.clip(sampling.searchsorted_right(tgrid, th) - 1,
                 0, tgrid.shape[0] - 2)
    t0 = sampling.take_small(tgrid, i)
    t1 = sampling.take_small(tgrid, i + 1)
    f = jnp.where(t1 > t0, (th - t0) / jnp.maximum(t1 - t0, 1e-30), 0.0)

    def interp(tab):
        v0 = _take_comp(tab, h, i)
        v1 = _take_comp(tab, h, i + 1)
        return v0 + f * (v1 - v0)

    return interp(tabs.S11), interp(tabs.S12), interp(tabs.S33), interp(tabs.S34)


def sample_costheta(tabs: MuellerTables, h: jax.Array, u: jax.Array) -> jax.Array:
    """Sample cos(theta) from the S11-weighted marginal for component h."""
    from . import sampling
    H = tabs.ct_cdf.shape[0]

    def li_for(c):
        return jnp.sum((tabs.ct_cdf[c][None, :] < u[:, None])
                       .astype(jnp.int32), axis=1)

    li = li_for(0)
    for c in range(1, H):
        li = jnp.where(h == c, li_for(c), li)
    li = jnp.clip(li, 1, tabs.ct_cdf.shape[1] - 1)
    c0 = _take_comp(tabs.ct_cdf, h, li - 1)
    c1 = _take_comp(tabs.ct_cdf, h, li)
    f = jnp.where(c1 > c0, (u - c0) / jnp.maximum(c1 - c0, 1e-30), 0.5)
    x0 = sampling.take_small(tabs.ct_grid, li - 1)
    x1 = sampling.take_small(tabs.ct_grid, li)
    return jnp.clip(x0 + f * (x1 - x0), -1.0, 1.0)


def sample_azimuth(S11, S12, stokes: jax.Array, u: jax.Array,
                   newton_iters: int = 6) -> jax.Array:
    """Sample the scattering azimuth phi from the polarization-dependent
    conditional pdf p(phi) ~ 1 + P cos2(phi - phi0)
    (ref: DustMix::generateAzimuthFromPhaseFunction, Peest+2017 eq. 13):

    with PL = -S12/S11 * sqrt(Q^2+U^2)/I and phi0 from atan2(U,Q)/2, the cdf
    is phi/2pi + (PL/4pi) [sin2(phi-phi0)+sin2phi0]; inverted with a fixed
    number of Newton steps (monotone, well-conditioned since |PL|<=1).
    """
    I, Q, U = stokes[..., 0], stokes[..., 1], stokes[..., 2]
    P = jnp.sqrt(Q * Q + U * U) / jnp.maximum(I, 1e-30)
    ratio = -S12 / jnp.maximum(jnp.abs(S11), 1e-30) * jnp.sign(S11)
    PL = jnp.clip(ratio * P, -0.99, 0.99)
    phi0 = 0.5 * jnp.arctan2(U, Q)

    target = u  # in (0,1)
    phi = 2 * jnp.pi * u  # initial guess

    def newton(phi, _):
        F = (phi + 0.5 * PL * (jnp.sin(2 * (phi - phi0))
                               + jnp.sin(2 * phi0))) / (2 * jnp.pi) - target
        dF = (1 + PL * jnp.cos(2 * (phi - phi0))) / (2 * jnp.pi)
        return phi - F / jnp.maximum(dF, 1e-4), None

    phi, _ = jax.lax.scan(newton, phi, None, length=newton_iters)
    return jnp.mod(phi, 2 * jnp.pi)


def phase_value(S11, S12, stokes: jax.Array, costheta: jax.Array,
                phi: jax.Array, norm: jax.Array) -> jax.Array:
    """Polarized phase-function value toward a direction at (theta, phi)
    relative to the packet frame, normalized so the integral over the
    sphere is 1: Phi = [S11 I + S12 (Q cos2phi + U sin2phi)] / (2pi N)
    where N = integral S11 dcos (ref: Peest+2017 eq. 10)."""
    I, Q, U = stokes[..., 0], stokes[..., 1], stokes[..., 2]
    val = S11 * I + S12 * (Q * jnp.cos(2 * phi) + U * jnp.sin(2 * phi))
    return val / jnp.maximum(2 * jnp.pi * norm * jnp.maximum(I, 1e-30), 1e-30)


def s11_norm(tabs: MuellerTables) -> jax.Array:
    """integral of S11 over cos(theta), per component (H,)."""
    ct = tabs.ct_grid
    w = tabs.S11[:, ::-1]
    return jnp.sum(0.5 * (w[:, 1:] + w[:, :-1]) * jnp.diff(ct)[None, :],
                   axis=1)
