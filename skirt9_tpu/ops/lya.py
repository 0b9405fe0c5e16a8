"""Lyman-alpha resonant line transfer: Voigt cross sections and atom
velocity sampling.

Batched counterpart of the reference's Lya module (ref:
SKIRT/core/LyaUtils.hpp:105 cross-section/atom-velocity sampling,
LyaNeutralHydrogenGasMix.hpp:33, LyaOptions.hpp:17 core-skipping schemes).
Physics follows the standard treatment (Dijkstra 2014 review; Tasitsiomi
2006 Voigt fit; Zheng & Miralda-Escude 2002 parallel-velocity sampling):

  x      = (nu - nu0)/Dnu_D     dimensionless frequency
  v_th   = sqrt(2 k T / m_p)    thermal velocity
  a      = A21 / (4 pi Dnu_D)   damping parameter
  sigma  = 5.9e-14 cm^2 (T/1e4 K)^-1/2 H(a,x) / sqrt(pi) ... (normalized so
           H(a,0) ~ 1)

All functions are batched device ops; rejection loops run a fixed number of
masked rounds (bounded, vectorizable iteration).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils import constants as c

LAM0 = 1215.67e-10            # Lya rest wavelength [m]
NU0 = c.C_LIGHT / LAM0
A21 = 6.25e8                  # Einstein A coefficient [1/s]
SIGMA0_T4 = 5.898e-18         # line-center cross section at 1e4 K [m^2]


def thermal_velocity(T):
    """v_th = sqrt(2kT/m_p) [m/s]."""
    return jnp.sqrt(2.0 * c.K_BOLTZMANN * T / c.PROTON_MASS)


def damping_parameter(T):
    """a = A21 c / (4 pi nu0 v_th) (ref: LyaUtils)."""
    vth = thermal_velocity(T)
    return A21 * c.C_LIGHT / (4.0 * jnp.pi * NU0 * vth)


def dimensionless_x(lam, T):
    """x = (nu - nu0)/Dnu_D = c (lam0 - lam) / (lam0 * v_th) to first order."""
    vth = thermal_velocity(T)
    return c.C_LIGHT * (LAM0 - lam) / (jnp.maximum(lam, 1e-30) * vth) \
        * (lam / LAM0)  # exact nu ratio correction ~1


def voigt_H(a, x):
    """Voigt-Hjerting function H(a,x), Tasitsiomi (2006) analytic fit —
    accurate to ~1% for a < 0.03 (T > ~100 K), the regime of Lya transfer
    (same role as the reference's precomputed Voigt tables)."""
    x2 = x * x
    z = (x2 - 0.855) / (x2 + 3.42)
    q = jnp.where(
        z > 0.0,
        z * (1.0 + 21.0 / x2) * a / (jnp.pi * (x2 + 1.0))
        * (0.1117 + z * (4.421 + z * (-9.207 + 5.674 * z))),
        0.0,
    )
    return q * jnp.sqrt(jnp.pi) + jnp.exp(-x2)


def cross_section(lam, T):
    """Lya scattering cross section per neutral H atom [m^2]."""
    a = damping_parameter(T)
    x = dimensionless_x(lam, T)
    return SIGMA0_T4 * jnp.sqrt(1e4 / jnp.maximum(T, 1.0)) * voigt_H(a, x)


# ------------------------------------------------------- scattering sampling

def _u0_fit(a, x):
    """Comparison-function separation point u0(a, x): the published
    polynomial fit in log10(a) and x used by the Zheng & Miralda-Escude
    rejection method (Smith et al.; same fit the reference evaluates,
    ref: SKIRT/core/VoigtProfile.cpp:54-66)."""
    z = jnp.log10(a)
    z2 = z * z
    return (2.648963 + 2.014446 * z + 0.351479 * z2
            + x * (-4.058673 - 3.675859 * z - 0.640003 * z2
                   + x * (3.017395 + 2.117133 * z + 0.370294 * z2
                          + x * (-0.869789 - 0.565886 * z - 0.096312 * z2
                                 + x * (0.110987 + 0.070103 * z
                                        + 0.011557 * z2
                                        + x * (-0.005200 - 0.003240 * z
                                               - 0.000519 * z2))))))


def sample_parallel_velocity(keys, tag, a, x, iters: int = 24):
    """Sample the atom velocity component along the incoming photon,
    u ~ exp(-u^2) / ((x-u)^2 + a^2): Zheng & Miralda-Escude (2002)
    two-piece Lorentzian comparison function with the u0 fit, fixed masked
    rejection rounds (bounded loop; expected acceptance ~1/3 per round,
    so unconverged lanes after 24 rounds are < 1e-4 and fall back to a
    Gaussian core draw). For x >= 8 the distribution is a Gaussian around
    1/x (ref: VoigtProfile::sample, SKIRT/core/VoigtProfile.cpp:41-103).
    """
    from . import rng

    sign = jnp.where(x >= 0, 1.0, -1.0)
    xa = jnp.abs(x)
    u0 = _u0_fit(a, jnp.minimum(xa, 8.0))
    exp_u02 = jnp.exp(-u0 * u0)
    theta0 = jnp.arctan((u0 - xa) / a)
    half_pi = 0.5 * jnp.pi
    p = (theta0 + half_pi) / ((1.0 - exp_u02) * theta0
                              + (1.0 + exp_u02) * half_pi)

    gauss_fb = rng.gauss(keys, tag + 997) * 0.7071067811865476
    u_large = 1.0 / jnp.maximum(xa, 1e-3) + gauss_fb

    def round_(carry, i):
        u_acc, done = carry
        k = rng.purpose_key(keys, tag + 13 * i)
        u3 = jax.vmap(lambda kk: jax.random.uniform(kk, (3,)))(k)
        u1, u2, u3b = u3[:, 0], u3[:, 1], u3[:, 2]
        left = u1 <= p
        lo = jnp.where(left, -half_pi, theta0)
        hi = jnp.where(left, theta0, half_pi)
        theta = lo + u2 * (hi - lo)
        u_cand = xa + a * jnp.tan(theta)
        frac = jnp.exp(-u_cand * u_cand)
        frac = jnp.where(u_cand > u0, frac / jnp.maximum(exp_u02, 1e-37),
                         frac)
        acc = (u3b < frac) & ~done
        u_acc = jnp.where(acc, u_cand, u_acc)
        done = done | acc
        return (u_acc, done), None

    init = (gauss_fb, jnp.zeros_like(x, dtype=bool))
    (u, _), _ = jax.lax.scan(round_, init, jnp.arange(iters))
    u = jnp.where(xa >= 8.0, u_large, u)
    return sign * u


def scatter_wavelength(lam_in, k_in, k_out, u_par, u_perp1, T):
    """Outgoing wavelength after scattering off an atom with parallel
    velocity u_par (units of v_th) and one perpendicular Gaussian component
    (ref: LyaUtils::shift... : frequency conserved in the atom frame).

    x_out = x_in - u.k_in + u.k_out with u = u_par k_in + u_perp e1.
    """
    vth = thermal_velocity(T)
    mu = jnp.sum(k_in * k_out, axis=-1)
    # perpendicular basis component along k_out
    # e1 orthogonal to k_in, aligned with the k_out projection
    kperp = k_out - mu[..., None] * k_in
    kpn = jnp.linalg.norm(kperp, axis=-1)
    x_in = dimensionless_x(lam_in, T)
    u_dot_kout = u_par * mu + u_perp1 * kpn
    x_out = x_in - u_par + u_dot_kout
    # invert x -> lam (first order in v/c, consistent with dimensionless_x)
    lam_out = LAM0 / (1.0 + x_out * vth / c.C_LIGHT)
    return lam_out
