"""Geometry decorators: wrap any geometry to offset/rotate/clip/deform it.

Counterpart of the reference's decorator family (ref:
SKIRT/core/OffsetGeometryDecorator, RotateGeometryDecorator,
ClipGeometryDecorator + Box/Spherical/Cylindrical variants,
SpheroidalGeometryDecorator, TriaxialGeometryDecorator,
CombineGeometryDecorator, ClumpyGeometryDecorator). Each decorator
implements the same Geometry contract (density_np + sample) by transforming
coordinates, so decorators nest arbitrarily like the reference's.

Density renormalization: clipping and clumping change the total mass; the
reference renormalizes to unit mass with a sampled norm factor — here the
factor is estimated once at construction by MC integration.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import rng
from .analytic import Geometry


def _rotation_matrix(alpha: float, beta: float, gamma: float) -> np.ndarray:
    """Z-Y-Z Euler rotation (ref: RotateGeometryDecorator convention)."""
    ca, sa = np.cos(alpha), np.sin(alpha)
    cb, sb = np.cos(beta), np.sin(beta)
    cg, sg = np.cos(gamma), np.sin(gamma)
    rz1 = np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1]])
    ry = np.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]])
    rz2 = np.array([[cg, -sg, 0], [sg, cg, 0], [0, 0, 1]])
    return rz1 @ ry @ rz2


@dataclasses.dataclass(frozen=True)
class OffsetDecorator(Geometry):
    """Translate a geometry (ref: OffsetGeometryDecorator)."""

    base: Geometry
    offset: tuple = (0.0, 0.0, 0.0)

    def density_np(self, pos):
        return self.base.density_np(np.asarray(pos) - np.asarray(self.offset))

    def sample(self, keys, tag: int = rng.LAUNCH_POSITION):
        return self.base.sample(keys, tag) + jnp.asarray(self.offset,
                                                         jnp.float32)


@dataclasses.dataclass(frozen=True)
class RotateDecorator(Geometry):
    """Rotate a geometry by Euler angles (ref: RotateGeometryDecorator)."""

    base: Geometry
    alpha: float = 0.0
    beta: float = 0.0
    gamma: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "_R",
                           _rotation_matrix(self.alpha, self.beta, self.gamma))

    def density_np(self, pos):
        return self.base.density_np(np.asarray(pos) @ self._R)

    def sample(self, keys, tag: int = rng.LAUNCH_POSITION):
        p = self.base.sample(keys, tag)
        return jnp.dot(p, jnp.asarray(self._R.T, jnp.float32),
                       precision=jax.lax.Precision.HIGHEST)


@dataclasses.dataclass(frozen=True)
class SpheroidalDecorator(Geometry):
    """Flatten/stretch along z by factor q: rho'(x,y,z) ~ rho(x,y,z/q)
    (ref: SpheroidalGeometryDecorator)."""

    base: Geometry
    q: float = 1.0

    def density_np(self, pos):
        pos = np.asarray(pos, np.float64).copy()
        pos[..., 2] = pos[..., 2] / self.q
        return self.base.density_np(pos) / self.q

    def sample(self, keys, tag: int = rng.LAUNCH_POSITION):
        p = self.base.sample(keys, tag)
        return p.at[..., 2].multiply(self.q)


@dataclasses.dataclass(frozen=True)
class TriaxialDecorator(Geometry):
    """Independent y and z axis ratios (ref: TriaxialGeometryDecorator)."""

    base: Geometry
    p: float = 1.0
    q: float = 1.0

    def density_np(self, pos):
        pos = np.asarray(pos, np.float64).copy()
        pos[..., 1] = pos[..., 1] / self.p
        pos[..., 2] = pos[..., 2] / self.q
        return self.base.density_np(pos) / (self.p * self.q)

    def sample(self, keys, tag: int = rng.LAUNCH_POSITION):
        s = self.base.sample(keys, tag)
        return s.at[..., 1].multiply(self.p).at[..., 2].multiply(self.q)


@dataclasses.dataclass(frozen=True)
class ClipDecorator(Geometry):
    """Remove (or keep only) the region defined by `inside_np`
    (ref: ClipGeometryDecorator with remove=Inside/Outside); density is
    renormalized to unit mass by an MC-estimated factor."""

    base: Geometry
    remove_inside: bool = True
    mc_samples: int = 20000

    def inside_np(self, pos) -> np.ndarray:
        raise NotImplementedError

    def __post_init__(self):
        # MC estimate of the surviving mass fraction using base samples
        keys = rng.history_keys(jax.random.PRNGKey(1234),
                                jnp.arange(self.mc_samples))
        pts = np.asarray(self.base.sample(keys), np.float64)
        inside = self.inside_np(pts)
        keep = ~inside if self.remove_inside else inside
        frac = max(float(keep.mean()), 1e-8)
        object.__setattr__(self, "_norm", 1.0 / frac)

    def density_np(self, pos):
        rho = self.base.density_np(pos)
        inside = self.inside_np(np.asarray(pos))
        keep = ~inside if self.remove_inside else inside
        return np.where(keep, rho * self._norm, 0.0)

    def sample(self, keys, tag: int = rng.LAUNCH_POSITION):
        """Rejection via resampling: draw from base, mask failures by
        retrying with folded keys (fixed 8 rounds; leftover failures get
        the last accepted position — bias negligible for survive fractions
        above a few %)."""
        import jax.numpy as jnp

        def inside_dev(p):
            return jnp.asarray(self.inside_np(np.asarray(p)))  # host fallback

        p = self.base.sample(keys, tag)
        # device-side mask via numpy is not traceable; do rejection host-side
        pts = np.asarray(p, np.float64)
        inside = self.inside_np(pts)
        keep = ~inside if self.remove_inside else inside
        bad = np.flatnonzero(~keep)
        tries = 0
        while len(bad) and tries < 16:
            keys2 = rng.purpose_key(keys[bad], 7000 + tries)
            newp = np.asarray(self.base.sample(keys2, tag), np.float64)
            inside = self.inside_np(newp)
            ok = ~inside if self.remove_inside else inside
            pts[bad[ok]] = newp[ok]
            bad = bad[~ok]
            tries += 1
        return jnp.asarray(pts, jnp.float32)


@dataclasses.dataclass(frozen=True)
class SphereClipDecorator(ClipDecorator):
    """(ref: SphericalClipGeometryDecorator)"""

    center: tuple = (0.0, 0.0, 0.0)
    radius: float = 1.0

    def inside_np(self, pos):
        r = np.linalg.norm(np.asarray(pos) - np.asarray(self.center), axis=-1)
        return r < self.radius


@dataclasses.dataclass(frozen=True)
class BoxClipDecorator(ClipDecorator):
    """(ref: BoxClipGeometryDecorator)"""

    lo: tuple = (-1.0, -1.0, -1.0)
    hi: tuple = (1.0, 1.0, 1.0)

    def inside_np(self, pos):
        pos = np.asarray(pos)
        return np.all((pos >= np.asarray(self.lo))
                      & (pos <= np.asarray(self.hi)), axis=-1)


@dataclasses.dataclass(frozen=True)
class CylinderClipDecorator(ClipDecorator):
    """(ref: CylindricalClipGeometryDecorator)"""

    radius: float = 1.0
    zmin: float = -1e300
    zmax: float = 1e300

    def inside_np(self, pos):
        pos = np.asarray(pos)
        R = np.hypot(pos[..., 0], pos[..., 1])
        return (R < self.radius) & (pos[..., 2] > self.zmin) \
            & (pos[..., 2] < self.zmax)


@dataclasses.dataclass(frozen=True)
class CombineDecorator(Geometry):
    """Weighted sum of two geometries (ref: CombineGeometryDecorator)."""

    first: Geometry
    second: Geometry
    w1: float = 1.0
    w2: float = 1.0

    def density_np(self, pos):
        wtot = self.w1 + self.w2
        return (self.w1 * self.first.density_np(pos)
                + self.w2 * self.second.density_np(pos)) / wtot

    def sample(self, keys, tag: int = rng.LAUNCH_POSITION):
        u = rng.uniform(keys, tag + 77)
        p1 = self.first.sample(keys, tag)
        p2 = self.second.sample(keys, tag)
        pick1 = (u < self.w1 / (self.w1 + self.w2))[..., None]
        return jnp.where(pick1, p1, p2)


@dataclasses.dataclass(frozen=True)
class ClumpyDecorator(Geometry):
    """Redistribute a fraction of the mass into smoothed clumps drawn from
    the base density (ref: ClumpyGeometryDecorator + SphericalClumpBVH;
    clump positions fixed at construction by a seeded draw)."""

    base: Geometry
    clump_fraction: float = 0.3
    num_clumps: int = 100
    clump_radius: float = 1.0
    seed: int = 99

    def __post_init__(self):
        keys = rng.history_keys(jax.random.PRNGKey(self.seed),
                                jnp.arange(self.num_clumps))
        centers = np.asarray(self.base.sample(keys), np.float64)
        object.__setattr__(self, "_centers", centers)

    def density_np(self, pos):
        pos = np.asarray(pos, np.float64)
        smooth = (1 - self.clump_fraction) * self.base.density_np(pos)
        # uniform-density spherical clumps (kernel smoothing optional)
        vol = 4 / 3 * np.pi * self.clump_radius**3
        m_clump = self.clump_fraction / self.num_clumps
        clump = np.zeros(pos.shape[:-1])
        for cpos in self._centers:
            r = np.linalg.norm(pos - cpos, axis=-1)
            clump += np.where(r < self.clump_radius, m_clump / vol, 0.0)
        return smooth + clump

    def sample(self, keys, tag: int = rng.LAUNCH_POSITION):
        u = rng.uniform(keys, tag + 88)
        p_smooth = self.base.sample(keys, tag)
        ci = jnp.clip((rng.uniform(keys, tag + 89)
                       * self.num_clumps).astype(jnp.int32),
                      0, self.num_clumps - 1)
        centers = jnp.asarray(self._centers, jnp.float32)
        u_r = rng.uniform(keys, tag + 90) ** (1.0 / 3.0)
        off = rng.isotropic_direction(keys, tag + 91) \
            * (u_r * self.clump_radius)[..., None]
        p_clump = centers[ci] + off
        return jnp.where((u < self.clump_fraction)[..., None],
                         p_clump, p_smooth)


@dataclasses.dataclass(frozen=True)
class SpiralStructureDecorator(Geometry):
    """Add logarithmic spiral arms to an axisymmetric geometry
    (ref: SpiralStructureGeometryDecorator.cpp:18-74: density multiplied
    by (1-w) + w c_N sin^{2N}(m(gamma - phi)/2) with
    gamma = ln(R/R0)/tan(p) + phi0 + pi/(2m) and
    c_N = sqrt(pi) Gamma(N+1)/Gamma(N+1/2), which keeps unit total mass).

    Sampling is rejection-free (the reference loops a rejection test,
    :26-43): the azimuthal profile has the same shape at every radius up
    to the phase shift gamma(R), so a single inverse-cdf table of
    f(psi) = (1-w) + w c_N sin^{2N}(psi) over one period [0, pi) is built
    at construction; on device psi is drawn from it, an arm index k is
    drawn uniformly, and phi = gamma - 2(k pi + psi)/m — exact, one draw
    per packet, lockstep-friendly.
    """

    base: Geometry
    num_arms: int = 2
    pitch_angle: float = 0.1745       # [rad]
    radius_zero_point: float = 1.0    # R0 [m]
    phase_zero_point: float = 0.0     # phi0 [rad]
    perturbation_weight: float = 0.5  # w
    index: int = 1                    # N (arm-interarm size ratio index)

    def __post_init__(self):
        from scipy.special import gammaln
        N = float(self.index)
        cn = np.sqrt(np.pi) * np.exp(gammaln(N + 1.0) - gammaln(N + 0.5))
        object.__setattr__(self, "_cn", float(cn))
        psi = np.linspace(0.0, np.pi, 1025)
        f = (1.0 - self.perturbation_weight) \
            + self.perturbation_weight * cn * np.sin(psi) ** (2 * self.index)
        cdf = np.concatenate([[0.0], np.cumsum(
            0.5 * (f[1:] + f[:-1]) * np.diff(psi))])
        cdf /= cdf[-1]
        object.__setattr__(self, "_psi_grid", psi)
        object.__setattr__(self, "_psi_cdf", cdf)

    def _gamma(self, R):
        xp = jnp if isinstance(R, jax.Array) else np
        return (xp.log(xp.maximum(R, 1e-300) / self.radius_zero_point)
                / np.tan(self.pitch_angle) + self.phase_zero_point
                + 0.5 * np.pi / self.num_arms)

    def perturbation_np(self, R, phi):
        g = self._gamma(np.asarray(R, np.float64))
        return (1.0 - self.perturbation_weight) + self.perturbation_weight \
            * self._cn * np.sin(0.5 * self.num_arms * (g - phi)) \
            ** (2 * self.index)

    def density_np(self, pos):
        pos = np.asarray(pos, np.float64)
        R = np.hypot(pos[..., 0], pos[..., 1])
        phi = np.arctan2(pos[..., 1], pos[..., 0])
        return self.base.density_np(pos) * self.perturbation_np(R, phi)

    def sample(self, keys, tag: int = rng.LAUNCH_POSITION):
        p = self.base.sample(keys, tag)
        R = jnp.hypot(p[..., 0], p[..., 1])
        u = rng.uniform(keys, tag + 77)
        psi = jnp.interp(u, jnp.asarray(self._psi_cdf, jnp.float32),
                         jnp.asarray(self._psi_grid, jnp.float32))
        k = jnp.clip((rng.uniform(keys, tag + 78)
                      * self.num_arms).astype(jnp.int32),
                     0, self.num_arms - 1)
        theta = k.astype(jnp.float32) * np.pi + psi
        phi = self._gamma(R) - 2.0 * theta / self.num_arms
        return jnp.stack([R * jnp.cos(phi), R * jnp.sin(phi), p[..., 2]],
                         axis=-1)


@dataclasses.dataclass(frozen=True)
class RedistributeDecorator(Geometry):
    """Multiply a geometry's density by a weight function, renormalized
    (ref: RedistributeGeometryDecorator — importance-sampling norm from the
    base distribution, position sampling by rejection against w/maxw)."""

    base: Geometry

    def weight_np(self, pos):  # pragma: no cover - abstract
        raise NotImplementedError

    def weight(self, pos):  # pragma: no cover - abstract
        """Traced (jnp) weight — used by the jittable rejection sampler."""
        raise NotImplementedError

    def max_weight(self) -> float:  # pragma: no cover - abstract
        raise NotImplementedError

    def __post_init__(self):
        import jax
        keys = rng.history_keys(jax.random.PRNGKey(20240817),
                                jnp.arange(16384, dtype=jnp.int32))
        pts = np.asarray(self.base.sample(keys), np.float64)
        mean_w = float(self.weight_np(pts).mean())
        object.__setattr__(self, "_norm", 1.0 / max(mean_w, 1e-300))

    def density_np(self, pos):
        return self.base.density_np(pos) * self.weight_np(np.asarray(pos)) \
            * self._norm

    def sample(self, keys, tag: int = rng.LAUNCH_POSITION):
        # fully traced rejection loop keyed on the lane keys: this runs
        # inside the jitted launch when the decorator wraps a SOURCE
        # geometry, so no host numpy may touch the samples (round-3
        # advisory: np.random here raised TracerArrayConversionError)
        pts = self.base.sample(keys, tag)
        maxw = self.max_weight()
        accept = rng.uniform(keys, tag + 76) * maxw < self.weight(pts)
        for t in range(24):
            keys2 = rng.purpose_key(keys, 7100 + t)
            newp = self.base.sample(keys2, tag)
            ok = rng.uniform(keys2, tag + 76) * maxw < self.weight(newp)
            take = (~accept) & ok
            pts = jnp.where(take[..., None], newp, pts)
            accept = accept | ok
        return pts


@dataclasses.dataclass(frozen=True)
class SphePowerLawRedistributeDecorator(RedistributeDecorator):
    """Spherical power-law weight r^-p outside a clipping sphere
    (ref: SphePowerLawRedistributeGeometryDecorator)."""

    exponent: float = 1.0
    min_radius: float = 1.0

    def weight_np(self, pos):
        r = np.linalg.norm(np.asarray(pos), axis=-1)
        return np.where(r >= self.min_radius, np.maximum(r, 1e-300)
                        ** (-self.exponent), 0.0)

    def weight(self, pos):
        r = jnp.linalg.norm(pos, axis=-1)
        return jnp.where(r >= self.min_radius,
                         jnp.maximum(r, 1e-30) ** (-self.exponent), 0.0)

    def max_weight(self) -> float:
        return self.min_radius ** (-self.exponent)


@dataclasses.dataclass(frozen=True)
class AxPowerLawRedistributeDecorator(RedistributeDecorator):
    """Cylindrical power-law weight R^-p outside a clipping cylinder
    (ref: AxPowerLawRedistributeGeometryDecorator)."""

    exponent: float = 1.0
    min_radius: float = 1.0

    def weight_np(self, pos):
        pos = np.asarray(pos)
        R = np.hypot(pos[..., 0], pos[..., 1])
        return np.where(R >= self.min_radius, np.maximum(R, 1e-300)
                        ** (-self.exponent), 0.0)

    def weight(self, pos):
        R = jnp.hypot(pos[..., 0], pos[..., 1])
        return jnp.where(R >= self.min_radius,
                         jnp.maximum(R, 1e-30) ** (-self.exponent), 0.0)

    def max_weight(self) -> float:
        return self.min_radius ** (-self.exponent)
