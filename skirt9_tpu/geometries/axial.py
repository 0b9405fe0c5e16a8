"""Axisymmetric analytic geometries (ref: SKIRT/core Ax*/SepAxGeometry family).

The reference gives every axial geometry a bespoke analytic sampler
(ref: SKIRT/core/TorusGeometry.hpp, ConicalShellGeometry.hpp,
TTauriDiskGeometry.hpp, RingGeometry.hpp, AnnulusGeometry.hpp,
DonutGeometry.hpp, BrokenExpDiskGeometry.hpp, ParaboloidGeometry.hpp,
HyperboloidGeometry.hpp and their *Shell* variants).  The batched design
replaces the per-class inversion code with ONE mechanism: a host-built 2D
(R, z) probability table whose flattened cdf is inverted on device with a
single `searchsorted` per packet plus uniform jitter inside the chosen cell
(512x512 resolution; the reference itself inverts tabulated cdfs for many
profiles, ref: SKIRT/utils/NR.hpp).  `density_np` stays exact-analytic —
only source-position sampling uses the table.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import rng
from .analytic import Geometry


@dataclasses.dataclass(frozen=True)
class AxialTabulatedGeometry(Geometry):
    """Base: subclasses provide rho_Rz(R, z) (unnormalized ok) and bounds."""

    def rho_Rz(self, R: np.ndarray, z: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def bounds(self) -> tuple:  # (Rmax, zmax)
        raise NotImplementedError

    def density_np(self, pos: np.ndarray) -> np.ndarray:
        pos = np.asarray(pos, np.float64)
        R = np.hypot(pos[..., 0], pos[..., 1])
        z = pos[..., 2]
        return self.rho_Rz(R, z) / self._norm()

    # ---------------------------------------------------------------- tables

    def _norm(self) -> float:
        self._get_tables()
        return self._mass

    def _get_tables(self, nR: int = 512, nz: int = 512):
        t = getattr(self, "_tables", None)
        if t is not None:
            return t
        Rmax, zmax = self.bounds()
        Rb = np.linspace(0.0, Rmax, nR + 1)
        zb = np.linspace(-zmax, zmax, nz + 1)
        Rc = 0.5 * (Rb[1:] + Rb[:-1])
        zc = 0.5 * (zb[1:] + zb[:-1])
        rho = self.rho_Rz(Rc[:, None], zc[None, :])
        w = rho * Rc[:, None]  # cylindrical volume element (2 pi dR dz folded)
        flat = np.maximum(w, 0.0).reshape(-1).astype(np.float64)
        total = flat.sum()
        dR = Rb[1] - Rb[0]
        dz = zb[1] - zb[0]
        object.__setattr__(self, "_mass",
                           float(total * 2 * np.pi * dR * dz))
        cdf = np.concatenate([[0.0], np.cumsum(flat / total)])
        cdf[-1] = 1.0
        t = (jnp.asarray(cdf, jnp.float32), jnp.asarray(Rb, jnp.float32),
             jnp.asarray(zb, jnp.float32), nR, nz)
        object.__setattr__(self, "_tables", t)
        return t

    def sample(self, keys, tag: int = rng.LAUNCH_POSITION) -> jax.Array:
        cdf, Rb, zb, nR, nz = self._get_tables()
        u = rng.uniform(keys, tag)
        cell = jnp.clip(jnp.searchsorted(cdf, u, side="right") - 1,
                        0, nR * nz - 1)
        i = cell // nz
        j = cell % nz
        u1, u2 = rng.uniform2(keys, tag + 50)
        # area-correct jitter in R within the bin (p ~ R)
        R0 = Rb[i]
        R1 = Rb[i + 1]
        R = jnp.sqrt(R0 * R0 + u1 * (R1 * R1 - R0 * R0))
        z = zb[j] + u2 * (zb[j + 1] - zb[j])
        phi = 2 * jnp.pi * rng.uniform(keys, tag + 51)
        return jnp.stack([R * jnp.cos(phi), R * jnp.sin(phi), z], axis=-1)


# ------------------------------------------------------------ concrete shapes

@dataclasses.dataclass(frozen=True)
class TorusGeometry(AxialTabulatedGeometry):
    """AGN torus rho ~ r^-p exp(-q|cos theta|) within the opening angle
    (ref: SKIRT/core/TorusGeometry.hpp: exponents p, q, opening Delta,
    radii rmin..rmax)."""

    rmin: float = 0.1
    rmax: float = 1.0
    p: float = 1.0
    q: float = 0.0
    delta: float = 0.35  # half-opening angle from the equatorial plane [rad]

    def bounds(self):
        return self.rmax, self.rmax * np.sin(self.delta) * 1.001

    def rho_Rz(self, R, z):
        r = np.hypot(R, z)
        rs = np.maximum(r, 1e-300)
        cost = np.abs(z) / rs
        inside = ((r >= self.rmin) & (r <= self.rmax)
                  & (cost <= np.sin(self.delta)))
        return np.where(inside, rs ** -self.p * np.exp(-self.q * cost), 0.0)


@dataclasses.dataclass(frozen=True)
class ConicalShellGeometry(AxialTabulatedGeometry):
    """Conical shell around the symmetry axis, rho ~ r^-p between half-
    opening angles delta_in..delta_out from the axis and radii rmin..rmax
    (ref: SKIRT/core/ConicalShellGeometry.hpp)."""

    rmin: float = 0.1
    rmax: float = 1.0
    p: float = 1.0
    delta_in: float = 0.3   # from the axis
    delta_out: float = 0.7

    def bounds(self):
        return self.rmax * np.sin(self.delta_out) * 1.001, self.rmax

    def rho_Rz(self, R, z):
        r = np.hypot(R, z)
        rs = np.maximum(r, 1e-300)
        theta = np.arccos(np.clip(np.abs(z) / rs, 0, 1))  # from axis (folded)
        inside = ((r >= self.rmin) & (r <= self.rmax)
                  & (theta >= self.delta_in) & (theta <= self.delta_out))
        return np.where(inside, rs ** -self.p, 0.0)


@dataclasses.dataclass(frozen=True)
class TTauriDiskGeometry(AxialTabulatedGeometry):
    """Flared T Tauri protoplanetary disk
    rho ~ (R/Rd)^-15/8 exp(-pi/4 (z / (zd (R/Rd)^9/8))^2), Rin<=R<=Rout
    (ref: SKIRT/core/TTauriDiskGeometry.hpp)."""

    rinn: float = 0.01
    rout: float = 1.0
    rd: float = 0.5
    zd: float = 0.05

    def bounds(self):
        hmax = self.zd * (self.rout / self.rd) ** 1.125
        return self.rout, 6.0 * hmax

    def rho_Rz(self, R, z):
        Rs = np.maximum(R, 1e-300)
        h = self.zd * (Rs / self.rd) ** 1.125
        inside = (R >= self.rinn) & (R <= self.rout)
        return np.where(inside, (Rs / self.rd) ** -1.875
                        * np.exp(-np.pi / 4 * (z / h) ** 2), 0.0)


@dataclasses.dataclass(frozen=True)
class RingGeometry(AxialTabulatedGeometry):
    """Gaussian radial ring with exponential vertical profile
    rho ~ exp(-(R-R0)^2/2w^2) exp(-|z|/hz) (ref: SKIRT/core/RingGeometry.hpp)."""

    r0: float = 1.0
    width: float = 0.2
    hz: float = 0.1

    def bounds(self):
        return self.r0 + 6 * self.width, 12.0 * self.hz

    def rho_Rz(self, R, z):
        return (np.exp(-((R - self.r0) ** 2) / (2 * self.width**2))
                * np.exp(-np.abs(z) / self.hz))


@dataclasses.dataclass(frozen=True)
class AnnulusGeometry(AxialTabulatedGeometry):
    """Uniform annulus rmin<=R<=rmax, |z|<=h/2
    (ref: SKIRT/core/AnnulusGeometry.hpp)."""

    rmin: float = 0.5
    rmax: float = 1.0
    height: float = 0.2

    def bounds(self):
        return self.rmax, self.height / 2 * 1.001

    def rho_Rz(self, R, z):
        return np.where((R >= self.rmin) & (R <= self.rmax)
                        & (np.abs(z) <= self.height / 2), 1.0, 0.0)


@dataclasses.dataclass(frozen=True)
class DonutGeometry(AxialTabulatedGeometry):
    """Uniform circular torus (donut): tube radius rc around ring radius r0
    (ref: SKIRT/core/DonutGeometry.hpp)."""

    r0: float = 1.0
    rc: float = 0.25

    def bounds(self):
        return self.r0 + self.rc, self.rc * 1.001

    def rho_Rz(self, R, z):
        return np.where((R - self.r0) ** 2 + z**2 <= self.rc**2, 1.0, 0.0)


@dataclasses.dataclass(frozen=True)
class BrokenExpDiskGeometry(AxialTabulatedGeometry):
    """Radially broken double-exponential disk: inner scale length h_inn,
    outer h_out beyond break radius rb, vertical exp scale hz
    (ref: SKIRT/core/BrokenExpDiskGeometry.hpp)."""

    h_inn: float = 1.0
    h_out: float = 0.5
    rb: float = 2.0
    hz: float = 0.2

    def bounds(self):
        return self.rb + 12 * self.h_out, 12 * self.hz

    def rho_Rz(self, R, z):
        radial = np.where(
            R <= self.rb, np.exp(-R / self.h_inn),
            np.exp(-self.rb / self.h_inn) * np.exp(-(R - self.rb) / self.h_out))
        return radial * np.exp(-np.abs(z) / self.hz)


@dataclasses.dataclass(frozen=True)
class ParaboloidGeometry(AxialTabulatedGeometry):
    """Uniform density inside the paraboloid R^2 = a^2 z (both lobes) up to
    |z| <= zmax (ref: SKIRT/core/ParaboloidGeometry.hpp)."""

    a: float = 1.0
    zmax: float = 1.0

    def bounds(self):
        return self.a * np.sqrt(self.zmax), self.zmax * 1.001

    def rho_Rz(self, R, z):
        az = np.abs(z)
        return np.where((az <= self.zmax) & (R * R <= self.a**2 * az), 1.0, 0.0)


@dataclasses.dataclass(frozen=True)
class ParaboloidShellGeometry(AxialTabulatedGeometry):
    """Uniform density between two nested paraboloids
    (ref: SKIRT/core/ParaboloidShellGeometry.hpp)."""

    a_in: float = 0.7
    a_out: float = 1.0
    zmax: float = 1.0

    def bounds(self):
        return self.a_out * np.sqrt(self.zmax), self.zmax * 1.001

    def rho_Rz(self, R, z):
        az = np.abs(z)
        r2 = R * R
        return np.where((az <= self.zmax) & (r2 <= self.a_out**2 * az)
                        & (r2 >= self.a_in**2 * az), 1.0, 0.0)


@dataclasses.dataclass(frozen=True)
class HyperboloidGeometry(AxialTabulatedGeometry):
    """Uniform density inside the one-sheet hyperboloid
    R^2/a^2 - z^2/c^2 <= 1, |z| <= zmax
    (ref: SKIRT/core/HyperboloidGeometry.hpp)."""

    a: float = 0.5
    c: float = 1.0
    zmax: float = 1.0

    def bounds(self):
        return self.a * np.sqrt(1 + (self.zmax / self.c) ** 2), self.zmax * 1.001

    def rho_Rz(self, R, z):
        return np.where((np.abs(z) <= self.zmax)
                        & (R**2 / self.a**2 - z**2 / self.c**2 <= 1.0),
                        1.0, 0.0)


@dataclasses.dataclass(frozen=True)
class HyperboloidShellGeometry(AxialTabulatedGeometry):
    """Uniform density between two nested one-sheet hyperboloids
    (ref: SKIRT/core/HyperboloidShellGeometry.hpp)."""

    a_in: float = 0.3
    c_in: float = 1.0
    a_out: float = 0.5
    c_out: float = 1.0
    zmax: float = 1.0

    def bounds(self):
        return (self.a_out * np.sqrt(1 + (self.zmax / self.c_out) ** 2),
                self.zmax * 1.001)

    def rho_Rz(self, R, z):
        az = np.abs(z)
        inner = R**2 / self.a_in**2 - z**2 / self.c_in**2 <= 1.0
        outer = R**2 / self.a_out**2 - z**2 / self.c_out**2 <= 1.0
        return np.where((az <= self.zmax) & outer & ~inner, 1.0, 0.0)
