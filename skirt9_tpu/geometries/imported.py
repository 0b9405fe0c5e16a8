"""Imported geometries: snapshot data as normalized density profiles.

Counterpart of the reference's ImportedGeometry family (ref:
SKIRT/core/ImportedGeometry.hpp:19 — an abstract Geometry whose density()
and generatePosition() delegate to a Snapshot, plus SiteListInterface so
site-list tree policies and Voronoi grids can seed from the imported
entities). Concrete subclasses per snapshot type, matching the reference:

  ParticleGeometry          (ParticleGeometry.hpp:43,  SPH particles+kernel)
  CellGeometry              (CellGeometry.hpp:55,      cuboidal cells)
  CylindricalCellGeometry   (CylindricalCellGeometry.hpp:59)
  SphericalCellGeometry     (SphericalCellGeometry.hpp:67)
  MeshGeometry/AdaptiveMeshGeometry (MeshGeometry.hpp:31,
                             AdaptiveMeshGeometry.hpp:46, regular/AMR mesh)
  VoronoiMeshGeometry       (VoronoiMeshGeometry.hpp:48, Voronoi sites)

Batched design: the geometry contract here is the package's batched one
(density_np on host for medium-state setup; sample(keys, tag) -> (B,3)
device positions). Entity selection is a mass-cdf searchsorted on device;
in-entity positions are closed-form per cell shape (box / cylindrical /
spherical sector / kernel sphere) and bounded-rejection for Voronoi cells
(accept when the grid's nearest-site locate returns the chosen cell —
the reference does the same rejection against Voro++ cell bounding boxes,
VoronoiMeshSnapshot::generatePosition).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import rng, sampling
from .analytic import Geometry


def _mass_cdf(mass: np.ndarray) -> jnp.ndarray:
    m = np.asarray(mass, np.float64)
    tot = m.sum()
    if not tot > 0:
        raise ValueError("imported geometry has zero total mass")
    return jnp.asarray(np.cumsum(m) / tot, jnp.float32)


def _pick_entity(cdf: jax.Array, keys: jax.Array, tag: int) -> jax.Array:
    u = rng.uniform(keys, tag)
    return jnp.clip(jnp.searchsorted(cdf, u, side="right"),
                    0, cdf.shape[0] - 1).astype(jnp.int32)


class ImportedGeometry(Geometry):
    """Base adapter: normalized density + entity-cdf position sampling over
    a snapshot (ref: ImportedGeometry.hpp:19)."""

    # subclasses set in __post_init__:
    #   self._cdf   (N,) device mass cdf
    #   self._mtot  float total mass [kg or entity units]

    @property
    def total_mass(self) -> float:
        return self._mtot

    @property
    def rmax(self) -> float:
        """Bounding radius of the imported mass (integration bound for
        axis/column normalizations, media/geometric.py)."""
        return self._rmax

    def density_np(self, pos: np.ndarray) -> np.ndarray:
        return np.asarray(self._density_at(np.asarray(pos, np.float64)),
                          np.float64) / self._mtot

    def sample(self, keys: jax.Array,
               tag: int = rng.LAUNCH_POSITION) -> jax.Array:
        j = _pick_entity(self._cdf, keys, tag + 7)
        return self._entity_position(keys, j, tag)

    # SiteListInterface (ref: SiteListInterface.hpp; consumed by
    # SiteListTreePolicy and VoronoiMeshSpatialGrid imported-site policies)
    def sites_np(self) -> np.ndarray:
        return np.asarray(self._sites, np.float64)


@dataclasses.dataclass
class ParticleGeometry(ImportedGeometry):
    """Smoothed-particle geometry (ref: ParticleGeometry.hpp:43)."""

    snapshot: object                 # imports.snapshots.ParticleSnapshot
    kernel_kind: str = "CubicSplineSmoothingKernel"

    def __post_init__(self):
        ss = self.snapshot
        self._cdf = _mass_cdf(ss.mass)
        self._mtot = float(np.sum(ss.mass))
        self._sites = ss.positions
        self._pos_dev = jnp.asarray(ss.positions, jnp.float32)
        self._h_dev = jnp.asarray(ss.h, jnp.float32)
        self._rmax = float(np.max(np.linalg.norm(ss.positions, axis=-1)
                                  + ss.h))
        if self.kernel_kind != "CubicSplineSmoothingKernel":
            from ..imports.snapshots import kernel_tables
            self._ktabs = kernel_tables(self.kernel_kind)
        else:
            self._ktabs = None

    def _density_at(self, pos):
        return self.snapshot.density_at(pos)

    def _entity_position(self, keys, j, tag):
        u_r = rng.uniform(keys, tag)
        if self._ktabs is not None:
            q = sampling.sample_cdf_linlin(u_r, *self._ktabs)
        else:
            from ..imports.snapshots import sample_kernel_radius
            q = sample_kernel_radius(u_r)
        d = rng.isotropic_direction(keys, tag + 60)
        return self._pos_dev[j] + (q * self._h_dev[j])[..., None] * d


def _uniform3(keys, tag):
    u0, u1 = rng.uniform2(keys, tag + 20)
    u2 = rng.uniform(keys, tag + 21)
    return u0, u1, u2


@dataclasses.dataclass
class CellGeometry(ImportedGeometry):
    """Cuboidal-cell geometry (ref: CellGeometry.hpp:55): uniform density
    per cell, uniform in-cell positions."""

    snapshot: object                 # imports.snapshots.CellSnapshot

    def __post_init__(self):
        ss = self.snapshot
        self._cdf = _mass_cdf(ss.mass)
        self._mtot = float(np.sum(ss.mass))
        lo = np.asarray(ss.lo, np.float64)
        hi = np.asarray(ss.hi, np.float64)
        self._sites = 0.5 * (lo + hi)
        self._rmax = float(np.max(np.linalg.norm(
            np.concatenate([lo, hi]), axis=-1)))
        self._lo_dev = jnp.asarray(lo, jnp.float32)
        self._hi_dev = jnp.asarray(hi, jnp.float32)
        self._rho = np.asarray(ss.mass, np.float64) \
            / np.maximum(np.prod(hi - lo, axis=-1), 1e-300)

    def _density_at(self, pos):
        pos = np.atleast_2d(pos)
        lo = np.asarray(self.snapshot.lo, np.float64)
        hi = np.asarray(self.snapshot.hi, np.float64)
        out = np.zeros(len(pos))
        for jj in range(len(self._rho)):
            sel = np.all((pos >= lo[jj]) & (pos < hi[jj]), axis=-1)
            out = np.where(sel, out + self._rho[jj], out)
        return out

    def _entity_position(self, keys, j, tag):
        u0, u1, u2 = _uniform3(keys, tag)
        u = jnp.stack([u0, u1, u2], axis=-1)
        return self._lo_dev[j] + u * (self._hi_dev[j] - self._lo_dev[j])


@dataclasses.dataclass
class CylindricalCellGeometry(ImportedGeometry):
    """Cylindrical-cell geometry (ref: CylindricalCellGeometry.hpp:59):
    uniform in (R^2, phi, z) within each cell sector."""

    snapshot: object                 # imports.snapshots.CylindricalCellSnapshot

    def __post_init__(self):
        ss = self.snapshot
        self._cdf = _mass_cdf(ss.mass)
        self._mtot = float(np.sum(ss.mass))
        lo = np.asarray(ss.lo, np.float64)
        hi = np.asarray(ss.hi, np.float64)
        phi_c = 0.5 * (lo[:, 1] + hi[:, 1])
        R_c = 0.5 * (lo[:, 0] + hi[:, 0])
        self._sites = np.stack([R_c * np.cos(phi_c), R_c * np.sin(phi_c),
                                0.5 * (lo[:, 2] + hi[:, 2])], axis=-1)
        self._rmax = float(np.max(np.hypot(
            hi[:, 0], np.maximum(np.abs(lo[:, 2]), np.abs(hi[:, 2])))))
        self._lo_dev = jnp.asarray(lo, jnp.float32)
        self._hi_dev = jnp.asarray(hi, jnp.float32)

    def _density_at(self, pos):
        return self.snapshot.density_at(pos)

    def _entity_position(self, keys, j, tag):
        u0, u1, u2 = _uniform3(keys, tag)
        lo, hi = self._lo_dev[j], self._hi_dev[j]
        # normalize by the outer radius before squaring: raw R^2 at
        # astrophysical scales (pc^2 ~ 1e33 m^2) sits near the f32 edge
        f = lo[:, 0] / jnp.maximum(hi[:, 0], 1e-37)
        R = hi[:, 0] * jnp.sqrt(f * f + u0 * (1.0 - f * f))
        phi = lo[:, 1] + u1 * (hi[:, 1] - lo[:, 1])
        z = lo[:, 2] + u2 * (hi[:, 2] - lo[:, 2])
        return jnp.stack([R * jnp.cos(phi), R * jnp.sin(phi), z], axis=-1)


@dataclasses.dataclass
class SphericalCellGeometry(ImportedGeometry):
    """Spherical-cell geometry (ref: SphericalCellGeometry.hpp:67):
    uniform in (r^3, cos theta, phi) within each cell sector."""

    snapshot: object                 # imports.snapshots.SphericalCellSnapshot

    def __post_init__(self):
        ss = self.snapshot
        self._cdf = _mass_cdf(ss.mass)
        self._mtot = float(np.sum(ss.mass))
        lo = np.asarray(ss.lo, np.float64)
        hi = np.asarray(ss.hi, np.float64)
        r_c = 0.5 * (lo[:, 0] + hi[:, 0])
        th_c = 0.5 * (lo[:, 1] + hi[:, 1])
        ph_c = 0.5 * (lo[:, 2] + hi[:, 2])
        self._sites = np.stack(
            [r_c * np.sin(th_c) * np.cos(ph_c),
             r_c * np.sin(th_c) * np.sin(ph_c),
             r_c * np.cos(th_c)], axis=-1)
        self._rmax = float(np.max(hi[:, 0]))
        self._lo_dev = jnp.asarray(lo, jnp.float32)
        self._hi_dev = jnp.asarray(hi, jnp.float32)

    def _density_at(self, pos):
        return self.snapshot.density_at(pos)

    def _entity_position(self, keys, j, tag):
        u0, u1, u2 = _uniform3(keys, tag)
        lo, hi = self._lo_dev[j], self._hi_dev[j]
        # r^3 at astrophysical scales overflows f32 — work in r/r_max
        f = lo[:, 0] / jnp.maximum(hi[:, 0], 1e-37)
        r = hi[:, 0] * (f ** 3 + u0 * (1.0 - f ** 3)) ** (1.0 / 3.0)
        mu0, mu1 = jnp.cos(hi[:, 1]), jnp.cos(lo[:, 1])
        mu = mu0 + u1 * (mu1 - mu0)
        st = jnp.sqrt(jnp.maximum(1.0 - mu * mu, 0.0))
        phi = lo[:, 2] + u2 * (hi[:, 2] - lo[:, 2])
        return jnp.stack([r * st * jnp.cos(phi), r * st * jnp.sin(phi),
                          r * mu], axis=-1)


@dataclasses.dataclass
class MeshGeometry(ImportedGeometry):
    """Regular-mesh geometry (ref: MeshGeometry.hpp:31 over a uniform
    mesh): per-mesh-cell masses, uniform in-cell positions."""

    snapshot: object                 # imports.snapshots.MeshSnapshot

    def __post_init__(self):
        ss = self.snapshot
        mass = np.asarray(ss.mass, np.float64).reshape(-1)
        self._cdf = _mass_cdf(mass)
        self._mtot = float(mass.sum())
        n = np.asarray(ss.mass.shape)
        h = (np.asarray(ss.hi, np.float64)
             - np.asarray(ss.lo, np.float64)) / n
        idx = np.stack(np.meshgrid(np.arange(n[0]), np.arange(n[1]),
                                   np.arange(n[2]), indexing="ij"),
                       axis=-1).reshape(-1, 3)
        lo = np.asarray(ss.lo, np.float64) + idx * h
        self._sites = lo + 0.5 * h
        self._rmax = float(max(np.linalg.norm(np.asarray(ss.lo)),
                               np.linalg.norm(np.asarray(ss.hi))))
        self._lo_dev = jnp.asarray(lo, jnp.float32)
        self._h_dev = jnp.asarray(h, jnp.float32)

    def _density_at(self, pos):
        return self.snapshot.density_at(pos)

    def _entity_position(self, keys, j, tag):
        u0, u1, u2 = _uniform3(keys, tag)
        u = jnp.stack([u0, u1, u2], axis=-1)
        return self._lo_dev[j] + u * self._h_dev


@dataclasses.dataclass
class AdaptiveMeshGeometry(ImportedGeometry):
    """Adaptive-mesh geometry (ref: AdaptiveMeshGeometry.hpp:46): leaf
    boxes of an imported Morton-order AMR tree with per-leaf masses."""

    grid: object                     # grids.amr.AMRGrid
    mass: np.ndarray                 # (nleaf,) mass per leaf [kg]

    def __post_init__(self):
        self._cdf = _mass_cdf(self.mass)
        self._mtot = float(np.sum(self.mass))
        lo, hi = self.grid.cell_bounds()
        self._sites = 0.5 * (np.asarray(lo) + np.asarray(hi))
        self._rmax = float(np.max(np.linalg.norm(
            np.concatenate([np.asarray(lo), np.asarray(hi)]), axis=-1)))
        self._lo_dev = jnp.asarray(lo, jnp.float32)
        self._hi_dev = jnp.asarray(hi, jnp.float32)
        self._rho = np.asarray(self.mass, np.float64) \
            / np.maximum(self.grid.volumes(), 1e-300)

    def _density_at(self, pos):
        pos = np.atleast_2d(pos)
        cells = np.asarray(jax.device_get(
            self.grid.locate(jnp.asarray(pos, jnp.float32))))
        ok = cells >= 0
        out = np.zeros(len(pos))
        out[ok] = self._rho[cells[ok]]
        return out

    def _entity_position(self, keys, j, tag):
        u0, u1, u2 = _uniform3(keys, tag)
        u = jnp.stack([u0, u1, u2], axis=-1)
        return self._lo_dev[j] + u * (self._hi_dev[j] - self._lo_dev[j])


@dataclasses.dataclass
class VoronoiMeshGeometry(ImportedGeometry):
    """Voronoi-mesh geometry (ref: VoronoiMeshGeometry.hpp:48): one mass
    per site; density is piecewise constant on the Voronoi tessellation.

    In-cell sampling is bounded rejection inside the cell's exact AABB
    with the nearest-site membership test (8 masked retry rounds cover
    AABB fill fractions down to ~1e-3 per lane; leftovers fall back to
    the site position — the same strategy as the reference's rejection
    against Voro++ bounding boxes, VoronoiMeshSnapshot::generatePosition)."""

    sites: np.ndarray                # (N,3) [m]
    mass: np.ndarray | None = None   # (N,) mass per cell, OR
    mass_density: np.ndarray | None = None   # (N,) density per cell
    extent: tuple = ()               # ((x0,x1),(y0,y1),(z0,z1))
    rejection_rounds: int = 8

    def __post_init__(self):
        from ..grids.voronoi import build_voronoi
        self._grid = build_voronoi(np.asarray(self.sites, np.float64),
                                   self.extent)
        if self.mass is None:
            self.mass = np.asarray(self.mass_density, np.float64) \
                * self._grid.volumes()
        self._cdf = _mass_cdf(self.mass)
        self._mtot = float(np.sum(self.mass))
        self._sites = np.asarray(self.sites, np.float64)
        self._rmax = float(np.max(np.linalg.norm(
            np.asarray([[self.extent[a][i] for a in range(3)]
                        for i in range(2)]), axis=-1)))
        self._rho = np.asarray(self.mass, np.float64) \
            / np.maximum(self._grid.volumes(), 1e-300)

    def _density_at(self, pos):
        pos = np.atleast_2d(pos)
        cells = np.asarray(jax.device_get(
            self._grid.locate(jnp.asarray(pos, jnp.float32))))
        ok = cells >= 0
        out = np.zeros(len(pos))
        out[ok] = self._rho[cells[ok]]
        return out

    def _entity_position(self, keys, j, tag):
        g = self._grid
        lo = g.aabb_lo[j]
        hi = g.aabb_hi[j]
        pos = g.sites[j]                       # fallback: the site itself
        done = jnp.zeros(j.shape, bool)
        for r in range(self.rejection_rounds):
            u0, u1, u2 = _uniform3(keys, tag + 100 * r)
            u = jnp.stack([u0, u1, u2], axis=-1)
            cand = lo + u * (hi - lo)
            ok = (g.locate(cand) == j) & ~done
            pos = jnp.where(ok[..., None], cand, pos)
            done = done | ok
        return pos
