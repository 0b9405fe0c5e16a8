"""Cartesian spatial grid with arbitrary per-axis border meshes.

Batched replacement for the reference's CartesianSpatialGrid and its
pull-iterator segment generator (ref: SKIRT/core/CartesianSpatialGrid.cpp:87):
traversal is a branch-free, fully vectorized DDA step usable inside
`lax.scan` over a whole packet batch. Cell linear index m = (ix*ny + iy)*nz + iz.

All border arrays are f32 on device; the crossing coordinate is snapped
exactly onto the border at each step to prevent f32 drift (the reference's
`nextafter` escape hatch, ref: SKIRT/utils/PathSegmentGenerator.hpp:148,
is unnecessary under this scheme).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

_BIG = jnp.float32(3e38)


class CartesianGrid(NamedTuple):
    xb: jax.Array  # (nx+1,) x borders [m]
    yb: jax.Array  # (ny+1,)
    zb: jax.Array  # (nz+1,)

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.xb.shape[0] - 1, self.yb.shape[0] - 1, self.zb.shape[0] - 1)

    @property
    def ncells(self) -> int:
        nx, ny, nz = self.shape
        return nx * ny * nz

    # ---------------------------------------------------------------- indexing

    def split(self, cell: jax.Array):
        nx, ny, nz = self.shape
        iz = cell % nz
        iy = (cell // nz) % ny
        ix = cell // (ny * nz)
        return ix, iy, iz

    def join(self, ix, iy, iz):
        nx, ny, nz = self.shape
        return (ix * ny + iy) * nz + iz

    def locate(self, pos: jax.Array) -> jax.Array:
        """(B,3) -> (B,) cell index or -1 outside."""
        nx, ny, nz = self.shape
        ix = jnp.searchsorted(self.xb, pos[..., 0], side="right") - 1
        iy = jnp.searchsorted(self.yb, pos[..., 1], side="right") - 1
        iz = jnp.searchsorted(self.zb, pos[..., 2], side="right") - 1
        inside = (
            (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny) & (iz >= 0) & (iz < nz)
        )
        cell = self.join(jnp.clip(ix, 0, nx - 1), jnp.clip(iy, 0, ny - 1),
                         jnp.clip(iz, 0, nz - 1))
        return jnp.where(inside, cell, -1).astype(jnp.int32)

    # --------------------------------------------------------------- traversal

    def step(self, pos: jax.Array, dirn: jax.Array, cell: jax.Array):
        """One DDA step: distance to cell exit, next cell, snapped next pos.

        Outside packets (cell < 0) return ds=0 and stay outside.
        """
        nx, ny, nz = self.shape
        ix, iy, iz = self.split(jnp.maximum(cell, 0))

        def axis(borders, i, n, x, d):
            pos_d = d > 0
            nxt = jnp.where(pos_d, borders[jnp.clip(i + 1, 0, n)], borders[jnp.clip(i, 0, n)])
            s = (nxt - x) / jnp.where(jnp.abs(d) < 1e-30, jnp.float32(1.0), d)
            s = jnp.where(jnp.abs(d) < 1e-30, _BIG, s)
            # guard against tiny negative due to rounding at a border
            s = jnp.maximum(s, 0.0)
            return s, nxt

        sx, bx = axis(self.xb, ix, nx, pos[..., 0], dirn[..., 0])
        sy, by = axis(self.yb, iy, ny, pos[..., 1], dirn[..., 1])
        sz, bz = axis(self.zb, iz, nz, pos[..., 2], dirn[..., 2])

        s_all = jnp.stack([sx, sy, sz], axis=-1)
        ax = jnp.argmin(s_all, axis=-1)
        ds = jnp.min(s_all, axis=-1)

        newpos = pos + ds[..., None] * dirn
        # snap the crossed coordinate exactly onto the border
        border = jnp.stack([bx, by, bz], axis=-1)
        newpos = jnp.where(jax.nn.one_hot(ax, 3, dtype=bool), border, newpos)

        stp = jnp.where(dirn >= 0, 1, -1).astype(ix.dtype)
        jx = ix + jnp.where(ax == 0, stp[..., 0], 0)
        jy = iy + jnp.where(ax == 1, stp[..., 1], 0)
        jz = iz + jnp.where(ax == 2, stp[..., 2], 0)
        inside = (jx >= 0) & (jx < nx) & (jy >= 0) & (jy < ny) & (jz >= 0) & (jz < nz)
        nxt_cell = jnp.where(
            inside,
            self.join(jnp.clip(jx, 0, nx - 1), jnp.clip(jy, 0, ny - 1), jnp.clip(jz, 0, nz - 1)),
            -1,
        ).astype(jnp.int32)

        was_outside = cell < 0
        return (
            jnp.where(was_outside, 0.0, ds),
            jnp.where(was_outside, -1, nxt_cell),
            jnp.where(was_outside[..., None], pos, newpos),
        )

    def move_inside(self, pos: jax.Array, dirn: jax.Array):
        """Advance packets launched outside the box to its surface
        (ref: SpatialGridPath::moveInside, SKIRT/utils/SpatialGridPath.hpp:115).

        Returns (pos', cell', distance). Packets already inside pass through;
        packets missing the box get cell -1.
        """
        lo = jnp.stack([self.xb[0], self.yb[0], self.zb[0]])
        hi = jnp.stack([self.xb[-1], self.yb[-1], self.zb[-1]])
        inv = 1.0 / jnp.where(jnp.abs(dirn) < 1e-30, 1e-30, dirn)
        t1 = (lo - pos) * inv
        t2 = (hi - pos) * inv
        tmin = jnp.max(jnp.minimum(t1, t2), axis=-1)
        tmax = jnp.min(jnp.maximum(t1, t2), axis=-1)
        hits = (tmax > jnp.maximum(tmin, 0.0))
        already = self.locate(pos) >= 0
        t_entry = jnp.where(already, 0.0, jnp.maximum(tmin, 0.0) * (1.0 + 1e-6))
        newpos = pos + t_entry[..., None] * dirn
        # rays entering exactly on the hi face (t_entry==0 there, e.g. a
        # subdomain ray starting on a slab border) would locate outside;
        # clamp entries just inside the box (~10 f32 ulps of the box size)
        eps = 1e-6 * (hi - lo)
        newpos = jnp.where(already[..., None], newpos,
                           jnp.clip(newpos, lo, hi - eps))
        cell = jnp.where(already | hits, self.locate(newpos), -1)
        return newpos, cell.astype(jnp.int32), t_entry

    # ------------------------------------------------------------------- misc

    def volumes(self) -> np.ndarray:
        """Cell volumes [m^3], host f64 — the product of parsec-scale edge
        lengths overflows f32 (2 pc cells -> ~2e47 m^3 > f32 max)."""
        dx = np.diff(np.asarray(self.xb, np.float64))
        dy = np.diff(np.asarray(self.yb, np.float64))
        dz = np.diff(np.asarray(self.zb, np.float64))
        return (dx[:, None, None] * dy[None, :, None]
                * dz[None, None, :]).reshape(-1)

    def cell_centers(self) -> jax.Array:
        cx = 0.5 * (self.xb[1:] + self.xb[:-1])
        cy = 0.5 * (self.yb[1:] + self.yb[:-1])
        cz = 0.5 * (self.zb[1:] + self.zb[:-1])
        g = jnp.stack(jnp.meshgrid(cx, cy, cz, indexing="ij"), axis=-1)
        return g.reshape(-1, 3)

    def diagonal(self) -> float:
        return float(np.sqrt(
            (self.xb[-1] - self.xb[0]) ** 2
            + (self.yb[-1] - self.yb[0]) ** 2
            + (self.zb[-1] - self.zb[0]) ** 2
        ))

    def max_steps(self) -> int:
        """Upper bound on cells crossed by one straight path."""
        nx, ny, nz = self.shape
        return nx + ny + nz + 3


def make_cartesian(extent, shape, meshes=None, force_general: bool = False):
    """Build a Cartesian grid.

    extent: ((xmin,xmax),(ymin,ymax),(zmin,zmax)) in meters
    shape: (nx, ny, nz)
    meshes: optional per-axis border arrays overriding linear spacing
    (ref: CartesianSpatialGrid with Mesh children, SKIRT/core/MeshSpatialGrid).

    Without custom meshes the UNIFORM grid variant is returned — its
    traversal needs no border-table gathers in the hot march.
    """
    if meshes is None and not force_general:
        lo = np.array([extent[a][0] for a in range(3)], np.float64)
        hi = np.array([extent[a][1] for a in range(3)], np.float64)
        n = np.array(shape, np.int64)
        h = (hi - lo) / n
        return UniformCartesianGrid(
            lo=jnp.asarray(lo, jnp.float32),
            hi=jnp.asarray(hi, jnp.float32),
            inv_h=jnp.asarray(1.0 / h, jnp.float32),
            h=jnp.asarray(h, jnp.float32),
            nx=int(shape[0]), ny=int(shape[1]), nz=int(shape[2]))
    borders = []
    for a in range(3):
        if meshes is not None and meshes[a] is not None:
            b = np.asarray(meshes[a], dtype=np.float64)
        else:
            b = np.linspace(extent[a][0], extent[a][1], shape[a] + 1)
        borders.append(jnp.asarray(b, dtype=jnp.float32))
    return CartesianGrid(xb=borders[0], yb=borders[1], zb=borders[2])


class UniformCartesianGrid(NamedTuple):
    """Uniform-spacing Cartesian grid: all traversal math is arithmetic —
    no border-table gathers in the hot march (the general CartesianGrid
    costs ~6 table gathers per step, this costs zero)."""

    lo: jax.Array     # (3,) box minimum [m]
    hi: jax.Array     # (3,) box maximum [m]
    inv_h: jax.Array  # (3,) 1/cell size
    h: jax.Array      # (3,) cell size
    nx: int
    ny: int
    nz: int

    @property
    def shape(self):
        return (self.nx, self.ny, self.nz)

    @property
    def ncells(self) -> int:
        return self.nx * self.ny * self.nz

    def split(self, cell):
        iz = cell % self.nz
        iy = (cell // self.nz) % self.ny
        ix = cell // (self.ny * self.nz)
        return ix, iy, iz

    def join(self, ix, iy, iz):
        return (ix * self.ny + iy) * self.nz + iz

    def locate(self, pos: jax.Array) -> jax.Array:
        rel = (pos - self.lo) * self.inv_h
        i = jnp.floor(rel).astype(jnp.int32)
        n = jnp.array([self.nx, self.ny, self.nz], jnp.int32)
        inside = jnp.all((i >= 0) & (i < n), axis=-1)
        i = jnp.clip(i, 0, n - 1)
        return jnp.where(inside, self.join(i[..., 0], i[..., 1], i[..., 2]),
                         -1).astype(jnp.int32)

    def step(self, pos: jax.Array, dirn: jax.Array, cell: jax.Array):
        ix, iy, iz = self.split(jnp.maximum(cell, 0))
        i3 = jnp.stack([ix, iy, iz], axis=-1)          # (B,3)
        pos_d = dirn > 0
        nxt_idx = i3 + pos_d.astype(i3.dtype)          # border index per axis
        border = self.lo + nxt_idx.astype(pos.dtype) * self.h
        tiny = jnp.abs(dirn) < 1e-30
        s = jnp.where(tiny, _BIG,
                      jnp.maximum((border - pos)
                                  / jnp.where(tiny, 1.0, dirn), 0.0))
        ax = jnp.argmin(s, axis=-1)
        ds = jnp.min(s, axis=-1)
        newpos = pos + ds[..., None] * dirn
        onehot = jax.nn.one_hot(ax, 3, dtype=bool)
        newpos = jnp.where(onehot, border, newpos)
        stp = jnp.where(dirn >= 0, 1, -1).astype(i3.dtype)
        j3 = i3 + jnp.where(onehot, stp, 0)
        n = jnp.array([self.nx, self.ny, self.nz], jnp.int32)
        inside = jnp.all((j3 >= 0) & (j3 < n), axis=-1)
        j3c = jnp.clip(j3, 0, n - 1)
        nxt = jnp.where(inside,
                        self.join(j3c[..., 0], j3c[..., 1], j3c[..., 2]),
                        -1).astype(jnp.int32)
        was_outside = cell < 0
        return (jnp.where(was_outside, 0.0, ds),
                jnp.where(was_outside, -1, nxt),
                jnp.where(was_outside[..., None], pos, newpos))

    def move_inside(self, pos: jax.Array, dirn: jax.Array):
        inv = 1.0 / jnp.where(jnp.abs(dirn) < 1e-30, 1e-30, dirn)
        t1 = (self.lo - pos) * inv
        t2 = (self.hi - pos) * inv
        tmin = jnp.max(jnp.minimum(t1, t2), axis=-1)
        tmax = jnp.min(jnp.maximum(t1, t2), axis=-1)
        hits = tmax > jnp.maximum(tmin, 0.0)
        already = self.locate(pos) >= 0
        t_entry = jnp.where(already, 0.0,
                            jnp.maximum(tmin, 0.0) * (1.0 + 1e-6))
        newpos = pos + t_entry[..., None] * dirn
        # clamp hi-face entries just inside (see CartesianGrid.move_inside)
        eps = 1e-6 * (self.hi - self.lo)
        newpos = jnp.where(already[..., None], newpos,
                           jnp.clip(newpos, self.lo, self.hi - eps))
        cell = jnp.where(already | hits, self.locate(newpos), -1)
        return newpos, cell.astype(jnp.int32), t_entry

    # ------------------------------------------------------------------- misc

    @property
    def xb(self):
        return self.lo[0] + jnp.arange(self.nx + 1) * self.h[0]

    @property
    def yb(self):
        return self.lo[1] + jnp.arange(self.ny + 1) * self.h[1]

    @property
    def zb(self):
        return self.lo[2] + jnp.arange(self.nz + 1) * self.h[2]

    def volumes(self) -> np.ndarray:
        h = np.asarray(self.h, np.float64)
        return np.full(self.ncells, h[0] * h[1] * h[2])

    def cell_centers(self) -> jax.Array:
        cx = self.lo[0] + (jnp.arange(self.nx) + 0.5) * self.h[0]
        cy = self.lo[1] + (jnp.arange(self.ny) + 0.5) * self.h[1]
        cz = self.lo[2] + (jnp.arange(self.nz) + 0.5) * self.h[2]
        g = jnp.stack(jnp.meshgrid(cx, cy, cz, indexing="ij"), axis=-1)
        return g.reshape(-1, 3)

    def cell_bounds(self):
        lo = np.asarray(self.lo, np.float64)
        h = np.asarray(self.h, np.float64)
        cx = lo[0] + np.arange(self.nx) * h[0]
        cy = lo[1] + np.arange(self.ny) * h[1]
        cz = lo[2] + np.arange(self.nz) * h[2]
        clo = np.stack(np.meshgrid(cx, cy, cz, indexing="ij"),
                       axis=-1).reshape(-1, 3)
        return clo, clo + h

    def diagonal(self) -> float:
        lo = np.asarray(self.lo, np.float64)
        hi = np.asarray(self.hi, np.float64)
        return float(np.linalg.norm(hi - lo))

    def max_steps(self) -> int:
        return self.nx + self.ny + self.nz + 3
