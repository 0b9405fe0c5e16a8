"""Polar spatial grids: Sphere2D (r,theta), Sphere3D (r,theta,phi),
Cylinder3D (R,phi,z).

Counterparts of the reference's Sphere2DSpatialGrid / Sphere3DSpatialGrid /
Cylinder3DSpatialGrid (ref: SKIRT/core/Sphere2DSpatialGrid.hpp,
Sphere3DSpatialGrid.hpp, Cylinder3DSpatialGrid.hpp): shells x polar cones
(x azimuthal half-planes), and annuli x half-planes x z-slabs.

Traversal strategy (vectorized): instead of the reference's per-surface
incremental index bookkeeping (whose cone/plane re-hit corner cases need
`nextafter` escape hatches, ref: PathSegmentGenerator.hpp:148-153), each
step computes the exact minimum positive crossing distance over the current
cell's bounding surfaces (sphere/cone/half-plane/cylinder/z-plane
quadratics in closed form, all lanes batched) and then *relocates* the
packet with a tiny absolute nudge past the border. locate() is a couple of
searchsorted calls — cheap, fully vectorized, and immune to bounce loops:
every step advances at least the nudge distance.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

_BIG = jnp.float32(3e38)


# ------------------------------------------------------------- primitives

def _sphere_out(pos, dirn, r_out):
    """Distance to the outer sphere |p + t d| = r_out (from inside)."""
    b = jnp.sum(pos * dirn, axis=-1)
    r2 = jnp.sum(pos * pos, axis=-1)
    disc = jnp.maximum(r_out * r_out - (r2 - b * b), 0.0)
    return jnp.maximum(-b + jnp.sqrt(disc), 0.0)


def _sphere_in(pos, dirn, r_in):
    """Distance to the inner sphere (heading inward, perihelion inside)."""
    b = jnp.sum(pos * dirn, axis=-1)
    r2 = jnp.sum(pos * pos, axis=-1)
    disc = r_in * r_in - (r2 - b * b)
    t = -b - jnp.sqrt(jnp.maximum(disc, 0.0))
    ok = (r_in > 0) & (b < 0) & (disc > 0) & (t > 0)
    return jnp.where(ok, t, _BIG)


def _cone_cross(pos, dirn, c, eta):
    """Min crossing distance (> eta) with the polar cone cos(theta) = c
    (sign of z must match sign of c on the crossing point). c == +-1 (the
    axis) and degenerate setups return _BIG."""
    x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]
    dx, dy, dz = dirn[..., 0], dirn[..., 1], dirn[..., 2]
    c2 = c * c
    pd = x * dx + y * dy + z * dz
    r2 = x * x + y * y + z * z
    A = dz * dz - c2
    B = z * dz - c2 * pd
    C = z * z - c2 * r2

    is_plane = jnp.abs(c) < 1e-7       # theta = pi/2: the z=0 plane
    t_plane = jnp.where(jnp.abs(dz) > 1e-30, -z / jnp.where(
        jnp.abs(dz) > 1e-30, dz, 1.0), _BIG)
    t_plane = jnp.where(t_plane > eta, t_plane, _BIG)

    # quadratic A t^2 + 2 B t + C = 0
    disc = B * B - A * C
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    safe_A = jnp.where(jnp.abs(A) > 1e-30, A, 1.0)
    t1 = (-B - sq) / safe_A
    t2 = (-B + sq) / safe_A
    # linear fallback when A ~ 0 (ray parallel to the cone)
    t_lin = jnp.where(jnp.abs(B) > 1e-30, -C / (2.0 * jnp.where(
        jnp.abs(B) > 1e-30, B, 1.0)), _BIG)
    lin = jnp.abs(A) < 1e-12 * (dz * dz + c2 + 1e-30)

    def valid(t):
        zc = z + t * dz
        ok = (t > eta) & (disc >= 0) & (jnp.sign(zc) == jnp.sign(c))
        return jnp.where(ok, t, _BIG)

    t_quad = jnp.minimum(valid(jnp.where(lin, t_lin, t1)),
                         valid(jnp.where(lin, _BIG, t2)))
    axis = jnp.abs(c) > 1 - 1e-7
    return jnp.where(axis, _BIG, jnp.where(is_plane, t_plane, t_quad))


def _halfplane_cross(pos, dirn, phi_b, eta):
    """Min crossing distance (> eta) with the azimuthal half-plane at
    angle phi_b (the half with x cos + y sin > 0)."""
    cb = jnp.cos(phi_b)
    sb = jnp.sin(phi_b)
    x, y = pos[..., 0], pos[..., 1]
    dx, dy = dirn[..., 0], dirn[..., 1]
    num = -(x * sb - y * cb)
    den = dx * sb - dy * cb
    t = jnp.where(jnp.abs(den) > 1e-30, num / jnp.where(
        jnp.abs(den) > 1e-30, den, 1.0), _BIG)
    on_half = (x + t * dx) * cb + (y + t * dy) * sb > 0
    return jnp.where((t > eta) & on_half, t, _BIG)


def _theta_of(pos):
    rho = jnp.hypot(pos[..., 0], pos[..., 1])
    return jnp.arctan2(rho, pos[..., 2])          # [0, pi]


def _phi_of(pos):
    return jnp.arctan2(pos[..., 1], pos[..., 0])  # [-pi, pi]


# -------------------------------------------------------------- Sphere2D

class Sphere2DGrid(NamedTuple):
    """Axisymmetric shells x polar cones (ref: Sphere2DSpatialGrid)."""

    rb: jax.Array   # (nr+1,) shell radii, rb[0] >= 0
    tb: jax.Array   # (nt+1,) polar angle borders [rad], tb[0]=0, tb[-1]=pi

    @property
    def nr(self) -> int:
        return self.rb.shape[0] - 1

    @property
    def nt(self) -> int:
        return self.tb.shape[0] - 1

    @property
    def ncells(self) -> int:
        return self.nr * self.nt

    def _eta(self):
        return 1e-6 * self.rb[-1]

    def locate(self, pos: jax.Array) -> jax.Array:
        r = jnp.linalg.norm(pos, axis=-1)
        th = _theta_of(pos)
        ir = jnp.searchsorted(self.rb, r, side="right") - 1
        it = jnp.clip(jnp.searchsorted(self.tb, th, side="right") - 1,
                      0, self.nt - 1)
        inside = (r >= self.rb[0]) & (r < self.rb[-1])
        cell = jnp.clip(ir, 0, self.nr - 1) * self.nt + it
        return jnp.where(inside, cell, -1).astype(jnp.int32)

    def step(self, pos: jax.Array, dirn: jax.Array, cell: jax.Array):
        eta = self._eta()
        i = jnp.maximum(cell, 0)
        ir = i // self.nt
        it = i % self.nt
        t_out = _sphere_out(pos, dirn, self.rb[ir + 1])
        t_in = _sphere_in(pos, dirn, self.rb[ir])
        t_up = _cone_cross(pos, dirn, jnp.cos(self.tb[it]), eta)
        t_dn = _cone_cross(pos, dirn, jnp.cos(self.tb[it + 1]), eta)
        ds = jnp.minimum(jnp.minimum(t_out, t_in), jnp.minimum(t_up, t_dn))
        newpos = pos + ds[..., None] * dirn
        nxt = self.locate(pos + (ds + eta)[..., None] * dirn)
        was_outside = cell < 0
        return (jnp.where(was_outside, 0.0, ds),
                jnp.where(was_outside, -1, nxt),
                jnp.where(was_outside[..., None], pos, newpos))

    def move_inside(self, pos: jax.Array, dirn: jax.Array):
        R = self.rb[-1]
        b = jnp.sum(pos * dirn, axis=-1)
        r2 = jnp.sum(pos * pos, axis=-1)
        disc = R * R - (r2 - b * b)
        t = jnp.where(disc > 0, -b - jnp.sqrt(jnp.maximum(disc, 0.0)), _BIG)
        t = jnp.maximum(t, 0.0) + self._eta()
        already = self.locate(pos) >= 0
        t = jnp.where(already, 0.0, t)
        newpos = pos + t[..., None] * dirn
        return newpos, self.locate(newpos), t

    def volumes(self) -> np.ndarray:
        rb = np.asarray(self.rb, np.float64)
        tb = np.asarray(self.tb, np.float64)
        shell = 2.0 * np.pi / 3.0 * (rb[1:] ** 3 - rb[:-1] ** 3)
        band = np.cos(tb[:-1]) - np.cos(tb[1:])
        return (shell[:, None] * band[None, :]).reshape(-1)

    def cell_centers(self) -> jax.Array:
        rc = 0.5 * (self.rb[1:] + self.rb[:-1])
        tc = 0.5 * (self.tb[1:] + self.tb[:-1])
        R, T = jnp.meshgrid(rc, tc, indexing="ij")
        return jnp.stack([(R * jnp.sin(T)).reshape(-1),
                          jnp.zeros(self.ncells),
                          (R * jnp.cos(T)).reshape(-1)], axis=-1)

    def cell_jitter_halfwidths(self) -> np.ndarray:
        rb = np.asarray(self.rb, np.float64)
        tb = np.asarray(self.tb, np.float64)
        dr = np.diff(rb)
        rc = 0.5 * (rb[1:] + rb[:-1])
        dt = np.diff(tb)
        harc = np.minimum.outer(rc, dt) * 0.5  # (nr, nt) arc half-extent
        hr = np.repeat(dr * 0.5, self.nt).reshape(self.nr, self.nt)
        h = np.minimum(hr, harc).reshape(-1)
        return np.stack([h, h, h], axis=-1)

    def diagonal(self) -> float:
        return float(2 * np.asarray(self.rb)[-1])

    def max_steps(self) -> int:
        return 4 * self.nr + 4 * self.nt + 8


def make_sphere2d(r_max: float, nr: int, nt: int, r_min: float = 0.0,
                  log_r: bool = False, rb=None, tb=None) -> Sphere2DGrid:
    if rb is not None:
        rb = np.asarray(rb, np.float64)
    elif log_r:
        rb = np.concatenate([[0.0], np.geomspace(max(r_min, r_max * 1e-4),
                                                 r_max, nr)])
    else:
        rb = np.linspace(r_min, r_max, nr + 1)
    if tb is None:
        tb = np.linspace(0.0, np.pi, nt + 1)
    return Sphere2DGrid(rb=jnp.asarray(rb, jnp.float32),
                        tb=jnp.asarray(tb, jnp.float32))


# -------------------------------------------------------------- Sphere3D

class Sphere3DGrid(NamedTuple):
    """Shells x cones x azimuthal half-planes (ref: Sphere3DSpatialGrid)."""

    rb: jax.Array   # (nr+1,)
    tb: jax.Array   # (nt+1,)
    pb: jax.Array   # (np+1,) azimuth borders [rad] in [-pi, pi], ascending

    @property
    def nr(self) -> int:
        return self.rb.shape[0] - 1

    @property
    def nt(self) -> int:
        return self.tb.shape[0] - 1

    @property
    def nphi(self) -> int:
        return self.pb.shape[0] - 1

    @property
    def ncells(self) -> int:
        return self.nr * self.nt * self.nphi

    def _eta(self):
        return 1e-6 * self.rb[-1]

    def locate(self, pos: jax.Array) -> jax.Array:
        r = jnp.linalg.norm(pos, axis=-1)
        th = _theta_of(pos)
        ph = _phi_of(pos)
        ir = jnp.searchsorted(self.rb, r, side="right") - 1
        it = jnp.clip(jnp.searchsorted(self.tb, th, side="right") - 1,
                      0, self.nt - 1)
        ip = jnp.clip(jnp.searchsorted(self.pb, ph, side="right") - 1,
                      0, self.nphi - 1)
        inside = (r >= self.rb[0]) & (r < self.rb[-1])
        cell = (jnp.clip(ir, 0, self.nr - 1) * self.nt + it) * self.nphi + ip
        return jnp.where(inside, cell, -1).astype(jnp.int32)

    def step(self, pos: jax.Array, dirn: jax.Array, cell: jax.Array):
        eta = self._eta()
        i = jnp.maximum(cell, 0)
        ip = i % self.nphi
        it = (i // self.nphi) % self.nt
        ir = i // (self.nphi * self.nt)
        t_out = _sphere_out(pos, dirn, self.rb[ir + 1])
        t_in = _sphere_in(pos, dirn, self.rb[ir])
        t_up = _cone_cross(pos, dirn, jnp.cos(self.tb[it]), eta)
        t_dn = _cone_cross(pos, dirn, jnp.cos(self.tb[it + 1]), eta)
        t_p0 = _halfplane_cross(pos, dirn, self.pb[ip], eta)
        t_p1 = _halfplane_cross(pos, dirn, self.pb[ip + 1], eta)
        ds = jnp.minimum(jnp.minimum(jnp.minimum(t_out, t_in),
                                     jnp.minimum(t_up, t_dn)),
                         jnp.minimum(t_p0, t_p1))
        newpos = pos + ds[..., None] * dirn
        nxt = self.locate(pos + (ds + eta)[..., None] * dirn)
        was_outside = cell < 0
        return (jnp.where(was_outside, 0.0, ds),
                jnp.where(was_outside, -1, nxt),
                jnp.where(was_outside[..., None], pos, newpos))

    def move_inside(self, pos: jax.Array, dirn: jax.Array):
        R = self.rb[-1]
        b = jnp.sum(pos * dirn, axis=-1)
        r2 = jnp.sum(pos * pos, axis=-1)
        disc = R * R - (r2 - b * b)
        t = jnp.where(disc > 0, -b - jnp.sqrt(jnp.maximum(disc, 0.0)), _BIG)
        t = jnp.maximum(t, 0.0) + self._eta()
        already = self.locate(pos) >= 0
        t = jnp.where(already, 0.0, t)
        newpos = pos + t[..., None] * dirn
        return newpos, self.locate(newpos), t

    def volumes(self) -> np.ndarray:
        rb = np.asarray(self.rb, np.float64)
        tb = np.asarray(self.tb, np.float64)
        pb = np.asarray(self.pb, np.float64)
        shell = (rb[1:] ** 3 - rb[:-1] ** 3) / 3.0
        band = np.cos(tb[:-1]) - np.cos(tb[1:])
        wedge = np.diff(pb)
        v = shell[:, None, None] * band[None, :, None] * wedge[None, None, :]
        return v.reshape(-1)

    def cell_centers(self) -> jax.Array:
        rc = 0.5 * (self.rb[1:] + self.rb[:-1])
        tc = 0.5 * (self.tb[1:] + self.tb[:-1])
        pc = 0.5 * (self.pb[1:] + self.pb[:-1])
        R, T, P = jnp.meshgrid(rc, tc, pc, indexing="ij")
        return jnp.stack([(R * jnp.sin(T) * jnp.cos(P)).reshape(-1),
                          (R * jnp.sin(T) * jnp.sin(P)).reshape(-1),
                          (R * jnp.cos(T)).reshape(-1)], axis=-1)

    def cell_jitter_halfwidths(self) -> np.ndarray:
        vols = np.asarray(self.volumes(), np.float64)
        h = 0.5 * np.cbrt(vols)
        return np.stack([h, h, h], axis=-1)

    def diagonal(self) -> float:
        return float(2 * np.asarray(self.rb)[-1])

    def max_steps(self) -> int:
        return 4 * self.nr + 4 * self.nt + 2 * self.nphi + 10


def make_sphere3d(r_max: float, nr: int, nt: int, nphi: int,
                  r_min: float = 0.0, rb=None, tb=None) -> Sphere3DGrid:
    if nphi < 3:
        raise ValueError("Sphere3D needs >= 3 azimuth bins (half-plane "
                         "traversal assumes wedge spans < pi)")
    if rb is None:
        rb = np.linspace(r_min, r_max, nr + 1)
    if tb is None:
        tb = np.linspace(0.0, np.pi, nt + 1)
    pb = np.linspace(-np.pi, np.pi, nphi + 1)
    return Sphere3DGrid(rb=jnp.asarray(rb, jnp.float32),
                        tb=jnp.asarray(tb, jnp.float32),
                        pb=jnp.asarray(pb, jnp.float32))


# ------------------------------------------------------------ Cylinder3D

class Cylinder3DGrid(NamedTuple):
    """Annuli x azimuth half-planes x z-slabs (ref: Cylinder3DSpatialGrid)."""

    rb: jax.Array   # (nr+1,)
    pb: jax.Array   # (np+1,)
    zb: jax.Array   # (nz+1,)

    @property
    def nr(self) -> int:
        return self.rb.shape[0] - 1

    @property
    def nphi(self) -> int:
        return self.pb.shape[0] - 1

    @property
    def nz(self) -> int:
        return self.zb.shape[0] - 1

    @property
    def ncells(self) -> int:
        return self.nr * self.nphi * self.nz

    def _eta(self):
        return 1e-6 * jnp.maximum(self.rb[-1], self.zb[-1] - self.zb[0])

    def locate(self, pos: jax.Array) -> jax.Array:
        R = jnp.hypot(pos[..., 0], pos[..., 1])
        ph = _phi_of(pos)
        z = pos[..., 2]
        ir = jnp.searchsorted(self.rb, R, side="right") - 1
        ip = jnp.clip(jnp.searchsorted(self.pb, ph, side="right") - 1,
                      0, self.nphi - 1)
        iz = jnp.searchsorted(self.zb, z, side="right") - 1
        inside = ((R >= self.rb[0]) & (R < self.rb[-1])
                  & (z >= self.zb[0]) & (z < self.zb[-1]))
        cell = (jnp.clip(ir, 0, self.nr - 1) * self.nphi + ip) * self.nz \
            + jnp.clip(iz, 0, self.nz - 1)
        return jnp.where(inside, cell, -1).astype(jnp.int32)

    def step(self, pos: jax.Array, dirn: jax.Array, cell: jax.Array):
        eta = self._eta()
        i = jnp.maximum(cell, 0)
        iz = i % self.nz
        ip = (i // self.nz) % self.nphi
        ir = i // (self.nz * self.nphi)
        x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]
        dx, dy, dz = dirn[..., 0], dirn[..., 1], dirn[..., 2]
        q = dx * dx + dy * dy
        b = x * dx + y * dy
        R2 = x * x + y * y
        safe_q = jnp.maximum(q, 1e-30)
        r_out = self.rb[ir + 1]
        r_in = self.rb[ir]
        disc_out = jnp.maximum(b * b + safe_q * (r_out * r_out - R2), 0.0)
        t_out = jnp.where(q > 1e-30,
                          jnp.maximum((-b + jnp.sqrt(disc_out)) / safe_q, 0.0),
                          _BIG)
        disc_in = b * b + safe_q * (r_in * r_in - R2)
        can_in = (r_in > 0) & (b < 0) & (disc_in > 0) & (q > 1e-30)
        t_in = jnp.where(can_in,
                         (-b - jnp.sqrt(jnp.maximum(disc_in, 0.0))) / safe_q,
                         _BIG)
        t_in = jnp.where(t_in > 0, t_in, _BIG)
        t_p0 = _halfplane_cross(pos, dirn, self.pb[ip], eta)
        t_p1 = _halfplane_cross(pos, dirn, self.pb[ip + 1], eta)
        z_tgt = jnp.where(dz > 0, self.zb[iz + 1], self.zb[iz])
        t_z = jnp.where(jnp.abs(dz) < 1e-30, _BIG,
                        jnp.maximum((z_tgt - z) / jnp.where(
                            jnp.abs(dz) < 1e-30, 1.0, dz), 0.0))
        ds = jnp.minimum(jnp.minimum(jnp.minimum(t_out, t_in),
                                     jnp.minimum(t_p0, t_p1)), t_z)
        newpos = pos + ds[..., None] * dirn
        nxt = self.locate(pos + (ds + eta)[..., None] * dirn)
        was_outside = cell < 0
        return (jnp.where(was_outside, 0.0, ds),
                jnp.where(was_outside, -1, nxt),
                jnp.where(was_outside[..., None], pos, newpos))

    def move_inside(self, pos: jax.Array, dirn: jax.Array):
        R_out = self.rb[-1]
        x, y = pos[..., 0], pos[..., 1]
        dx, dy, dz = dirn[..., 0], dirn[..., 1], dirn[..., 2]
        q = jnp.maximum(dx * dx + dy * dy, 1e-30)
        b = x * dx + y * dy
        disc = b * b + q * (R_out * R_out - (x * x + y * y))
        t_cyl = jnp.where(disc > 0,
                          (-b - jnp.sqrt(jnp.maximum(disc, 0.0))) / q, _BIG)
        dzs = jnp.where(jnp.abs(dz) < 1e-30, 1e-30, dz)
        t_slab = jnp.minimum((self.zb[0] - pos[..., 2]) / dzs,
                             (self.zb[-1] - pos[..., 2]) / dzs)
        t = jnp.maximum(jnp.maximum(t_cyl, t_slab), 0.0) + self._eta()
        already = self.locate(pos) >= 0
        t = jnp.where(already, 0.0, t)
        newpos = pos + t[..., None] * dirn
        return newpos, self.locate(newpos), t

    def volumes(self) -> np.ndarray:
        rb = np.asarray(self.rb, np.float64)
        pb = np.asarray(self.pb, np.float64)
        zb = np.asarray(self.zb, np.float64)
        ring = 0.5 * (rb[1:] ** 2 - rb[:-1] ** 2)
        v = (ring[:, None, None] * np.diff(pb)[None, :, None]
             * np.diff(zb)[None, None, :])
        return v.reshape(-1)

    def cell_centers(self) -> jax.Array:
        rc = 0.5 * (self.rb[1:] + self.rb[:-1])
        pc = 0.5 * (self.pb[1:] + self.pb[:-1])
        zc = 0.5 * (self.zb[1:] + self.zb[:-1])
        R, P, Z = jnp.meshgrid(rc, pc, zc, indexing="ij")
        return jnp.stack([(R * jnp.cos(P)).reshape(-1),
                          (R * jnp.sin(P)).reshape(-1),
                          Z.reshape(-1)], axis=-1)

    def cell_jitter_halfwidths(self) -> np.ndarray:
        vols = np.asarray(self.volumes(), np.float64)
        h = 0.5 * np.cbrt(vols)
        return np.stack([h, h, h], axis=-1)

    def diagonal(self) -> float:
        rb = np.asarray(self.rb, np.float64)
        zb = np.asarray(self.zb, np.float64)
        return float(np.hypot(2 * rb[-1], zb[-1] - zb[0]))

    def max_steps(self) -> int:
        return 4 * self.nr + 2 * self.nphi + 2 * self.nz + 10


def make_cylinder3d(r_max: float, z_min: float, z_max: float,
                    nr: int, nphi: int, nz: int,
                    rb=None, zb=None) -> Cylinder3DGrid:
    if nphi < 3:
        raise ValueError("Cylinder3D needs >= 3 azimuth bins")
    if rb is None:
        rb = np.linspace(0.0, r_max, nr + 1)
    pb = np.linspace(-np.pi, np.pi, nphi + 1)
    if zb is None:
        zb = np.linspace(z_min, z_max, nz + 1)
    return Cylinder3DGrid(rb=jnp.asarray(rb, jnp.float32),
                          pb=jnp.asarray(pb, jnp.float32),
                          zb=jnp.asarray(zb, jnp.float32))
