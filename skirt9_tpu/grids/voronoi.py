"""Voronoi spatial grid: scipy/Qhull host build + bisector-walk traversal.

Batched counterpart of the reference's VoronoiMeshSpatialGrid /
VoronoiMeshSnapshot (ref: SKIRT/core/VoronoiMeshSnapshot.cpp:557-663 build
via embedded Voro++, :1058-1140 bisector-plane ray walk). Differences by
design:

  * the tessellation's neighbor graph comes from the Delaunay ridges of
    scipy.spatial (Qhull) instead of Voro++ cell computation;
  * neighbor lists are padded to a fixed max degree -> dense (ncells, D)
    tables; the per-step exit search is a vectorized min over the D
    bisector planes (the reference's loop over cell faces);
  * point location uses a coarse Cartesian lookup table of nearest sites
    plus a monotone neighbor walk (replaces the reference's BoxSearch tree);
  * cell volumes are exact clipped-polyhedron volumes: interior cells from
    the Qhull Voronoi region vertices, wall cells by halfspace intersection
    of the bisector planes with the box faces (matches the reference's
    exact Voro++ volumes, VoronoiMeshSnapshot.cpp:557-580); a Monte-Carlo
    estimate remains as fallback for degenerate cells.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

_BIG = jnp.float32(3e38)


class VoronoiGrid(NamedTuple):
    sites: jax.Array       # (N,3) f32 generator points
    neighbors: jax.Array   # (N,D) int32, padded with -1
    box_lo: jax.Array      # (3,)
    box_hi: jax.Array      # (3,)
    lookup: jax.Array      # (G,G,G) int32 nearest-site table for locate
    cell_volumes: jax.Array  # (N,) f32 exact cell volumes as fractions of
                             # the box volume (raw m^3 overflows f32)
    aabb_lo: jax.Array     # (N,3) f32 exact per-cell bounding boxes
    aabb_hi: jax.Array     # (N,3)
    walk_steps: int        # static: locate walk iteration bound

    @property
    def ncells(self) -> int:
        return self.sites.shape[0]

    # ---------------------------------------------------------------- locate

    def _guess(self, pos: jax.Array) -> jax.Array:
        G = self.lookup.shape[0]
        rel = (pos - self.box_lo) / (self.box_hi - self.box_lo)
        ig = jnp.clip((rel * G).astype(jnp.int32), 0, G - 1)
        return self.lookup[ig[..., 0], ig[..., 1], ig[..., 2]]

    def locate(self, pos: jax.Array) -> jax.Array:
        """Nearest-site cell via lookup-guess + monotone neighbor walk."""
        inside = jnp.all((pos >= self.box_lo) & (pos < self.box_hi), axis=-1)
        cell = self._guess(pos)

        def walk(c, _):
            nb = self.neighbors[c]                       # (B,D)
            cand = jnp.concatenate([c[..., None], nb], axis=-1)  # (B,D+1)
            spos = self.sites[jnp.maximum(cand, 0)]      # (B,D+1,3)
            d2 = jnp.sum((spos - pos[..., None, :]) ** 2, axis=-1)
            d2 = jnp.where(cand >= 0, d2, _BIG)
            best = jnp.argmin(d2, axis=-1)
            return jnp.take_along_axis(cand, best[..., None],
                                       axis=-1)[..., 0], None

        cell, _ = jax.lax.scan(walk, cell, None, length=self.walk_steps)
        return jnp.where(inside, cell, -1).astype(jnp.int32)

    # --------------------------------------------------------------- traversal

    def step(self, pos: jax.Array, dirn: jax.Array, cell: jax.Array):
        """Exit the current cell through the nearest bisector plane or the
        domain wall (ref bisector walk: VoronoiMeshSnapshot.cpp:1066)."""
        c = jnp.maximum(cell, 0)
        si = self.sites[c]                       # (B,3)
        nb = self.neighbors[c]                   # (B,D)
        sj = self.sites[jnp.maximum(nb, 0)]      # (B,D,3)

        # ray-bisector intersections: t = ((m-p).n) / (d.n), n = sj-si
        n = sj - si[:, None, :]
        m = 0.5 * (sj + si[:, None, :])
        dn = jnp.sum(dirn[:, None, :] * n, axis=-1)
        t = jnp.sum((m - pos[:, None, :]) * n, axis=-1) / \
            jnp.where(jnp.abs(dn) < 1e-30, jnp.float32(1.0), dn)
        t = jnp.where((nb >= 0) & (dn > 0) & (t > 0), t, _BIG)
        t_nb = jnp.min(t, axis=-1)
        j_nb = jnp.argmin(t, axis=-1)

        # domain-wall intersection
        tgt = jnp.where(dirn > 0, self.box_hi, self.box_lo)
        denom = jnp.where(jnp.abs(dirn) < 1e-30, jnp.float32(1.0), dirn)
        t_wall_ax = jnp.where(jnp.abs(dirn) < 1e-30, _BIG,
                              jnp.maximum((tgt - pos) / denom, 0.0))
        t_wall = jnp.min(t_wall_ax, axis=-1)

        hits_wall = t_wall <= t_nb
        ds = jnp.minimum(t_nb, t_wall)
        nxt = jnp.where(hits_wall, -1,
                        jnp.take_along_axis(nb, j_nb[..., None],
                                            axis=-1)[..., 0])
        # nudge to avoid landing exactly on the plane
        newpos = pos + (ds * (1.0 + 1e-6))[..., None] * dirn
        was_outside = cell < 0
        return (jnp.where(was_outside, 0.0, ds),
                jnp.where(was_outside, -1, nxt).astype(jnp.int32),
                jnp.where(was_outside[..., None], pos, newpos))

    def move_inside(self, pos: jax.Array, dirn: jax.Array):
        inv = 1.0 / jnp.where(jnp.abs(dirn) < 1e-30, 1e-30, dirn)
        t1 = (self.box_lo - pos) * inv
        t2 = (self.box_hi - pos) * inv
        tmin = jnp.max(jnp.minimum(t1, t2), axis=-1)
        tmax = jnp.min(jnp.maximum(t1, t2), axis=-1)
        hits = tmax > jnp.maximum(tmin, 0.0)
        already = jnp.all((pos >= self.box_lo) & (pos < self.box_hi), axis=-1)
        t_entry = jnp.where(already, 0.0, jnp.maximum(tmin, 0.0) * (1 + 1e-6))
        newpos = pos + t_entry[..., None] * dirn
        cell = jnp.where(already | hits, self.locate(newpos), -1)
        return newpos, cell.astype(jnp.int32), t_entry

    # ------------------------------------------------------------------- misc

    def volumes(self) -> np.ndarray:
        lo = np.asarray(self.box_lo, np.float64)
        hi = np.asarray(self.box_hi, np.float64)
        return np.asarray(self.cell_volumes, np.float64) * np.prod(hi - lo)

    def cell_centers(self) -> jax.Array:
        return self.sites

    def diagonal(self) -> float:
        lo = np.asarray(self.box_lo, np.float64)
        hi = np.asarray(self.box_hi, np.float64)
        return float(np.linalg.norm(hi - lo))

    def max_steps(self) -> int:
        # ~ sites crossed by a straight chord, with slack
        return int(4 * np.ceil(self.ncells ** (1 / 3))) + 16

    def cell_bounds(self):
        """Exact per-cell AABBs (for in-cell position sampling,
        ref: VoronoiMeshSnapshot::generatePosition bounding boxes)."""
        return (np.asarray(self.aabb_lo, np.float64),
                np.asarray(self.aabb_hi, np.float64))


def build_voronoi(sites: np.ndarray, extent, lookup_res: int = 32,
                  volume_samples: int = 200_000, seed: int = 11,
                  walk_steps: int | None = None) -> VoronoiGrid:
    """Host-side build: Delaunay neighbor graph + locate lookup + MC volumes.

    sites: (N,3) generator positions inside the extent box
    (ref: VoronoiMeshSnapshot build; site sources — random/density/imported —
    are the caller's concern, matching VoronoiMeshSpatialGrid policies).
    """
    from scipy.spatial import Delaunay, cKDTree

    sites = np.asarray(sites, np.float64)
    n = len(sites)
    lo = np.array([extent[a][0] for a in range(3)], np.float64)
    hi = np.array([extent[a][1] for a in range(3)], np.float64)

    # Delaunay adjacency == Voronoi face adjacency
    tri = Delaunay(sites)
    indptr, indices = tri.vertex_neighbor_vertices
    degree = np.diff(indptr)
    D = int(degree.max())
    neighbors = np.full((n, D), -1, np.int32)
    for i in range(n):
        nbs = indices[indptr[i]:indptr[i + 1]]
        neighbors[i, :len(nbs)] = nbs

    # coarse nearest-site lookup for locate()
    kdt = cKDTree(sites)
    G = lookup_res
    gx = np.linspace(lo[0], hi[0], G, endpoint=False) + (hi[0] - lo[0]) / (2 * G)
    gy = np.linspace(lo[1], hi[1], G, endpoint=False) + (hi[1] - lo[1]) / (2 * G)
    gz = np.linspace(lo[2], hi[2], G, endpoint=False) + (hi[2] - lo[2]) / (2 * G)
    pts = np.stack(np.meshgrid(gx, gy, gz, indexing="ij"), -1).reshape(-1, 3)
    _, owner = kdt.query(pts)
    lookup = owner.astype(np.int32).reshape(G, G, G)

    # exact clipped-polyhedron volume fractions + per-cell AABBs,
    # MC fallback for degenerate cells
    vols, blo, bhi = exact_volumes(sites, neighbors, lo, hi)
    bad = ~np.isfinite(vols) | (vols <= 0)
    if bad.any():
        rs = np.random.default_rng(seed)
        samp = lo + rs.uniform(size=(volume_samples, 3)) * (hi - lo)
        _, which = kdt.query(samp)
        counts = np.bincount(which, minlength=n).astype(np.float64)
        vols = np.where(bad, counts / volume_samples, vols)
        blo = np.where(bad[:, None], sites - 0.5 * (hi - lo) / n ** (1 / 3),
                       blo)
        bhi = np.where(bad[:, None], sites + 0.5 * (hi - lo) / n ** (1 / 3),
                       bhi)
    blo = np.clip(blo, lo, hi)
    bhi = np.clip(bhi, lo, hi)

    if walk_steps is None:
        walk_steps = max(8, int(2 * np.ceil(n ** (1 / 3))))

    return VoronoiGrid(
        sites=jnp.asarray(sites, jnp.float32),
        neighbors=jnp.asarray(neighbors),
        box_lo=jnp.asarray(lo, jnp.float32),
        box_hi=jnp.asarray(hi, jnp.float32),
        lookup=jnp.asarray(lookup),
        cell_volumes=jnp.asarray(vols, jnp.float32),
        aabb_lo=jnp.asarray(blo, jnp.float32),
        aabb_hi=jnp.asarray(bhi, jnp.float32),
        walk_steps=walk_steps,
    )


def lloyd_relax(sites: np.ndarray, extent, n_iter: int = 10,
                samples: int = 500_000, seed: int = 17) -> np.ndarray:
    """Lloyd (centroidal) relaxation of the site set: repeatedly replace
    each site by its cell's centroid, estimated with a shared Monte-Carlo
    sample through a KD nearest-site query (ref:
    VoronoiMeshSnapshot.cpp:609 relax option — the reference iterates
    Voro++ centroid computation; same fixed point, different estimator).
    Empty cells keep their site."""
    from scipy.spatial import cKDTree

    sites = np.array(sites, np.float64, copy=True)
    n = len(sites)
    lo = np.array([extent[a][0] for a in range(3)], np.float64)
    hi = np.array([extent[a][1] for a in range(3)], np.float64)
    rs = np.random.default_rng(seed)
    pts = lo + rs.uniform(size=(samples, 3)) * (hi - lo)
    for _ in range(n_iter):
        kdt = cKDTree(sites)
        _, owner = kdt.query(pts)
        cnt = np.bincount(owner, minlength=n)
        cen = np.stack([np.bincount(owner, weights=pts[:, a], minlength=n)
                        for a in range(3)], axis=-1)
        ok = cnt > 0
        sites[ok] = cen[ok] / cnt[ok, None]
    return sites


def exact_volumes(sites: np.ndarray, neighbors: np.ndarray,
                  lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Exact box-clipped Voronoi cell volumes.

    Interior cells whose Qhull region vertices all lie inside the box get
    the convex-hull volume of those vertices directly; wall cells are
    clipped by intersecting their bisector halfspaces with the box faces
    (scipy HalfspaceIntersection == the reference's Voro++ cell clipping,
    ref: VoronoiMeshSnapshot.cpp:557-580). Work happens in box-normalized
    coordinates for Qhull conditioning and returns volumes as FRACTIONS of
    the box volume (raw m^3 volumes overflow f32 at astrophysical scales).
    Returns NaN for cells where Qhull fails (caller falls back to MC).
    """
    from scipy.spatial import ConvexHull, HalfspaceIntersection, Voronoi

    n = len(sites)
    span = hi - lo
    s = (sites - lo) / span  # normalized to the unit box
    scale = 1.0  # unit-box fractions
    vor = Voronoi(s)
    vols = np.full(n, np.nan)
    blo = np.full((n, 3), np.nan)
    bhi = np.full((n, 3), np.nan)
    eps = 1e-9
    for i in range(n):
        reg = vor.regions[vor.point_region[i]]
        if reg and -1 not in reg:
            verts = vor.vertices[reg]
            if np.all((verts > -eps) & (verts < 1 + eps)):
                try:
                    vols[i] = ConvexHull(verts).volume * scale
                    blo[i] = verts.min(axis=0)
                    bhi[i] = verts.max(axis=0)
                except Exception:
                    pass
                continue
        # wall cell (or region escaping the box): halfspace clipping
        nbs = neighbors[i]
        nbs = nbs[nbs >= 0]
        p = s[i]
        d = s[nbs] - p                          # plane normals
        mid = 0.5 * (s[nbs] + p)
        # halfspaces A x + b <= 0: bisectors + the 6 box faces
        A = np.vstack([d, np.eye(3), -np.eye(3)])
        b = np.concatenate([-(d * mid).sum(1), -np.ones(3), np.zeros(3)])
        try:
            hsi = HalfspaceIntersection(np.hstack([A, b[:, None]]), p)
            vols[i] = ConvexHull(hsi.intersections).volume * scale
            blo[i] = hsi.intersections.min(axis=0)
            bhi[i] = hsi.intersections.max(axis=0)
        except Exception:
            pass
    return (vols, blo * span + lo, bhi * span + lo)


def density_sites(density_fn, extent, n_sites: int, seed: int = 3,
                  oversample: int = 40) -> np.ndarray:
    """Sample Voronoi sites from a density field by rejection
    (ref: VoronoiMeshSpatialGrid DustDensityDistribution site policy)."""
    rs = np.random.default_rng(seed)
    lo = np.array([extent[a][0] for a in range(3)])
    hi = np.array([extent[a][1] for a in range(3)])
    cand = lo + rs.uniform(size=(n_sites * oversample, 3)) * (hi - lo)
    w = np.maximum(density_fn(cand), 0.0)
    if w.sum() <= 0:
        raise ValueError("density is zero everywhere in the extent")
    idx = rs.choice(len(cand), size=n_sites, replace=False,
                    p=w / w.sum())
    return cand[idx]
