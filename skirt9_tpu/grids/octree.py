"""Octree spatial grid: density-policy host build + flattened device traversal.

Batched re-design of the reference's tree grids (ref:
SKIRT/core/TreeSpatialGrid.hpp:28, PolicyTreeSpatialGrid, DensityTreePolicy
.hpp:76, OctTreeNode): the pointer tree with per-cell sorted neighbor lists
(TreeSpatialGrid.cpp:132-216) becomes four flat device arrays

  node_child (N,)   first-child index (8 contiguous children), -1 for leaves
  node_cell  (N,)   leaf -> cell index, -1 for internal nodes
  node_center (N,3) split center of each node
  cell_lo/cell_hi (ncells, 3)  leaf boxes

Traversal: a step exits the current leaf box (same boundary math as a
Cartesian cell) and relocates the neighbor by a fixed-depth top-down descent
from the root — O(max_level) gathers, branch-free, instead of the
reference's ragged neighbor-list walk (which does not vectorize). The exit
point is nudged along the direction by a relative epsilon (the role of the
reference's nextafter escape, ref: PathSegmentGenerator.hpp:148).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

_BIG = jnp.float32(3e38)


class OctreeGrid(NamedTuple):
    node_child: jax.Array   # (N,) int32
    node_cell: jax.Array    # (N,) int32
    node_center: jax.Array  # (N,3) f32
    cell_lo: jax.Array      # (ncells,3) f32
    cell_hi: jax.Array      # (ncells,3) f32
    box_lo: jax.Array       # (3,)
    box_hi: jax.Array       # (3,)
    levels: int             # static max depth

    @property
    def ncells(self) -> int:
        return self.cell_lo.shape[0]

    # ---------------------------------------------------------------- locate

    def locate(self, pos: jax.Array) -> jax.Array:
        """(B,3) -> (B,) leaf cell index, -1 outside the root box."""
        inside = jnp.all((pos >= self.box_lo) & (pos < self.box_hi), axis=-1)

        def descend(node, _):
            child = self.node_child[node]
            center = self.node_center[node]
            octant = ((pos[..., 0] >= center[..., 0]).astype(jnp.int32)
                      + 2 * (pos[..., 1] >= center[..., 1]).astype(jnp.int32)
                      + 4 * (pos[..., 2] >= center[..., 2]).astype(jnp.int32))
            nxt = jnp.where(child >= 0, child + octant, node)
            return nxt, None

        node0 = jnp.zeros(pos.shape[:-1], jnp.int32)
        node, _ = jax.lax.scan(descend, node0, None, length=self.levels)
        cell = self.node_cell[node]
        return jnp.where(inside, cell, -1).astype(jnp.int32)

    # --------------------------------------------------------------- traversal

    def step(self, pos: jax.Array, dirn: jax.Array, cell: jax.Array):
        """Exit the current leaf box; next cell via descent at the exit point."""
        c = jnp.maximum(cell, 0)
        lo = self.cell_lo[c]
        hi = self.cell_hi[c]
        tgt = jnp.where(dirn > 0, hi, lo)
        denom = jnp.where(jnp.abs(dirn) < 1e-30, jnp.float32(1.0), dirn)
        s = jnp.where(jnp.abs(dirn) < 1e-30, _BIG,
                      jnp.maximum((tgt - pos) / denom, 0.0))
        ds = jnp.min(s, axis=-1)
        newpos = pos + ds[..., None] * dirn
        # nudge past the face, relative to the local cell size
        eps = 1e-4 * jnp.min(hi - lo, axis=-1)
        probe = newpos + eps[..., None] * dirn
        nxt = self.locate(probe)
        was_outside = cell < 0
        return (
            jnp.where(was_outside, 0.0, ds),
            jnp.where(was_outside, -1, nxt),
            jnp.where(was_outside[..., None], pos, newpos),
        )

    def move_inside(self, pos: jax.Array, dirn: jax.Array):
        inv = 1.0 / jnp.where(jnp.abs(dirn) < 1e-30, 1e-30, dirn)
        t1 = (self.box_lo - pos) * inv
        t2 = (self.box_hi - pos) * inv
        tmin = jnp.max(jnp.minimum(t1, t2), axis=-1)
        tmax = jnp.min(jnp.maximum(t1, t2), axis=-1)
        hits = tmax > jnp.maximum(tmin, 0.0)
        already = self.locate(pos) >= 0
        t_entry = jnp.where(already, 0.0, jnp.maximum(tmin, 0.0) * (1.0 + 1e-6))
        newpos = pos + t_entry[..., None] * dirn
        cell = jnp.where(already | hits, self.locate(newpos), -1)
        return newpos, cell.astype(jnp.int32), t_entry

    # ------------------------------------------------------------------- misc

    def volumes(self) -> np.ndarray:
        """Cell volumes [m^3], host f64 (f32 products overflow at pc scale)."""
        d = np.asarray(self.cell_hi, np.float64) - np.asarray(self.cell_lo,
                                                              np.float64)
        return d[:, 0] * d[:, 1] * d[:, 2]

    def cell_centers(self) -> jax.Array:
        return 0.5 * (self.cell_lo + self.cell_hi)

    def cell_bounds(self):
        return np.asarray(self.cell_lo), np.asarray(self.cell_hi)

    def max_steps(self) -> int:
        # worst case ~ a straight line through the deepest refinement
        return 4 * (1 << self.levels) + 8


def build_octree(extent, density_fn, max_level: int = 6, min_level: int = 2,
                 max_fraction: float = 1e-2, samples: int = 64,
                 seed: int = 7, refine_fn=None) -> OctreeGrid:
    """Density-policy octree construction (host-side, numpy).

    Subdivide while a node contains more than `max_fraction` of the total
    mass (the reference's maxDustFraction criterion,
    ref: DensityTreePolicy.hpp:81) or is below min_level.

    density_fn(pos (N,3)) -> (N,) mass density (any normalization).
    refine_fn(lo (M,3), hi (M,3), level) -> (M,) bool overrides the
    density criterion entirely (custom TreePolicy analog: nested policies,
    site lists — ref: TreePolicy.hpp:27-32).
    """
    lo0 = np.array([extent[a][0] for a in range(3)], np.float64)
    hi0 = np.array([extent[a][1] for a in range(3)], np.float64)
    rs = np.random.default_rng(seed)

    def node_mass(lo, hi):
        # MC estimate of mass in boxes: lo, hi (M,3)
        u = rs.uniform(size=(samples, lo.shape[0], 3))
        pts = lo[None] + u * (hi - lo)[None]
        dens = density_fn(pts.reshape(-1, 3)).reshape(samples, -1)
        vol = np.prod(hi - lo, axis=-1)
        return dens.mean(axis=0) * vol

    total_mass = (max(node_mass(lo0[None], hi0[None])[0], 1e-300)
                  if density_fn is not None else 1.0)

    # BFS arrays
    nodes_lo = [lo0]
    nodes_hi = [hi0]
    node_child = [-1]
    node_level = [0]
    frontier = [0]
    level = 0
    while frontier and level < max_level:
        lo = np.array([nodes_lo[i] for i in frontier])
        hi = np.array([nodes_hi[i] for i in frontier])
        if level < min_level:
            refine = np.ones(len(frontier), bool)
        elif refine_fn is not None:
            refine = np.asarray(refine_fn(lo, hi, level), bool)
        else:
            m = node_mass(lo, hi)
            refine = m / total_mass > max_fraction
        new_frontier = []
        for idx, node_i in enumerate(frontier):
            if not refine[idx]:
                continue
            base = len(node_child)
            node_child[node_i] = base
            nlo = nodes_lo[node_i]
            nhi = nodes_hi[node_i]
            c = 0.5 * (nlo + nhi)
            for oct_ in range(8):
                sel = np.array([oct_ & 1, (oct_ >> 1) & 1, (oct_ >> 2) & 1])
                clo = np.where(sel, c, nlo)
                chi = np.where(sel, nhi, c)
                nodes_lo.append(clo)
                nodes_hi.append(chi)
                node_child.append(-1)
                node_level.append(level + 1)
                new_frontier.append(base + oct_)
        frontier = new_frontier
        level += 1

    node_child = np.asarray(node_child, np.int32)
    nodes_lo = np.asarray(nodes_lo)
    nodes_hi = np.asarray(nodes_hi)
    leaves = np.flatnonzero(node_child < 0)
    node_cell = np.full(len(node_child), -1, np.int32)
    node_cell[leaves] = np.arange(len(leaves), dtype=np.int32)

    return OctreeGrid(
        node_child=jnp.asarray(node_child),
        node_cell=jnp.asarray(node_cell),
        node_center=jnp.asarray(0.5 * (nodes_lo + nodes_hi), jnp.float32),
        cell_lo=jnp.asarray(nodes_lo[leaves], jnp.float32),
        cell_hi=jnp.asarray(nodes_hi[leaves], jnp.float32),
        box_lo=jnp.asarray(lo0, jnp.float32),
        box_hi=jnp.asarray(hi0, jnp.float32),
        levels=int(max(node_level)) + 1,
    )


def save_topology(grid: OctreeGrid, path: str) -> None:
    """Persist tree topology for reload (ref: TreeSpatialGridTopologyProbe /
    FileTreeSpatialGrid round trip)."""
    np.savez(path,
             node_child=np.asarray(grid.node_child),
             node_cell=np.asarray(grid.node_cell),
             node_center=np.asarray(grid.node_center),
             cell_lo=np.asarray(grid.cell_lo),
             cell_hi=np.asarray(grid.cell_hi),
             box_lo=np.asarray(grid.box_lo),
             box_hi=np.asarray(grid.box_hi),
             levels=grid.levels)


def load_topology(path: str) -> OctreeGrid:
    d = np.load(path)
    return OctreeGrid(
        node_child=jnp.asarray(d["node_child"]),
        node_cell=jnp.asarray(d["node_cell"]),
        node_center=jnp.asarray(d["node_center"]),
        cell_lo=jnp.asarray(d["cell_lo"]),
        cell_hi=jnp.asarray(d["cell_hi"]),
        box_lo=jnp.asarray(d["box_lo"]),
        box_hi=jnp.asarray(d["box_hi"]),
        levels=int(d["levels"]),
    )


def site_list_refine_fn(sites: np.ndarray, max_sites_per_leaf: int = 1):
    """TreePolicy that subdivides while a node holds more than
    `max_sites_per_leaf` sites (ref: SiteListTreePolicy.hpp — builds the
    tree from the positions of an imported site list so each site ends up
    in its own leaf, within the level bounds)."""
    sites = np.asarray(sites, np.float64)

    def refine(lo, hi, level):
        out = np.zeros(lo.shape[0], bool)
        for i in range(lo.shape[0]):
            inside = np.all((sites >= lo[i]) & (sites < hi[i]), axis=-1)
            out[i] = inside.sum() > max_sites_per_leaf
        return out

    return refine
