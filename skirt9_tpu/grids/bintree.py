"""Binary-tree spatial grid: k-d style alternate-axis splits.

Counterpart of the reference's BinTree variant of PolicyTreeSpatialGrid
(ref: SKIRT/core/BinTreeNode.hpp — each node splits in half along one axis,
cycling x, y, z with depth; a leaf three levels down equals one octree
child but intermediate leaves are anisotropic slabs). Device representation
mirrors grids/octree.py: flat node arrays with a fixed-depth top-down
descent for locate, axis-aligned leaf boxes for the march step.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

_BIG = jnp.float32(3e38)


class BinTreeGrid(NamedTuple):
    node_child: jax.Array   # (N,) first of 2 children, -1 for leaves
    node_axis: jax.Array    # (N,) split axis 0/1/2
    node_split: jax.Array   # (N,) split coordinate
    node_cell: jax.Array    # (N,) leaf -> cell, -1 internal
    cell_lo: jax.Array      # (ncells, 3)
    cell_hi: jax.Array      # (ncells, 3)
    box_lo: jax.Array
    box_hi: jax.Array
    levels: int             # max depth (splits)

    @property
    def ncells(self) -> int:
        return self.cell_lo.shape[0]

    def locate(self, pos: jax.Array) -> jax.Array:
        inside = jnp.all((pos >= self.box_lo) & (pos < self.box_hi), axis=-1)

        def descend(node, _):
            child = self.node_child[node]
            ax = self.node_axis[node]
            sp = self.node_split[node]
            val = jnp.take_along_axis(pos, ax[..., None], axis=-1)[..., 0]
            nxt = jnp.where(child >= 0,
                            child + (val >= sp).astype(jnp.int32), node)
            return nxt, None

        node0 = jnp.zeros(pos.shape[:-1], jnp.int32)
        node, _ = jax.lax.scan(descend, node0, None, length=self.levels)
        return jnp.where(inside, self.node_cell[node], -1).astype(jnp.int32)

    def step(self, pos: jax.Array, dirn: jax.Array, cell: jax.Array):
        c = jnp.maximum(cell, 0)
        lo = self.cell_lo[c]
        hi = self.cell_hi[c]
        tgt = jnp.where(dirn > 0, hi, lo)
        denom = jnp.where(jnp.abs(dirn) < 1e-30, jnp.float32(1.0), dirn)
        s = jnp.where(jnp.abs(dirn) < 1e-30, _BIG,
                      jnp.maximum((tgt - pos) / denom, 0.0))
        ds = jnp.min(s, axis=-1)
        newpos = pos + ds[..., None] * dirn
        eps = 1e-4 * jnp.min(hi - lo, axis=-1)
        probe = newpos + eps[..., None] * dirn
        nxt = self.locate(probe)
        was_outside = cell < 0
        return (jnp.where(was_outside, 0.0, ds),
                jnp.where(was_outside, -1, nxt),
                jnp.where(was_outside[..., None], pos, newpos))

    def move_inside(self, pos: jax.Array, dirn: jax.Array):
        inv = 1.0 / jnp.where(jnp.abs(dirn) < 1e-30, 1e-30, dirn)
        t1 = (self.box_lo - pos) * inv
        t2 = (self.box_hi - pos) * inv
        tmin = jnp.max(jnp.minimum(t1, t2), axis=-1)
        tmax = jnp.min(jnp.maximum(t1, t2), axis=-1)
        hits = tmax > jnp.maximum(tmin, 0.0)
        already = self.locate(pos) >= 0
        t_entry = jnp.where(already, 0.0,
                            jnp.maximum(tmin, 0.0) * (1.0 + 1e-6))
        newpos = pos + t_entry[..., None] * dirn
        cell = jnp.where(already | hits, self.locate(newpos), -1)
        return newpos, cell.astype(jnp.int32), t_entry

    def volumes(self) -> np.ndarray:
        d = np.asarray(self.cell_hi, np.float64) \
            - np.asarray(self.cell_lo, np.float64)
        return d[:, 0] * d[:, 1] * d[:, 2]

    def cell_centers(self) -> jax.Array:
        return 0.5 * (self.cell_lo + self.cell_hi)

    def cell_bounds(self):
        return np.asarray(self.cell_lo), np.asarray(self.cell_hi)

    def max_steps(self) -> int:
        return 4 * (1 << ((self.levels + 2) // 3)) * 3 + 8


def build_bintree(extent, density_fn, max_level: int = 18,
                  min_level: int = 6, max_fraction: float = 1e-2,
                  samples: int = 64, seed: int = 7,
                  refine_fn=None) -> BinTreeGrid:
    """Density-policy bintree construction: split the working axis in half
    while a node holds more than max_fraction of the total mass (levels
    count SPLITS, so one octree level == three bintree levels;
    ref: BinTreeNode.hpp + DensityTreePolicy)."""
    lo0 = np.array([extent[a][0] for a in range(3)], np.float64)
    hi0 = np.array([extent[a][1] for a in range(3)], np.float64)
    rs = np.random.default_rng(seed)

    def node_mass(lo, hi):
        u = rs.uniform(size=(samples, lo.shape[0], 3))
        pts = lo[None] + u * (hi - lo)[None]
        dens = density_fn(pts.reshape(-1, 3)).reshape(samples, -1)
        vol = np.prod(hi - lo, axis=-1)
        return dens.mean(axis=0) * vol

    total_mass = (max(node_mass(lo0[None], hi0[None])[0], 1e-300)
                  if density_fn is not None else 1.0)

    nodes_lo = [lo0]
    nodes_hi = [hi0]
    node_child = [-1]
    node_axis = [0]
    node_split = [0.0]
    frontier = [0]
    level = 0
    while frontier and level < max_level:
        ax = level % 3
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
            node_axis[node_i] = ax
            nlo = nodes_lo[node_i]
            nhi = nodes_hi[node_i]
            mid = 0.5 * (nlo[ax] + nhi[ax])
            node_split[node_i] = mid
            for half in range(2):
                clo = nlo.copy()
                chi = nhi.copy()
                if half == 0:
                    chi = chi.copy()
                    chi[ax] = mid
                else:
                    clo = clo.copy()
                    clo[ax] = mid
                nodes_lo.append(clo)
                nodes_hi.append(chi)
                node_child.append(-1)
                node_axis.append(0)
                node_split.append(0.0)
                new_frontier.append(base + half)
        frontier = new_frontier
        level += 1

    node_child = np.asarray(node_child, np.int32)
    nodes_lo = np.asarray(nodes_lo)
    nodes_hi = np.asarray(nodes_hi)
    leaves = np.flatnonzero(node_child < 0)
    node_cell = np.full(len(node_child), -1, np.int32)
    node_cell[leaves] = np.arange(len(leaves), dtype=np.int32)

    return BinTreeGrid(
        node_child=jnp.asarray(node_child),
        node_axis=jnp.asarray(np.asarray(node_axis, np.int32)),
        node_split=jnp.asarray(np.asarray(node_split, np.float32)),
        node_cell=jnp.asarray(node_cell),
        cell_lo=jnp.asarray(nodes_lo[leaves], jnp.float32),
        cell_hi=jnp.asarray(nodes_hi[leaves], jnp.float32),
        box_lo=jnp.asarray(lo0, jnp.float32),
        box_hi=jnp.asarray(hi0, jnp.float32),
        levels=int(level) + 1,
    )
