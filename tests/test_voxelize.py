"""Voxel rasters that carry non-Cartesian grids onto the domain
decomposition's x-slabs (parallel/domain.voxelize_for_dd): every voxel
belongs to the cell that the grid's own locate finds at its centre."""

import jax.numpy as jnp
import numpy as np
import pytest

from skirt9_tpu.grids.octree import build_octree
from skirt9_tpu.grids.voronoi import build_voronoi
from skirt9_tpu.media import system as msys
from skirt9_tpu.parallel import domain as dom


def _octree():
    def dens(p):
        return np.where(np.linalg.norm(p, axis=-1) < 0.6, 1.0, 0.05)
    return build_octree(((-1.0, 1.0),) * 3, dens, max_level=5, min_level=2,
                        max_fraction=2e-2)


def _voronoi():
    rs = np.random.default_rng(4)
    return build_voronoi(rs.uniform(-1, 1, (200, 3)), ((-1, 1),) * 3,
                         lookup_res=16, volume_samples=50_000)


@pytest.mark.parametrize("kind,n_slabs", [("octree", 4), ("voronoi", 3)])
def test_voxel_owners_match_locate(kind, n_slabs):
    grid = _octree() if kind == "octree" else _voronoi()
    nd = np.arange(1, grid.ncells + 1, dtype=np.float32)
    med = msys.make_medium(grid, nd, np.array([0.4e-6, 0.7e-6]),
                           sigma_ext=np.full((1, 2), 1.0),
                           albedo=np.full((1, 2), 0.5), g=np.zeros((1, 2)))
    vox, med_vox, cellmap = dom.voxelize_for_dd(grid, med, n_slabs)
    assert vox.shape[0] % n_slabs == 0
    cellmap = np.asarray(cellmap)
    want = np.asarray(grid.locate(jnp.asarray(vox.cell_centers())))
    agree = np.mean(cellmap == want)
    if kind == "octree":
        # leaves are unions of finest-level voxels: the raster is exact,
        # and each leaf's voxels add up to its volume
        assert agree == 1.0
        counts = np.bincount(cellmap, minlength=grid.ncells)
        np.testing.assert_allclose(counts * vox.volumes()[0],
                                   grid.volumes(), rtol=1e-5)
    else:
        # nearest-site owners: f32 ties may flip rare boundary voxels
        assert agree > 0.999
        assert vox.shape == (66, 66, 66)      # 64 rounded up to 3 slabs
    np.testing.assert_array_equal(np.asarray(med_vox.nd)[:, 0],
                                  nd[cellmap])
