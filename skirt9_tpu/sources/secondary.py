"""Secondary (thermal dust) source: launch packets from cell emission spectra.

Counterpart of the reference's SecondarySourceSystem + DustSecondarySource
(ref: SKIRT/core/SecondarySourceSystem.cpp:84 prepareForLaunch,
DustSecondarySource.hpp:24,42-73): packets are distributed over cells with
the composite luminosity/uniform spatial bias (xi = spatialBias), each packet
samples its wavelength from its cell's equilibrium emission spectrum cdf and
launches isotropically from a uniform random position inside the cell.

Unlike the reference (thread-local lazy per-cell spectra), this design
precomputes the full (ncells, L) spectrum cdf table on device — the batched
equivalent, trading HBM for gather throughput; cell-chunked scheduling for
huge grids is a later optimization (SURVEY.md §7 hard part 4).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import rng


@dataclasses.dataclass(frozen=True)
class DustSecondarySource:
    """Static config; all device state lives in the tables dict
    (protocol: tables() -> dict consumed by launch(tabs, keys, n))."""

    luminosity: float          # total dust luminosity [W]
    spatial_bias: float = 0.5
    # aligned-spheroidal-grain polarized emission (SpheroidalEmissionProfile
    # below); None = isotropic unpolarized emission (the default)
    spheroidal: object = None
    _tables: dict = dataclasses.field(default=None, compare=False, hash=False,
                                      repr=False)

    def tables(self) -> dict:
        return self._tables

    @property
    def emission_phase(self):
        """Direct-peel-off angular emission profile (lifecycle protocol);
        present only for spheroidal polarized emission."""
        return (self.spheroidal.emission_phase
                if self.spheroidal is not None else None)

    @property
    def polarization(self):
        return self.spheroidal

    def launch(self, tabs: dict, keys: jax.Array, n_total: int) -> dict:
        # --- cell selection with bias correction
        cell_cdf = tabs["cell_cdf"]
        u_cell = rng.uniform(keys, rng.LAUNCH_CELL)
        cell = jnp.clip(jnp.searchsorted(cell_cdf, u_cell, side="right"),
                        0, cell_cdf.shape[0] - 1).astype(jnp.int32)
        # total luminosity flows through the TRACED tables: segment runners
        # are jit-cached per flow and reused across self-absorption
        # iterations whose source luminosity changes — a closed-over python
        # float would go stale (round-3 bugfix)
        lum = (tabs["lum_total"] / n_total) * tabs["cell_weight"][cell]

        # --- wavelength from the cell's emission spectrum cdf
        rows = tabs["spec_cdf"][cell]                   # (B, L)
        u_lam = rng.uniform(keys, rng.EMISSION_LAMBDA)
        borders = tabs["lam_borders"]
        from ..ops import sampling as _smp
        li = jnp.sum((rows < u_lam[:, None]).astype(jnp.int32), axis=1)
        li = jnp.clip(li, 0, rows.shape[1] - 1)
        c0 = jnp.where(li > 0,
                       _smp.take_along_small(rows, jnp.maximum(li - 1, 0)),
                       0.0)
        c1 = _smp.take_along_small(rows, li)
        frac = jnp.where(c1 > c0, (u_lam - c0) / jnp.maximum(c1 - c0, 1e-30), 0.5)
        b0 = _smp.take_small(borders, li)
        b1 = _smp.take_small(borders, li + 1)
        lam = b0 + frac * (b1 - b0)

        # --- uniform random position inside the cell
        # (ref: SpatialGrid::randomPositionInCell)
        u3 = jax.vmap(lambda k: jax.random.uniform(k, (3,)))(
            rng.purpose_key(keys, rng.LAUNCH_POSITION))
        lo = tabs["cell_lo"][cell]
        hi = tabs["cell_hi"][cell]
        pos = lo + u3 * (hi - lo)

        if self.spheroidal is not None:
            # aligned-grain polarized emission: direction from the
            # per-wavelength theta-CDF around the cell's B axis, Stokes
            # from (sigma_abs, sigma_abspol) at the sampled angle
            # (ref: DustSecondarySource.cpp:562-583 polarised branch)
            dirn = self.spheroidal.sample_direction(keys, lam, cell)
            stokes, normal = self.spheroidal.stokes_for(dirn, lam, cell)
            return {"lam": lam, "lum": lum, "pos": pos, "dir": dirn,
                    "stokes": stokes, "normal": normal}
        dirn = rng.isotropic_direction(keys, rng.LAUNCH_DIRECTION)
        return {"lam": lam, "lum": lum, "pos": pos, "dir": dirn}


def prepare(grid, L_cell, eps, ems_borders: np.ndarray,
            spatial_bias: float = 0.5) -> DustSecondarySource:
    """Build the secondary source from per-cell luminosities and spectra.

    L_cell (ncells,) bolometric dust luminosity; eps (ncells, L) emission
    spectrum (any per-cell normalization; only the shape matters for
    sampling). ems_borders (L+1,) wavelength borders.
    """
    L_np = np.asarray(L_cell, np.float64)
    total = float(L_np.sum())
    nonzero = L_np > 0
    n_nonzero = max(int(nonzero.sum()), 1)

    # composite bias over luminous cells (ref: SecondarySourceSystem.cpp:84):
    wl = np.where(nonzero, L_np / max(total, 1e-300), 0.0)
    xi = spatial_bias
    w = (1 - xi) * wl + xi * nonzero / n_nonzero
    wsum = w.sum()
    if wsum <= 0:
        w = np.full_like(w, 1.0 / len(w))
        wsum = 1.0
    w = w / wsum
    cdf = np.cumsum(w)
    weight = np.where(w > 0, wl / np.maximum(w, 1e-300), 0.0)

    # per-cell spectrum cdf over emission bins (bin-integrated weights)
    eps_np = np.asarray(eps, np.float64)
    dlam = np.diff(ems_borders)
    wspec = np.maximum(eps_np, 0.0) * dlam[None, :]
    tot = wspec.sum(axis=1, keepdims=True)
    spec_cdf = np.cumsum(wspec, axis=1) / np.maximum(tot, 1e-300)

    lo, hi = cell_bounds(grid)

    tables = {
        "lum_total": jnp.asarray(total, jnp.float32),
        "cell_cdf": jnp.asarray(cdf, jnp.float32),
        "cell_weight": jnp.asarray(weight, jnp.float32),
        "lam_borders": jnp.asarray(ems_borders, jnp.float32),
        "spec_cdf": jnp.asarray(spec_cdf, jnp.float32),
        "cell_lo": jnp.asarray(lo, jnp.float32),
        "cell_hi": jnp.asarray(hi, jnp.float32),
    }
    return DustSecondarySource(luminosity=total, spatial_bias=spatial_bias,
                               _tables=tables)


def prepare_device(grid, L_cell, eps, ems_borders: np.ndarray,
                   spatial_bias: float = 0.5,
                   bounds_dev=None) -> DustSecondarySource:
    """Device-resident variant of prepare(): the emission spectra stay on
    device (only the (ncells,) luminosities cross the link for the exact
    f64 launch cdf). bounds_dev: cached (cell_lo, cell_hi) device arrays.
    """
    L_np = np.asarray(L_cell, np.float64)       # small pull
    total = float(L_np.sum())
    nonzero = L_np > 0
    n_nonzero = max(int(nonzero.sum()), 1)
    wl = np.where(nonzero, L_np / max(total, 1e-300), 0.0)
    xi = spatial_bias
    w = (1 - xi) * wl + xi * nonzero / n_nonzero
    wsum = w.sum()
    if wsum <= 0:
        w = np.full_like(w, 1.0 / len(w))
        wsum = 1.0
    w = w / wsum
    cdf = np.cumsum(w)
    weight = np.where(w > 0, wl / np.maximum(w, 1e-300), 0.0)

    emsb = jnp.asarray(ems_borders, jnp.float32)
    dlam = emsb[1:] - emsb[:-1]
    wspec = jnp.maximum(eps, 0.0) * dlam[None, :]
    tot = jnp.sum(wspec, axis=1, keepdims=True)
    spec_cdf = jnp.cumsum(wspec, axis=1) / jnp.maximum(tot, 1e-30)

    if bounds_dev is None:
        lo, hi = cell_bounds(grid)
        bounds_dev = (jnp.asarray(lo, jnp.float32),
                      jnp.asarray(hi, jnp.float32))
    tables = {
        "lum_total": jnp.asarray(total, jnp.float32),
        "cell_cdf": jnp.asarray(cdf, jnp.float32),
        "cell_weight": jnp.asarray(weight, jnp.float32),
        "lam_borders": emsb,
        "spec_cdf": spec_cdf,
        "cell_lo": bounds_dev[0],
        "cell_hi": bounds_dev[1],
    }
    return DustSecondarySource(luminosity=total, spatial_bias=spatial_bias,
                               _tables=tables)


def cell_bounds(grid):
    """Axis-aligned bounds per cell for position sampling. Grids with
    non-box cells provide their own cell_bounds()."""
    if hasattr(grid, "cell_bounds"):
        return grid.cell_bounds()
    nx, ny, nz = grid.shape
    xb = np.asarray(grid.xb, np.float64)
    yb = np.asarray(grid.yb, np.float64)
    zb = np.asarray(grid.zb, np.float64)
    lo = np.stack(np.meshgrid(xb[:-1], yb[:-1], zb[:-1], indexing="ij"),
                  axis=-1).reshape(-1, 3)
    hi = np.stack(np.meshgrid(xb[1:], yb[1:], zb[1:], indexing="ij"),
                  axis=-1).reshape(-1, 3)
    return lo, hi


# -------------------------------------------- spheroidal polarized emission

@dataclasses.dataclass(frozen=True)
class SpheroidalEmissionProfile:
    """Aligned-grain polarized thermal emission for the dust secondary
    source (ref: DustCellPolarisedEmission in DustSecondarySource.cpp:
    generateDirection samples the zenith angle theta w.r.t. the cell's
    magnetic field from a CDF ~ sigma_abs(lambda, theta) sin(theta);
    polarizationForDirection returns (I, Q) = (sigma_abs, sigma_abspol)
    with reference direction k x B).

    All tables are device arrays; lookups avoid serialized XLA gathers
    (dense compare-reduce over the small theta axis, row gathers over
    the wavelength axis)."""

    tabs: dict
    # lifecycle protocol markers: emission_phase/stokes_for take
    # (..., lam, cell)
    wants_lam = True
    wants_cell = True

    @property
    def polarization(self):
        return self

    def _lam_nodes(self, lam):
        from ..ops import sampling as _smp
        lt = self.tabs["lam"]
        i = jnp.clip(_smp.searchsorted_right(lt, lam) - 1,
                     0, lt.shape[0] - 2)
        f = (lam - _smp.take_small(lt, i)) / jnp.maximum(
            _smp.take_small(lt, i + 1) - _smp.take_small(lt, i), 1e-37)
        return i, jnp.clip(f, 0.0, 1.0)

    def _interp2(self, name, lam, theta):
        """Bilinear (lambda, theta) lookup of tabs[name] per lane."""
        from ..ops import sampling as _smp
        i, fi = self._lam_nodes(lam)
        tt = self.tabs["theta"]
        j = jnp.clip(_smp.searchsorted_right(tt, theta) - 1,
                     0, tt.shape[0] - 2)
        fj = jnp.clip((theta - _smp.take_small(tt, j)) / jnp.maximum(
            _smp.take_small(tt, j + 1) - _smp.take_small(tt, j), 1e-37),
            0.0, 1.0)
        tab = self.tabs[name]
        r0 = tab[i]                      # (B, T) row gathers
        r1 = tab[i + 1]
        v00 = _smp.take_along_small(r0, j)
        v01 = _smp.take_along_small(r0, j + 1)
        v10 = _smp.take_along_small(r1, j)
        v11 = _smp.take_along_small(r1, j + 1)
        return ((1 - fi) * ((1 - fj) * v00 + fj * v01)
                + fi * ((1 - fj) * v10 + fj * v11))

    def _cell_b(self, cell):
        c = jnp.clip(cell, 0, self.tabs["bdir"].shape[0] - 1)
        b = self.tabs["bdir"][c]                          # (B, 3)
        ok = self.tabs["bok"][c] > 0.5
        return b, ok

    def _theta_of(self, k, b):
        return jnp.arccos(jnp.clip(jnp.sum(k * b, axis=-1), -1.0, 1.0))

    def emission_phase(self, kobs, pos, lam, cell):
        """Angular emission probability per sr toward the observer:
        sigma_abs(lambda, theta_obs) normalized so the sphere average is
        1/(4 pi); isotropic for cells without a magnetic field."""
        from ..ops import sampling as _smp
        B = lam.shape[0]
        ko = jnp.broadcast_to(kobs, (B, 3))
        b, ok = self._cell_b(cell)
        theta = self._theta_of(ko, b)
        sa = self._interp2("sabs", lam, theta)
        nrm = _smp.interp_linlin(lam, self.tabs["lam"], self.tabs["norm"])
        iso = 1.0 / (4.0 * jnp.pi)
        return jnp.where(ok, sa / (4.0 * jnp.pi * jnp.maximum(nrm, 1e-37)),
                         iso)

    def stokes_for(self, k, lam, cell):
        """Normalized Stokes state (I=1) + reference normal for emission
        into direction k: Q/I = sigma_abspol/sigma_abs at (lambda, theta),
        U = V = 0, normal = k x B (ref: polarizationForDirection)."""
        b, ok = self._cell_b(cell)
        theta = self._theta_of(k, b)
        sa = jnp.maximum(self._interp2("sabs", lam, theta), 1e-37)
        qr = jnp.where(ok, self._interp2("sabspol", lam, theta) / sa, 0.0)
        st = jnp.stack([jnp.ones_like(qr), qr,
                        jnp.zeros_like(qr), jnp.zeros_like(qr)], axis=-1)
        n = jnp.cross(k, b)
        nn = jnp.linalg.norm(n, axis=-1, keepdims=True)
        # degenerate (k parallel to B, or no field): any perpendicular
        # direction works (Q is ~0 there)
        fb = _any_perp(k)
        n = jnp.where(nn > 1e-6, n / jnp.maximum(nn, 1e-30), fb)
        return st, n

    def sample_direction(self, keys, lam, cell):
        """Emission direction: theta from the per-wavelength CDF around
        the cell's B axis, phi uniform; isotropic without a field."""
        from ..ops import sampling as _smp
        b, ok = self._cell_b(cell)
        i, fi = self._lam_nodes(lam)
        inode = jnp.where(fi > 0.5, i + 1, i)
        rows = self.tabs["cdf"][inode]                    # (B, T)
        u = rng.uniform(keys, rng.LAUNCH_DIRECTION + 13)
        j = jnp.sum((rows < u[:, None]).astype(jnp.int32), axis=1)
        j = jnp.clip(j, 1, rows.shape[1] - 1)
        c0 = _smp.take_along_small(rows, j - 1)
        c1 = _smp.take_along_small(rows, j)
        f = jnp.where(c1 > c0, (u - c0) / jnp.maximum(c1 - c0, 1e-30), 0.5)
        tt = self.tabs["theta"]
        th = _smp.take_small(tt, j - 1) + f * (
            _smp.take_small(tt, j) - _smp.take_small(tt, j - 1))
        phi = 2.0 * jnp.pi * rng.uniform(keys, rng.LAUNCH_DIRECTION + 14)
        e1 = _any_perp(b)
        e2 = jnp.cross(b, e1)
        st_ = jnp.sin(th)
        k = (jnp.cos(th)[:, None] * b
             + (st_ * jnp.cos(phi))[:, None] * e1
             + (st_ * jnp.sin(phi))[:, None] * e2)
        k_iso = rng.isotropic_direction(keys, rng.LAUNCH_DIRECTION)
        return jnp.where(ok[:, None], k, k_iso)


def _any_perp(v):
    """A unit vector perpendicular to each row of v (robust pick)."""
    ax = jnp.where(jnp.abs(v[:, 0:1]) < 0.9,
                   jnp.array([1.0, 0.0, 0.0], jnp.float32),
                   jnp.array([0.0, 1.0, 0.0], jnp.float32))
    e = jnp.cross(v, jnp.broadcast_to(ax, v.shape))
    n = jnp.linalg.norm(e, axis=-1, keepdims=True)
    # v ~ 0 (no field): return the axis itself
    return jnp.where(n > 1e-12, e / jnp.maximum(n, 1e-30),
                     jnp.broadcast_to(ax, v.shape))


def build_spheroidal_profile(sph, med) -> SpheroidalEmissionProfile:
    """Device profile from size-integrated tables
    (media.grains.SpheroidalEmissionTables) + the medium's per-cell
    magnetic field (MediumState.magneticField,
    ref: MediumSystem::magneticField)."""
    B = np.asarray(med.magnetic_field, np.float64)
    mag = np.linalg.norm(B, axis=-1)
    ok = mag > 0
    bdir = np.where(ok[:, None], B / np.maximum(mag, 1e-300)[:, None], 0.0)
    th = np.asarray(sph.theta, np.float64)
    sabs = np.asarray(sph.sabs, np.float64)
    w = sabs * np.sin(th)[None, :]
    # sphere average of the piecewise-LINEAR interpolant (what _interp2
    # evaluates): refine each theta segment so the emission_phase
    # normalization matches the interpolated profile, not just its nodes
    thf = np.interp(np.linspace(0, len(th) - 1, (len(th) - 1) * 32 + 1),
                    np.arange(len(th)), th)
    sabs_f = np.stack([np.interp(thf, th, row) for row in sabs])
    norm = 0.5 * np.trapezoid(sabs_f * np.sin(thf)[None, :], thf, axis=1)
    seg = 0.5 * (w[:, 1:] + w[:, :-1]) * np.diff(th)[None, :]
    cdf = np.concatenate([np.zeros((len(sabs), 1)), np.cumsum(seg, axis=1)],
                         axis=1)
    cdf = cdf / np.maximum(cdf[:, -1:], 1e-300)
    return SpheroidalEmissionProfile(tabs={
        "lam": jnp.asarray(sph.lam, jnp.float32),
        "theta": jnp.asarray(th, jnp.float32),
        "sabs": jnp.asarray(sabs, jnp.float32),
        "sabspol": jnp.asarray(sph.sabspol, jnp.float32),
        "norm": jnp.asarray(np.maximum(norm, 1e-300), jnp.float32),
        "cdf": jnp.asarray(cdf, jnp.float32),
        "bdir": jnp.asarray(bdir, jnp.float32),
        "bok": jnp.asarray(ok.astype(np.float32)),
    })
