"""SED families: parameterized SED template grids with batched sampling.

Counterpart of the reference's SEDFamily hierarchy (ref:
SKIRT/core/SEDFamily.hpp:20, FileSSPSEDFamily.hpp, FileIndexedSEDFamily.hpp,
BlackBodySEDFamily.hpp). A family maps per-entity parameters (e.g. initial
mass, metallicity, age) to a specific luminosity spectrum L_lambda; imported
sources use it to allocate luminosity between entities and to sample photon
packet wavelengths per entity.

Batched design: instead of building a cdf per entity on demand (the
reference's SEDFamily::cdf per imported entity), the family keeps ONE dense
cdf table per parameter-grid node, and an entity's spectrum is treated as
the exact multilinear mixture of its 2^P surrounding nodes. Sampling a
wavelength for a packet then becomes: pick a corner node with probability
(multilinear weight x corner luminosity share), invert that corner's cdf.
This reproduces multilinear interpolation of L_lambda exactly (a mixture of
distributions) with O(1) memory per entity and fully batched gathers.

Stored-table layout parity: FileSSP tables have axes lambda(m), Z(1), t(yr)
and quantity Llambda(W/m) scaled by initial mass in Msun
(ref: FileSSPSEDFamily.hpp:20-33); FileIndexed tables have axes lambda(m),
index(1) (ref: FileIndexedSEDFamily.hpp).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import rng
from ..utils.storedtable import read_stored_table

M_SUN = 1.98892e30  # kg (reference Constants::Msun)


@dataclasses.dataclass(frozen=True)
class SEDFamily:
    """A tabulated SED family on a rectilinear parameter grid.

    lam: (T,) wavelength grid [m], increasing
    L: (M, T) specific luminosity [W/m] at each of the M = prod(n_p)
       parameter nodes (C-order flattening of the parameter axes, first
       parameter axis slowest)
    param_axes: list of (name, points, 'lin'|'log') for each non-wavelength
       parameter, in stored-table order
    scale_name: name of the leading linear scale parameter ('Minit' for SSP
       families: L scales with initial mass in Msun)
    """

    lam: np.ndarray
    L: np.ndarray
    param_axes: list
    scale_name: str = "Minit"

    @property
    def nparams(self) -> int:
        return len(self.param_axes)

    def wavelength_range(self):
        return float(self.lam[0]), float(self.lam[-1])

    # -------------------------------------------------------- host spectra

    def specific_luminosity(self, params: np.ndarray) -> np.ndarray:
        """(N,P) parameter rows (excluding the scale) -> (N,T) L_lambda for
        unit scale parameter. Multilinear interpolation, clamped to the
        grid (the reference clamps out-of-range parameters the same way,
        ref: StoredTable interpolation)."""
        idx, w = self._corners(params)
        return np.einsum("nc,nct->nt", w, self.L[idx])

    def specific_luminosity_geometric(self, params: np.ndarray) -> np.ndarray:
        """Geometric (log-value) parameter interpolation — the reference's
        convention for log-scaled stored quantities (ref: StoredTable.hpp
        value interpolation; FamilySED.cpp:31). Zero nodes floor to a tiny
        positive value and round back to zero on output."""
        idx, w = self._corners(params)
        floor = max(float(self.L.max()) * 1e-35, 1e-300)
        logL = np.log(np.maximum(self.L[idx], floor))
        out = np.exp(np.einsum("nc,nct->nt", w, logL))
        return np.where(out <= floor * 1.01, 0.0, out)

    def _corners(self, params: np.ndarray):
        """Multilinear corner indices (N, 2^P) into the flattened node axis
        and their weights (N, 2^P)."""
        params = np.atleast_2d(np.asarray(params, np.float64))
        n = len(params)
        dims = [len(pts) for (_, pts, _) in self.param_axes]
        strides = np.cumprod([1] + dims[::-1])[::-1][1:]  # C-order strides
        j0s, fs = [], []
        for p, (_, pts, scale) in enumerate(self.param_axes):
            x = params[:, p]
            if scale == "log":
                xs = np.log(np.maximum(x, 1e-300))
                ps = np.log(np.maximum(pts, 1e-300))
            else:
                xs, ps = x, pts
            if len(pts) == 1:
                j0s.append(np.zeros(n, np.int64))
                fs.append(np.zeros(n))
                continue
            j = np.clip(np.searchsorted(ps, xs) - 1, 0, len(pts) - 2)
            f = np.clip((xs - ps[j]) / np.maximum(ps[j + 1] - ps[j], 1e-300),
                        0.0, 1.0)
            j0s.append(j)
            fs.append(f)
        P = self.nparams
        idx = np.zeros((n, 1 << P), np.int64)
        w = np.ones((n, 1 << P))
        for c in range(1 << P):
            for p in range(P):
                hi = (c >> (P - 1 - p)) & 1
                dim = len(self.param_axes[p][1])
                jj = np.minimum(j0s[p] + hi, dim - 1)
                idx[:, c] += jj * strides[p]
                w[:, c] *= fs[p] if hi else (1.0 - fs[p])
        return idx, w


def load_ssp_family(path: str) -> SEDFamily:
    """FileSSPSEDFamily: .stab with axes lambda(m), Z(1), t(yr) [, U(1)] and
    quantity Llambda(W/m) per Msun of initial mass
    (ref: FileSSPSEDFamily.hpp:20-43)."""
    return load_family_stab(path, scale_name="Minit")


def load_family_stab(path: str, scale_name: str = "Minit") -> SEDFamily:
    """Generic stored-table family loader: axes lambda(m), p2, p3, ... and
    a single per-unit-scale spectral quantity. Serves FileSSPSEDFamily and
    every NAMED resource family (spectral/named.py), which differ only in
    the resource filename and parameter conventions
    (ref: SEDFamily hierarchy; BruzualCharlotSEDFamily.cpp:30 et al.)."""
    tab = read_stored_table(path)
    if tab.axes_names[0] != "lambda":
        raise ValueError("family stored table must have lambda as first axis")
    lam = tab.axes_points[0]
    q = tab.quantity(tab.quantity_names[0])  # axes first-axis-LAST
    # reshape to (M, T): move the lambda axis (last dim) to the end and
    # flatten the remaining axes in C order with axis order (Z, t, [U]);
    # values dims are (axisN, ..., axis2, axis1=lambda) and the parameter
    # axes appear reversed -> transpose to (axis2, axis3, ..., lambda)
    nax = len(tab.axes_names)
    perm = tuple(range(nax - 2, -1, -1)) + (nax - 1,)
    qp = np.transpose(q, perm) if nax > 1 else q[None, :]
    L = qp.reshape(-1, len(lam))
    param_axes = [(tab.axes_names[i], tab.axes_points[i],
                   tab.axes_scales[i]) for i in range(1, nax)]
    return SEDFamily(lam=lam, L=L, param_axes=param_axes,
                     scale_name=scale_name)


def load_indexed_family(path: str) -> SEDFamily:
    """FileIndexedSEDFamily: .stab with axes lambda(m), index(1); entities
    carry (luminosity, index) (ref: FileIndexedSEDFamily.hpp). The per-index
    spectra are normalized shapes scaled by the entity luminosity."""
    tab = read_stored_table(path)
    lam = tab.axes_points[0]
    q = tab.quantity(tab.quantity_names[0])  # (nindex, nlam)
    param_axes = [("index", tab.axes_points[1], "lin")]
    return SEDFamily(lam=lam, L=np.atleast_2d(q), param_axes=param_axes,
                     scale_name="L")


def blackbody_family(temperatures: np.ndarray,
                     lam: np.ndarray) -> SEDFamily:
    """BlackBodySEDFamily as a tabulated family on a temperature grid
    (ref: BlackBodySEDFamily.hpp: parameters radius, temperature; here the
    scale parameter is the emitting area 4*pi*R^2)."""
    from ..ops.planck import b_lambda_np
    T = np.asarray(temperatures, np.float64)
    B = b_lambda_np(lam[None, :], T[:, None])
    return SEDFamily(lam=lam, L=np.pi * B, param_axes=[("T", T, "log")],
                     scale_name="area")


# ------------------------------------------------------------- device side


class FamilyTables:
    """Device-resident sampling tables for one family over a wavelength
    clip range (the source range; ref: SEDFamily::cdf clipping)."""

    def __init__(self, family: SEDFamily, lam_range=None):
        lam = family.lam
        L = family.L
        if lam_range is not None:
            lo, hi = lam_range
            # keep one guard point each side; insert exact clip borders
            keep = (lam >= lo) & (lam <= hi)
            if keep.sum() < 2:
                raise ValueError("family grid has <2 points in source range")
            lam_c = np.unique(np.concatenate([[lo], lam[keep], [hi]]))
            Lc = np.stack([np.interp(lam_c, lam, row) for row in L])
            lam, L = lam_c, Lc
        # trapezoid cdf per node
        dl = np.diff(lam)
        seg = 0.5 * (L[:, 1:] + L[:, :-1]) * dl
        cum = np.cumsum(seg, axis=1)
        tot = np.maximum(cum[:, -1], 1e-300)
        self.family = family
        self.lam_np = lam
        self.L_np = L
        self.Ltot_np = cum[:, -1]  # integrated L_lambda per unit scale [W]
        self.lam = jnp.asarray(lam, jnp.float32)
        self.cdf = jnp.asarray(cum / tot[:, None], jnp.float32)
        self.node_Ltot = jnp.asarray(self.Ltot_np, jnp.float32)
        # node log-spectra for geometric (log-log) parameter mixing: the
        # reference's StoredTable interpolates log(Llambda) across the
        # parameter axes when the quantity is log-scaled
        # (ref: StoredTable.hpp value interpolation; FileSSPSEDFamily)
        floor = np.maximum(L.max() * 1e-35, 1e-300)
        self.logL = jnp.asarray(np.log(np.maximum(L, floor)), jnp.float32)
        self._floor = floor

    # The reference's parameter interpolation is GEOMETRIC (log value
    # scale): L(lam; p) = exp(sum_c w_c ln L_c(lam)). Sampling draws from
    # the cheap linear corner mixture and importance-corrects each packet
    # by p_geo/p_lin, which reproduces the geometric mixture exactly.

    def entity_luminosities(self, scales: np.ndarray, params: np.ndarray,
                            chunk: int = 8192) -> np.ndarray:
        """(N,) integrated luminosity [W] of each entity over the clip
        range: scale * integral of the geometric corner mixture."""
        idx, w = self.family._corners(params)
        logL = np.log(np.maximum(self.L_np, self._floor))
        n = len(idx)
        out = np.empty(n)
        for a in range(0, n, chunk):
            b = min(a + chunk, n)
            Lg = np.exp(np.einsum("nc,nct->nt", w[a:b], logL[idx[a:b]]))
            out[a:b] = np.trapezoid(Lg, self.lam_np, axis=1)
        return np.asarray(scales, np.float64) * out

    def entity_linear_luminosities(self, params: np.ndarray) -> np.ndarray:
        """(N,) integral of the LINEAR corner mixture per unit scale (the
        proposal distribution's normalization for importance weights)."""
        idx, w = self.family._corners(params)
        return (w * self.Ltot_np[idx]).sum(1)

    def corner_tables(self, params: np.ndarray):
        """Host precompute for launch: corner node indices (N, C), the
        corner-selection cdf (N, C) proportional to weight x corner
        integrated luminosity, the raw multilinear weights (N, C), and the
        per-entity ratio I_lin/I_geo used by the importance correction."""
        idx, w = self.family._corners(params)
        p = w * self.Ltot_np[idx]
        p = p / np.maximum(p.sum(1, keepdims=True), 1e-300)
        Ilin = self.entity_linear_luminosities(params)
        Igeo = self.entity_luminosities(np.ones(len(idx)), params)
        ratio = Ilin / np.maximum(Igeo, 1e-300)
        return (jnp.asarray(idx, jnp.int32),
                jnp.asarray(np.cumsum(p, axis=1), jnp.float32),
                jnp.asarray(w, jnp.float32),
                jnp.asarray(ratio, jnp.float32))

    def mixture_weight(self, lam: jax.Array, entity: jax.Array,
                       corner_idx: jax.Array, corner_w: jax.Array,
                       lin_over_geo: jax.Array) -> jax.Array:
        """Importance factor making linear-mixture samples follow the
        geometric mixture: [L_geo(lam)/L_lin(lam)] * [I_lin/I_geo]."""
        k = jnp.clip(jnp.searchsorted(self.lam, lam, side="right") - 1,
                     0, self.lam.shape[0] - 2)
        f = (lam - self.lam[k]) / jnp.maximum(self.lam[k + 1] - self.lam[k],
                                              1e-30)
        nodes = corner_idx[entity]                       # (B,C)
        lo = self.logL[nodes, k[:, None]]                # (B,C)
        hi = self.logL[nodes, k[:, None] + 1]
        logLc = lo + f[:, None] * (hi - lo)
        w = corner_w[entity]                             # (B,C)
        lnLgeo = jnp.sum(w * logLc, axis=1)
        Llin = jnp.sum(w * jnp.exp(logLc), axis=1)
        return jnp.exp(lnLgeo) / jnp.maximum(Llin, 1e-37) \
            * lin_over_geo[entity]

    def sample_wavelength(self, keys: jax.Array, entity: jax.Array,
                          corner_idx: jax.Array,
                          corner_cdf: jax.Array) -> jax.Array:
        """Batched: entity (B,) int32 -> lam (B,). Picks a corner node from
        the entity's mixture, inverts that node's wavelength cdf."""
        u_c = rng.uniform(keys, rng.LAUNCH_FAMILY_CORNER)
        ccdf = corner_cdf[entity]                       # (B, C)
        c = jnp.sum((ccdf < u_c[:, None]).astype(jnp.int32), axis=1)
        c = jnp.clip(c, 0, ccdf.shape[1] - 1)
        node = jnp.take_along_axis(corner_idx[entity], c[:, None],
                                   axis=1)[:, 0]       # (B,)
        u = rng.uniform(keys, rng.LAUNCH_WAVELENGTH)
        rows = self.cdf[node]                           # (B, T-1)
        k = jnp.sum((rows < u[:, None]).astype(jnp.int32), axis=1)
        k = jnp.clip(k, 0, rows.shape[1] - 1)
        c0 = jnp.where(k > 0,
                       jnp.take_along_axis(rows, jnp.maximum(k - 1, 0)[:, None],
                                           axis=1)[:, 0], 0.0)
        c1 = jnp.take_along_axis(rows, k[:, None], axis=1)[:, 0]
        f = jnp.where(c1 > c0, (u - c0) / jnp.maximum(c1 - c0, 1e-30), 0.5)
        lo = self.lam[k]
        hi = self.lam[k + 1]
        return lo + f * (hi - lo)
