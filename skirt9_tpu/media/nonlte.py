"""Non-LTE line gas: statistical-equilibrium level populations per cell.

Counterpart of the reference's NonLTELineGasMix
(ref: SKIRT/core/NonLTELineGasMix.hpp:289: "rotational levels,
statistical-equilibrium solve per cell" for CO/C/C+/... species): given the
kinetic temperature, collision-partner density and molecule density of every
cell, solve

    dn_i/dt = 0 = sum_j (R_ji n_j - R_ij n_i),   sum_i n_i = 1

with radiative (A + stimulated/absorbed B J) and collisional (C + detailed
balance) rates, then derive per-line emissivities (fed to the generic
GasLineSource) and line-center opacities (added to the medium tables).

Vectorized structure: the reference loops cells on threads and calls a dense
LU solve per cell; here the rate matrices for ALL cells are assembled as one
(ncells, N, N) tensor with scatter-adds and solved by a single batched
`jnp.linalg.solve` — the natural XLA mapping (batched small-matrix LAPACK on
device, no per-cell dispatch).

Molecular data comes from the standard LAMDA text format (`from_lamda`) or
the built-in analytic linear-rotor model (`linear_rotor`, exact level
energies and Einstein A's; approximate collision rates, documented below).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import constants as c

DEBYE = 3.33564e-30      # C m
EPS0 = 8.8541878128e-12  # vacuum permittivity


@dataclasses.dataclass(frozen=True)
class MoleculeData:
    """Energy levels, radiative transitions and collision rates."""

    name: str
    E: np.ndarray          # (N,) level energies [J]
    g: np.ndarray          # (N,) statistical weights
    up: np.ndarray         # (M,) upper level index per radiative transition
    lo: np.ndarray         # (M,) lower level index
    A: np.ndarray          # (M,) Einstein A [1/s]
    coll_up: np.ndarray    # (P,) upper level per collisional pair
    coll_lo: np.ndarray    # (P,)
    coll_T: np.ndarray     # (K,) temperature grid of the rate table
    coll_rate: np.ndarray  # (P, K) downward rate coefficients [m^3/s]
    weight: float = 28.0   # molecular weight [amu] (thermal line widths)

    @property
    def nlevels(self) -> int:
        return self.E.size

    @property
    def line_freq(self) -> np.ndarray:
        return (self.E[self.up] - self.E[self.lo]) / c.H_PLANCK

    @property
    def line_lam(self) -> np.ndarray:
        return c.C_LIGHT / self.line_freq


def linear_rotor(B0: float = 57.635968e9, mu_debye: float = 0.11011,
                 nlevels: int = 12, weight: float = 28.0,
                 name: str = "CO",
                 coll_scale: float = 3e-17) -> MoleculeData:
    """Rigid linear rotor (default: CO): E_J = h B J(J+1), g_J = 2J+1,
    A_{J->J-1} = 16 pi^3 nu^3 mu^2 / (3 eps0 h c^3) * J/(2J+1)
    (exact; reproduces CO 1-0 A = 7.2e-8 1/s). Collision rates with H2 are
    an approximate ladder (coll_scale m^3/s for dJ=1, /4 per extra dJ,
    ~T^0.15) — replace with a LAMDA file for publication-grade rates
    (the reference likewise reads LAMDA-derived resources)."""
    J = np.arange(nlevels)
    E = c.H_PLANCK * B0 * J * (J + 1)
    g = 2.0 * J + 1.0
    up = np.arange(1, nlevels)
    lo = up - 1
    nu = (E[up] - E[lo]) / c.H_PLANCK
    mu = mu_debye * DEBYE
    A = (16 * np.pi**3 * nu**3 * mu**2 /
         (3 * EPS0 * c.H_PLANCK * c.C_LIGHT**3) * up / (2.0 * up + 1.0))
    # collisional pairs: all (u, l) with dJ <= 3
    cu, cl = [], []
    for u in range(1, nlevels):
        for l in range(max(0, u - 3), u):
            cu.append(u)
            cl.append(l)
    cu = np.array(cu)
    cl = np.array(cl)
    T_grid = np.array([5.0, 10.0, 20.0, 40.0, 80.0, 160.0, 320.0, 640.0])
    dJ = cu - cl
    base = coll_scale / 4.0 ** (dJ - 1)
    coll = base[:, None] * (T_grid[None, :] / 20.0) ** 0.15
    return MoleculeData(name=name, E=E, g=g, up=up, lo=lo, A=A,
                        coll_up=cu, coll_lo=cl, coll_T=T_grid,
                        coll_rate=coll, weight=weight)


def from_lamda(path: str) -> MoleculeData:
    """Read a molecule datafile in the standard LAMDA (Leiden Atomic and
    Molecular Database) text format; first collision partner is used
    (ref: NonLTELineGasMix resource inputs)."""
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f]
    i = 0

    def next_data():
        nonlocal i
        while lines[i].lstrip().startswith("!"):
            i += 1
        ln = lines[i]
        i += 1
        return ln

    name = next_data().strip()
    weight = float(next_data().split()[0])
    nlev = int(next_data().split()[0])
    E = np.empty(nlev)
    g = np.empty(nlev)
    for k in range(nlev):
        parts = next_data().split()
        E[k] = float(parts[1]) * 100.0 * c.H_PLANCK * c.C_LIGHT  # cm^-1 -> J
        g[k] = float(parts[2])
    ntr = int(next_data().split()[0])
    up = np.empty(ntr, int)
    lo = np.empty(ntr, int)
    A = np.empty(ntr)
    for k in range(ntr):
        parts = next_data().split()
        up[k] = int(parts[1]) - 1
        lo[k] = int(parts[2]) - 1
        A[k] = float(parts[3])
    next_data()  # number of collision partners
    next_data()  # partner description
    ncol = int(next_data().split()[0])
    ntemp = int(next_data().split()[0])
    T_grid = np.array([float(v) for v in next_data().split()])[:ntemp]
    cu = np.empty(ncol, int)
    cl = np.empty(ncol, int)
    rates = np.empty((ncol, ntemp))
    for k in range(ncol):
        parts = next_data().split()
        cu[k] = int(parts[1]) - 1
        cl[k] = int(parts[2]) - 1
        rates[k] = [float(v) * 1e-6 for v in parts[3:3 + ntemp]]  # cm3->m3
    return MoleculeData(name=name, E=E, g=g, up=up, lo=lo, A=A,
                        coll_up=cu, coll_lo=cl, coll_T=T_grid,
                        coll_rate=rates, weight=weight)


def solve_populations(mol: MoleculeData, n_col, T_kin,
                      J_rad=None) -> jax.Array:
    """Batched statistical equilibrium: fractional level populations
    (ncells, N) given collision-partner density n_col (ncells,) [1/m^3],
    kinetic temperature T_kin (ncells,) [K] and optionally the local mean
    radiation intensity J_rad (ncells, M) [W/m^2/Hz/sr] at each line
    frequency (stimulated emission + absorption; None = radiative decay
    only, the reference's default uncoupled first iteration)."""
    N = mol.nlevels
    n_col = jnp.asarray(n_col)
    T = jnp.asarray(T_kin)
    ncells = n_col.shape[0]

    up = jnp.asarray(mol.up)
    lo = jnp.asarray(mol.lo)
    A = jnp.asarray(mol.A)
    nu = jnp.asarray(mol.line_freq)
    g = jnp.asarray(mol.g)

    # rate R[i -> j] accumulated into M[j, i] (flow into j), diagonal later
    R = jnp.zeros((ncells, N, N))

    # radiative: downward A + B_ul J; upward B_lu J
    down = jnp.broadcast_to(A, (ncells, A.size))
    if J_rad is not None:
        J_rad = jnp.asarray(J_rad)
        B_ul = A * c.C_LIGHT**2 / (2 * c.H_PLANCK * nu**3)
        B_lu = B_ul * g[up] / g[lo]
        down = down + B_ul * J_rad
        upw = B_lu * J_rad
        R = R.at[:, lo, up].add(down)
        R = R.at[:, up, lo].add(upw)
    else:
        R = R.at[:, lo, up].add(down)

    # collisional: tabulated downward rates, upward by detailed balance;
    # interp each pair's rate at each cell's T: (ncells, P)
    rate_tab = jnp.asarray(mol.coll_rate)  # (P, K)
    Tt = jnp.asarray(mol.coll_T)
    k_dn = jax.vmap(lambda r: jnp.interp(T, Tt, r), out_axes=1)(rate_tab)
    k_dn = k_dn * n_col[:, None]                        # (ncells, P)
    cu = jnp.asarray(mol.coll_up)
    cl = jnp.asarray(mol.coll_lo)
    dE = jnp.asarray(mol.E)[cu] - jnp.asarray(mol.E)[cl]
    k_up = k_dn * (g[cu] / g[cl])[None, :] * jnp.exp(
        -dE[None, :] / (c.K_BOLTZMANN * jnp.maximum(T, 1e-3)[:, None]))
    R = R.at[:, cl, cu].add(k_dn)
    R = R.at[:, cu, cl].add(k_up)

    # M n = 0 with sum n = 1: diagonal = -total outflow; replace last row
    # normalize each cell's matrix by its largest rate: the system is
    # scale-invariant (RHS is zero + a normalization row) and this keeps
    # the f32 batched solve well-conditioned across 10+ decades of density
    scale = jnp.maximum(jnp.max(R, axis=(1, 2), keepdims=True), 1e-30)
    R = R / scale
    out = jnp.sum(R, axis=1)                 # (ncells, N) outflow from col i
    M = R - jax.vmap(jnp.diag)(out)
    M = M.at[:, -1, :].set(1.0)
    b = jnp.zeros((ncells, N)).at[:, -1].set(1.0)
    pops = jnp.linalg.solve(M, b[..., None])[..., 0]
    return jnp.clip(pops, 0.0, 1.0)


def lte_populations(mol: MoleculeData, T_kin) -> np.ndarray:
    """Boltzmann populations (test oracle and high-density limit)."""
    T = np.atleast_1d(np.asarray(T_kin, np.float64))
    w = mol.g[None, :] * np.exp(-mol.E[None, :] /
                                (c.K_BOLTZMANN * T[:, None]))
    return w / w.sum(axis=1, keepdims=True)


def line_luminosities(mol: MoleculeData, pops, n_mol, volumes) -> np.ndarray:
    """L[line, cell] = h nu A n_u(frac) n_mol V  [W]
    (ref: EmittingGasMix::lineEmissionSpectrum -> LineGasSecondarySource)."""
    pops = np.asarray(pops, np.float64)
    n_mol = np.asarray(n_mol, np.float64)
    V = np.asarray(volumes, np.float64)
    hnu = c.H_PLANCK * mol.line_freq
    return (hnu[:, None] * mol.A[:, None] * pops[:, mol.up].T
            * n_mol[None, :] * V[None, :])


def line_center_cross_section(mol: MoleculeData, pops, T_kin) -> np.ndarray:
    """Line-center absorption cross section per molecule (lines, ncells)
    [m^2], Gaussian thermal profile:
      sigma0 = (h nu / 4 pi) (x_l B_lu - x_u B_ul) / (sqrt(pi) dnu_D)
    (ref: NonLTELineGasMix::opacityAbs; negative values = maser transitions
    are clipped to 0 like the reference's default)."""
    pops = np.asarray(pops, np.float64)
    T = np.asarray(T_kin, np.float64)
    nu = mol.line_freq
    B_ul = mol.A * c.C_LIGHT**2 / (2 * c.H_PLANCK * nu**3)
    B_lu = B_ul * mol.g[mol.up] / mol.g[mol.lo]
    vth = np.sqrt(2 * c.K_BOLTZMANN * np.maximum(T, 1e-3)
                  / (mol.weight * 1.6605e-27))
    dnu = nu[:, None] * vth[None, :] / c.C_LIGHT
    x_l = pops[:, mol.lo].T
    x_u = pops[:, mol.up].T
    sig = (c.H_PLANCK * nu[:, None] / (4 * np.pi)
           * (x_l * B_lu[:, None] - x_u * B_ul[:, None])
           / (np.sqrt(np.pi) * dnu))
    return np.maximum(sig, 0.0)


def make_line_sources(grid, med, mol: MoleculeData, pops, n_mol,
                      spatial_bias: float = 0.5, min_fraction: float = 1e-6):
    """One GasLineSource per significant line (total luminosity above
    min_fraction of the strongest line)."""
    from ..sources.gas_lines import prepare_line_source
    L = line_luminosities(mol, pops, n_mol, grid.volumes())
    tot = L.sum(axis=1)
    keep = tot > min_fraction * max(tot.max(), 1e-300)
    out = []
    for li in np.nonzero(keep)[0]:
        out.append(prepare_line_source(grid, med, float(mol.line_lam[li]),
                                       L[li],
                                       mol.weight * 1.6605e-27,
                                       spatial_bias=spatial_bias))
    return out
