"""All-sky instruments: observers inside the model mapping the full sphere.

Counterpart of the reference's AllSkyInstrument + AllSkyProjection and the
HEALPixSkyInstrument (ref: SKIRT/core/AllSkyInstrument.hpp,
MollweideProjection, HammerAitoffProjection, HEALPixSkyInstrument.cpp:136
RING-scheme loc2pix): peel-off directions point from each emission/
scattering event to the observer position; arrival directions project to
sky pixels via an equal-area projection (Mollweide ellipse or the HEALPix
ring/pixel-in-ring image layout); contributions carry the local-instrument
1/d^2 calibration (ref: FluxRecorder local instrument per-packet distance
calibration). An optional (crosshair, up) pair orients the sky frame with
the crosshair along +x and up along +z exactly like the reference's
world-to-observer transform (HEALPixSkyInstrument.cpp:36-70).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from . import distant as dinst


@dataclasses.dataclass(frozen=True)
class AllSkyInstrumentCfg:
    """Mollweide all-sky map observer at `position` [m]."""

    name: str
    wave_borders: tuple
    position: tuple = (0.0, 0.0, 0.0)
    npx: int = 250                  # pixels in x (2:1 aspect)
    record_statistics: bool = False
    stats_scale: float = 1.0
    projection: str = "mollweide"   # or "hammer" / "healpix"
    order: int = 5                  # healpix only: Nside = 2^order
    crosshair: tuple | None = None  # orient +x toward this point [m]
    up: tuple = (0.0, 0.0, 1.0)

    @property
    def nside(self) -> int:
        return 1 << self.order

    @property
    def nbins(self) -> int:
        return len(self.wave_borders) - 1

    @property
    def npx_eff(self) -> int:
        return 4 * self.nside if self.projection == "healpix" else self.npx

    @property
    def npy(self) -> int:
        if self.projection == "healpix":
            return 4 * self.nside - 1
        return self.npx // 2

    @property
    def is_local(self) -> bool:
        return True


def _frame_matrix(cfg: AllSkyInstrumentCfg) -> np.ndarray:
    """Rows (ex, ey, ez): +x toward the crosshair, +z along the projected
    up direction (ref: HEALPixSkyInstrument.cpp:36-70 world-to-observer
    rotation, final alignment 'z-axis up, x-axis towards crosshair')."""
    if cfg.crosshair is None:
        return np.eye(3)
    f = np.asarray(cfg.crosshair, np.float64) - np.asarray(cfg.position)
    if np.linalg.norm(f) < 1e-20:   # degenerate: keep the world frame
        return np.eye(3)
    f = f / np.linalg.norm(f)
    up = np.asarray(cfg.up, np.float64)
    uz = up - (up @ f) * f
    if np.linalg.norm(uz) < 1e-12:  # up parallel to the viewing direction
        alt = np.array([1.0, 0, 0]) if abs(f[0]) < 0.9 else np.array([0, 1.0, 0])
        uz = alt - (alt @ f) * f
    uz = uz / np.linalg.norm(uz)
    ey = np.cross(uz, f)
    return np.stack([f, ey, uz])


def device_tables(cfg: AllSkyInstrumentCfg) -> dict:
    return {
        "obs": jnp.asarray(np.asarray(cfg.position), jnp.float32),
        "wave_borders": jnp.asarray(np.asarray(cfg.wave_borders), jnp.float32),
        "frame": jnp.asarray(_frame_matrix(cfg), jnp.float32),
    }


def init_accumulators(cfg: AllSkyInstrumentCfg) -> dict:
    return {"sky": jnp.zeros((dinst.NUM_KINDS, cfg.nbins, cfg.npy,
                              cfg.npx_eff), jnp.float32)}


def observer_directions(tables: dict, pos: jax.Array):
    """(k_to_obs (B,3), distance (B,)) from event positions to the observer."""
    d = tables["obs"] - pos
    dist = jnp.linalg.norm(d, axis=-1)
    k = d / jnp.maximum(dist[..., None], 1e-30)
    return k, dist


def _mollweide_xy(lon, lat, iters: int = 6):
    """Mollweide forward projection to x in [-2,2], y in [-1,1]."""
    t = lat

    def newton(t, _):
        f = 2 * t + jnp.sin(2 * t) - jnp.pi * jnp.sin(lat)
        df = 2 + 2 * jnp.cos(2 * t)
        return t - f / jnp.maximum(df, 1e-6), None

    t, _ = jax.lax.scan(newton, t, None, length=iters)
    x = 2 / jnp.pi * lon * jnp.cos(t) * (2 / 2)
    y = jnp.sin(t)
    return x * (2 / 2), y  # x in [-2,2] (lon in [-pi,pi]), y in [-1,1]


def _healpix_ring_ij(theta: jax.Array, phi: jax.Array, nside: int):
    """RING-scheme (ring index, pixel-in-ring index) for the HEALPix image
    layout — vectorized port of the loc2pix subset the reference uses
    (ref: HEALPixSkyInstrument.cpp:158-203, itself from healpix_base.cc).
    phi must be in [0, 2 pi)."""
    z = jnp.cos(theta)
    za = jnp.abs(z)
    tt = jnp.mod(2.0 * phi / jnp.pi, 4.0)
    # equatorial region: all rings have 4 nside pixels
    t1 = nside * (0.5 + tt)
    t2 = 0.75 * nside * z
    jp_e = jnp.floor(t1 - t2).astype(jnp.int32)
    jm_e = jnp.floor(t1 + t2).astype(jnp.int32)
    j_e = nside + 1 + jp_e - jm_e
    kshift = 1 - (j_e & 1)
    temp = jp_e + jm_e + kshift + 1 + 7 * nside
    i_e = (temp >> 1) & (4 * nside - 1)          # nside is a power of two
    j_e = j_e + nside - 2
    # polar caps: ring length grows with distance from the pole
    tp = tt - jnp.floor(tt)
    tmp = jnp.where(za < 0.99,
                    nside * jnp.sqrt(3.0 * (1.0 - za)),
                    nside * jnp.sin(theta)
                    / jnp.sqrt(jnp.maximum((1.0 + za) / 3.0, 1e-12)))
    jp_p = (tp * tmp).astype(jnp.int32)
    jm_p = ((1.0 - tp) * tmp).astype(jnp.int32)
    j_p = jp_p + jm_p + 1
    i_p = (tt * j_p).astype(jnp.int32)
    j_p = jnp.where(z < 0, 4 * nside - j_p - 1, j_p - 1)
    eq = za <= 2.0 / 3.0
    return jnp.where(eq, i_e, i_p), jnp.where(eq, j_e, j_p)


def detect(cfg: AllSkyInstrumentCfg, tables: dict, acc: dict,
           lam: jax.Array, arrival_dir: jax.Array, contrib: jax.Array,
           kind: int, active: jax.Array) -> dict:
    """Record contributions arriving at the observer from direction
    `arrival_dir` (pointing from observer toward the event)."""
    borders = tables["wave_borders"]
    nb = cfg.nbins
    b = jnp.searchsorted(borders, lam, side="right") - 1
    ok = active & (b >= 0) & (b < nb) & (contrib > 0)
    bq = jnp.clip(b, 0, nb - 1)

    # rotate into the oriented sky frame (+x crosshair, +z up)
    k = jnp.dot(arrival_dir, tables["frame"].T,
                precision=jax.lax.Precision.HIGHEST)
    kx, ky, kz = k[..., 0], k[..., 1], k[..., 2]
    if cfg.projection == "healpix":
        theta = jnp.arccos(jnp.clip(kz, -1, 1))
        # spherical() yields phi in [-pi, pi]; the reference centers the
        # map on the crosshair with a +pi offset
        phi = jnp.arctan2(ky, kx) + jnp.pi
        i, j = _healpix_ring_ij(theta, phi, cfg.nside)
        ix = jnp.clip(i, 0, cfg.npx_eff - 1)
        iy = jnp.clip(j, 0, cfg.npy - 1)
    else:
        lon = jnp.arctan2(ky, kx)              # [-pi, pi]
        lat = jnp.arcsin(jnp.clip(kz, -1, 1))  # [-pi/2, pi/2]
        x, y = _mollweide_xy(lon, lat)
        ix = jnp.clip(((x / 2 + 1) * 0.5 * cfg.npx).astype(jnp.int32),
                      0, cfg.npx - 1)
        iy = jnp.clip(((y + 1) * 0.5 * cfg.npy).astype(jnp.int32),
                      0, cfg.npy - 1)
    c = jnp.where(ok, contrib, 0.0)
    acc = dict(acc)
    acc["sky"] = acc["sky"].at[kind, bq, iy, ix].add(c)
    return acc


def calibrate(cfg: AllSkyInstrumentCfg, acc: dict) -> np.ndarray:
    """Surface brightness cube (nb, npy, npx) [W/m2/m/sr]: contributions
    already include 1/d^2; divide by bin width and pixel solid angle
    (equal-area projection: Omega_pix = 4 pi / (useful pixels))."""
    borders = np.asarray(cfg.wave_borders, np.float64)
    dlam = np.diff(borders)[:, None, None]
    if cfg.projection == "healpix":
        # every HEALPix pixel covers the same solid angle
        # (ref: HEALPixSkyInstrument.cpp:74-75)
        omega_pix = np.pi / (3 * cfg.nside ** 2)
    else:
        # Mollweide ellipse fills pi/4 of the enclosing rectangle
        omega_pix = 4 * np.pi / (cfg.npx * cfg.npy * np.pi / 4)
    sky = np.asarray(acc["sky"], np.float64)
    total = sky[dinst.KIND_PRIMARY_DIRECT] + sky[dinst.KIND_PRIMARY_SCATTERED] \
        + sky[dinst.KIND_SECONDARY_DIRECT] + sky[dinst.KIND_SECONDARY_SCATTERED]
    return total / (dlam * omega_pix)
