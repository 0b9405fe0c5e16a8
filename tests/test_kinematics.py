"""Kinematic (Doppler) transfer: moving media shift line opacities.

A medium moving at bulk velocity v perceives photons of model-frame
wavelength lam at lam' = lam / (1 - k.v/c) (receding medium sees them
redshifted; ref: PhotonPacket::shiftedReceptionWavelength). With a narrow
absorption line centered at the shifted wavelength, absorption happens ONLY when kinematics is on —
a crisp discriminator (the physics of the reference's kinematic line
transfer, ref: PhotonPacket::perceivedWavelength + MediumSystem
per-cell perceived-wavelength opacity, MediumSystem.cpp:860-900).
"""

import numpy as np
import jax
import pytest

from skirt9_tpu.grids.cartesian import make_cartesian
from skirt9_tpu.instruments import distant as dinst
from skirt9_tpu.media import system as msys
from skirt9_tpu.simulation import Simulation
from skirt9_tpu.sources.base import PointSource
from skirt9_tpu.transport import lifecycle as lc

PC = 3.0857e16
C = 2.99792458e8
LAM0 = 0.55e-6


def run(kinematics, v_kms=300.0, n=12, npackets=4096):
    box = PC
    grid = make_cartesian(((-box, box),) * 3, (n,) * 3)
    # absorption line centered at the wavelength the moving medium perceives
    v = v_kms * 1e3
    lam_line = LAM0 / (1 - v / C)
    width = LAM0 * (v / C) / 8  # much narrower than the shift
    lam_t = np.sort(np.concatenate([
        np.geomspace(0.4e-6, 0.7e-6, 40),
        np.linspace(lam_line - 6 * width, lam_line + 6 * width, 60),
    ]))
    sigma_line = 1e-24 * np.exp(-((lam_t - lam_line) ** 2) / (2 * width**2))
    sigma = sigma_line + 1e-32  # tiny continuum floor
    nd_val = 2.0 / (1e-24 * box)  # line-center tau ~ 2 through the box
    nd = np.full(grid.ncells, nd_val, np.float32)
    bulk_v = np.tile(np.array([0, 0, v], np.float32), (grid.ncells, 1))
    med = msys.make_medium(grid, nd, lam_t, sigma[None, :],
                           np.zeros((1, len(lam_t))),
                           np.zeros((1, len(lam_t))), bulk_v=bulk_v)
    inst = dinst.DistantInstrumentCfg(name="i", wave_borders=(0.5e-6, 0.6e-6),
                                      inclination=0.0, distance=100 * PC)
    opts = lc.TransportOptions(max_steps=grid.max_steps(), max_events=4,
                               kinematics=kinematics, store_rf=False)
    sim = Simulation(grid=grid, medium=med,
                     sources=[PointSource(luminosity=1.0, lam0=LAM0)],
                     instruments=[inst], options=opts, rf_borders=None,
                     num_packets=npackets, batch_size=2048, seed=4)
    _, accs = sim.run_primary(verbose=False)
    sed = dinst.calibrate_sed(inst, jax.device_get(accs[0]))
    return sed["primarydirect"][0] / sed["transparent"][0]


def test_moving_medium_absorbs_only_with_kinematics():
    att_static = run(kinematics=False)
    att_moving = run(kinematics=True)
    # static treatment: line center far from lam0 -> transparent
    assert att_static == pytest.approx(1.0, abs=0.01)
    # kinematic treatment: photons toward +z are at line center in the
    # medium frame -> strongly absorbed (tau ~ 2 over the half box -> ~1)
    assert att_moving < 0.6


def test_zero_velocity_matches_static():
    att_k = run(kinematics=True, v_kms=0.0)
    att_s = run(kinematics=False, v_kms=0.0)
    assert att_k == pytest.approx(att_s, rel=1e-3)
