"""The photon-packet life cycle as a batched, jit-compiled state machine.

This is the batched re-design of the reference's hot path
(ref: SKIRT/core/MonteCarloSimulation.cpp:538 `performLifeCycle`,
:696 `simulateForcedPropagation`, :784 `peelOffScattering`,
:638 `storeRadiationField`): instead of one C++ object walked through a
per-packet while-loop, a whole packet batch advances in lockstep through a
`lax.scan` over scattering events; each event performs

  1. a bounded ray-march to the grid boundary accumulating optical depth
     (pass 1 — replaces SpatialGridPath segment recording),
  2. biased interaction-point sampling (forced scattering, composite
     uniform/exponential path-length bias, ref: MonteCarloSimulation.cpp:709),
  3. a second ray-march that deposits radiation-field contributions per cell
     via scatter-add and pinpoints the interaction location (pass 2 —
     replaces the segment-array binary search + LockFree::add),
  4. peel-off toward every instrument with an observer-direction
     optical-depth march (ref: FluxRecorder.cpp:304 detection + second
     ray-march; same-observer instruments share one march like the
     reference's per-packet cache, FluxRecorder.cpp:330),
  5. the scattering event proper: component selection by scattering opacity,
     HG direction sampling, albedo weighting, termination tests.

Terminated lanes are masked, not removed; the weight-cutoff termination
(ref: PhotonPacketOptions minWeightReduction=1e4) bounds useful event counts.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..media import system as msys
from ..ops import phase as phs
from ..ops import rng
from ..ops import stokes as stk
from ..ops import lya as lyo
from ..ops import compton as co
from ..instruments import distant as dinst
from ..instruments import allsky as asky
from .packets import PacketBatch

# dedicated RNG purpose tags for the draws of one event (distinct streams)
_INV_C = 1.0 / 2.99792458e8  # inverse speed of light [s/m]

_TAG_PATH_CHOICE = 21
_TAG_PATH_TAU_UNI = 22
_TAG_PATH_TAU_EXP = 23
_TAG_SCATTER_COMP = 24
_TAG_SCATTER_CT = 25
_TAG_SCATTER_PHI = 26


@dataclasses.dataclass(frozen=True)
class TransportOptions:
    """Static knobs of the MC algorithm variant
    (ref: SKIRT/core/PhotonPacketOptions.hpp defaults)."""

    max_steps: int                 # ray-march step bound (grid-dependent)
    max_events: int = 64           # scattering-event bound per packet
    path_length_bias: float = 0.5  # xi of uniform-vs-exponential tau sampling
    min_weight_reduction: float = 1e4
    min_scatt_events: int = 0
    force_scattering: bool = True
    explicit_absorption: bool = False
    store_rf: bool = True
    primary: bool = True           # primary vs secondary segment (for kinds)
    peel_off: bool = True          # off during self-absorption iterations
                                   # (ref: runSecondaryEmissionIterations)
    polarization: bool = False     # Mueller-matrix scattering + Stokes
                                   # recording (ref: DustMix
                                   # SphericalPolarization mode, Peest+2017)
    compton: bool = False          # Klein-Nishina electron scattering with
                                   # Compton wavelength shifts (ref:
                                   # ComptonPhaseFunction.hpp:16)
    lya: bool = False              # Lyman-alpha resonant line transfer:
                                   # Voigt cross sections vs (lam, T_cell),
                                   # atom-velocity scattering with
                                   # wavelength redistribution (ref:
                                   # LyaNeutralHydrogenGasMix, LyaUtils)
    lya_xcrit: float = 0.0         # core-skipping critical x (0 = off;
                                   # ref: LyaOptions acceleration schemes;
                                   # Constant scheme: strength * 3)
    lya_variable: bool = False     # Variable acceleration scheme: per-cell
                                   # xcrit = strength * (nH/T)^(1/6)
                                   # (ref: LyaUtils.cpp:58-61)
    lya_strength: float = 1.0      # acceleration strength multiplier
    xray: bool = False             # X-ray gas: fluorescence (wavelength-
                                   # changing re-emission at line energies)
                                   # + bound/free Compton scattering as the
                                   # two scattering channels (ref:
                                   # XRayAtomicGasMix.hpp:288
                                   # performScattering channel selection)
    kinematics: bool = False       # Doppler shifts from cell bulk velocity:
                                   # per-cell perceived wavelengths in the
                                   # march, shifted re-emission and
                                   # detection (ref: PhotonPacket
                                   # perceivedWavelength, MediumSystem
                                   # kinematics handling)
    emission_doppler: bool = False  # peel-off emission wavelengths in the
                                    # observer frame from the emitter
                                    # velocity (line sources; ref:
                                    # LineGasSecondarySource peel-off)
    # RF deposits are stored in units of rf_scale [W m] to keep the f32
    # accumulator in range (raw L*ds reaches ~1e41 for solar-luminosity
    # sources at parsec scales, beyond f32 max). Choose
    # rf_scale ~ (L_total/num_packets) * grid diagonal.
    rf_scale: float = 1.0


# ----------------------------------------------------------------- ray marches

def march_geometry(grid, pos0, dirn, cell0, max_steps: int, mask):
    """Pure geometric march: per-step (cell, ds) tables, (S,B) each.

    Contains NO table gathers: all opacity work happens densely on the
    recorded step tables afterwards (opacity_on_path), one gather over the
    whole (S,B) table instead of one per scan step.
    """

    def body(carry, _):
        p, c = carry
        ds, nc, np_ = grid.step(p, dirn, c)
        seg = mask & (c >= 0)
        return (np_, nc), (jnp.maximum(c, 0).astype(jnp.int32),
                           jnp.where(seg, ds, 0.0))

    (_, _), (cells, ds) = jax.lax.scan(body, (pos0, cell0), None,
                                       length=max_steps)
    return cells, ds


def opacity_on_path(med: msys.MediumTables, opt: msys.Optics,
                    cells, ds, dirn, lam=None, lya: bool = False,
                    scattering: bool = False):
    """Per-step optical depths dtau (S,B) for a recorded march — one dense
    gather + vector math over the whole (S,B) step table (replaces the
    pathological per-step in-scan gathers).

    lam (B,) enables kinematics (Doppler-shifted per-cell opacities) and/or
    Lya Voigt opacities; ds==0 marks inactive steps (zero contribution).
    """
    if lya:
        v = med.bulk_v[cells]                                  # (S,B,3)
        lam_c = lam[None, :] / (1.0 - jnp.sum(dirn[None, :, :] * v, axis=-1)
                                * _INV_C)
        T = jnp.maximum(med.temperature[cells], 1.0)
        k = med.nd[cells, 0] * lyo.cross_section(lam_c, T)
        return k * ds
    if lam is None:
        sig = opt.sigma_sca if scattering else opt.sigma_ext   # (B,H)
        nd = med.nd[cells]                                     # (S,B,H)
        return jnp.einsum("sbh,bh->sb", nd, sig,
                          precision=jax.lax.Precision.HIGHEST) * ds
    v = med.bulk_v[cells]
    lam_c = lam[None, :] / (1.0 - jnp.sum(dirn[None, :, :] * v, axis=-1)
                            * _INV_C)
    o = msys.optics_at(med, lam_c.reshape(-1))
    sig_t = o.sigma_sca if scattering else o.sigma_ext
    sig = sig_t.reshape(cells.shape + (med.ncomp,))            # (S,B,H)
    nd = med.nd[cells]
    return jnp.sum(nd * sig, axis=-1) * ds


def trace_tau(grid, med: msys.MediumTables, opt: msys.Optics,
              pos: jax.Array, dirn: jax.Array, cell: jax.Array,
              max_steps: int, active: jax.Array,
              lam: jax.Array | None = None, lya: bool = False) -> jax.Array:
    """Total extinction optical depth from pos along dirn to the grid boundary.

    Pure tau accumulation (used for peel-off extinction and pass 1 of forced
    scattering). Bounded scan with masked lanes.
    """

    cells, ds = march_geometry(grid, pos, dirn, cell, max_steps, active)
    dtau = opacity_on_path(med, opt, cells, ds, dirn, lam, lya)
    return jnp.sum(dtau, axis=0)


def march_record(grid, med: msys.MediumTables, opt: msys.Optics,
                 pos0: jax.Array, dirn: jax.Array, cell0: jax.Array,
                 max_steps: int, mask: jax.Array, record_sca: bool = False,
                 lam: jax.Array | None = None, lya: bool = False):
    """One bounded traversal recording per-step (cell, ds, dtau): (S,B) each.

    This replaces BOTH of the reference's passes over the path (segment
    recording in SpatialGridPath + the later binary search / RF walk): a
    single march materializes the step table, and everything downstream
    (total optical depth, forced-scattering interaction point, radiation-
    field deposits) becomes dense vectorized math on (S,B) arrays plus one
    scatter, instead of two more marches.
    """

    cells, ds = march_geometry(grid, pos0, dirn, cell0, max_steps, mask)
    dtau = opacity_on_path(med, opt, cells, ds, dirn, lam, lya)
    if record_sca:
        dtau_sca = opacity_on_path(med, opt, cells, ds, dirn, lam, lya,
                                   scattering=True)
        return cells, ds, dtau, dtau_sca
    return cells, ds, dtau


def deposit_rf(rf: jax.Array, cells: jax.Array, ds: jax.Array,
               dtau: jax.Array, tau_before: jax.Array, lum: jax.Array,
               rf_bin: jax.Array, rf_mask: jax.Array, rf_scale: float):
    """Radiation-field deposits for a recorded march, one batched scatter.

    Per-segment deposit: L * exp(-tau0) * (1-exp(-dtau))/k — the exact path
    integral of L e^-tau ds over the segment (ref:
    MediumSystem::storeRadiationField semantics, MediumSystem.cpp:1294) with
    the k->0 limit L e^-tau0 ds; 1/k is computed as ds/dtau. The reference
    deposits along the ENTIRE path regardless of the sampled interaction
    point; so do we.

    Scale note: 1/rf_scale underflows f32 and XLA reassociates+constant-
    folds adjacent scalar factors (observed: (lum*inv)*inv -> lum*0), so the
    two sqrt factors are attached to DIFFERENT tensors.
    """
    inv_sqrt = 1.0 / float(np.sqrt(rf_scale))
    lum_half = (lum * rf_mask) * inv_sqrt                       # (B,)
    small = dtau < 1e-4
    expfac = jnp.where(small, ds * (1.0 - 0.5 * dtau),
                       -jnp.expm1(-dtau) * ds / jnp.maximum(dtau, 1e-37))
    contrib = (lum_half * jnp.exp(-tau_before)) * (expfac * inv_sqrt)
    nrf = rf.shape[1]
    flat = cells * nrf + jnp.broadcast_to(rf_bin, cells.shape)
    return rf.reshape(-1).at[flat.reshape(-1)].add(
        contrib.reshape(-1)).reshape(rf.shape)


def interaction_point(pos0, dirn, cells, ds, dtau, tau_before, tau_int,
                      int_mask):
    """Locate the scattering interaction on a recorded march.

    Returns (ipos, icell, found, idx, frac): the first step where cumulative
    tau crosses tau_int, with linear-in-tau interpolation inside the step
    (ref: SpatialGridPath::findInteractionPoint, SpatialGridPath.hpp:155 —
    the reference's segment-array binary search becomes a dense argmax).
    idx/frac let the caller interpolate any other cumulative quantity (e.g.
    absorption optical depth for explicit-absorption weighting) at the
    interaction location.
    """
    cum = tau_before + dtau                       # (S,B)
    hit = (cum >= tau_int[None, :]) & (dtau > 0)
    found = jnp.any(hit, axis=0) & int_mask
    idx = jnp.argmax(hit, axis=0)                 # first hit step (B,)

    take = lambda a: jnp.take_along_axis(a, idx[None, :], axis=0)[0]
    ds_i = take(ds)
    dtau_i = take(dtau)
    tb_i = take(tau_before)
    s_before = jnp.cumsum(ds, axis=0) - ds
    sb_i = take(s_before)
    frac = jnp.clip((tau_int - tb_i) / jnp.maximum(dtau_i, 1e-37), 0.0, 1.0)
    s_total = sb_i + frac * ds_i
    ipos = pos0 + s_total[:, None] * dirn
    icell = take(cells)
    return ipos, icell, found, idx, frac


# --------------------------------------------------- shared event primitives
#
# Factored so the spatial-domain-decomposition engine (parallel/domain.py)
# reuses the EXACT forced-scattering sampling, scattering and termination
# rules (and RNG streams) instead of maintaining a drifting copy.

def sample_interaction_tau(opts: TransportOptions, keys, tau_path):
    """Interaction optical depth + bias weight for one event.

    Forced scattering with the composite uniform/exponential path-length
    bias (ref: MonteCarloSimulation::simulateForcedPropagation :696, bias
    mix :709-721) or plain exponential free path (non-forced, :746).
    Returns (tau_int, w_bias, ok): ok masks lanes whose path supports an
    interaction at all.
    """
    if opts.force_scattering:
        xi = opts.path_length_bias
        one_minus_exp = -jnp.expm1(-tau_path)
        if xi > 0:
            u_choice = rng.uniform(keys, _TAG_PATH_CHOICE)
            tau_uni = rng.uniform(keys, _TAG_PATH_TAU_UNI) * tau_path
            tau_exp = rng.expon_cutoff(keys, _TAG_PATH_TAU_EXP, tau_path)
            tau_int = jnp.where(u_choice < xi, tau_uni, tau_exp)
            p = jnp.exp(-tau_int) / jnp.maximum(one_minus_exp, 1e-30)
            q = (1.0 - xi) * p + xi / jnp.maximum(tau_path, 1e-30)
            w_bias = one_minus_exp * p / jnp.maximum(q, 1e-30)
        else:
            tau_int = rng.expon_cutoff(keys, _TAG_PATH_TAU_EXP, tau_path)
            w_bias = one_minus_exp
        return tau_int, w_bias, tau_path > 1e-6
    tau_int = rng.expon(keys, _TAG_PATH_TAU_EXP)
    return tau_int, jnp.ones_like(tau_path), jnp.ones_like(tau_path, bool)


def hg_scatter_direction(keys, g_sel, dirn):
    """Henyey-Greenstein direction update (ref: DustMix HG sampling)."""
    ct = phs.hg_sample_costheta(g_sel, rng.uniform(keys, _TAG_SCATTER_CT))
    phi = 2.0 * jnp.pi * rng.uniform(keys, _TAG_SCATTER_PHI)
    return phs.rotate_direction(dirn, ct, phi)


def survives_cutoff(opts: TransportOptions, lum_new, nscat_new, lum0):
    """Weight-cutoff / min-scattering termination test
    (ref: MonteCarloSimulation.cpp:563)."""
    return (lum_new * opts.min_weight_reduction > lum0) | \
        (nscat_new < opts.min_scatt_events)


def albedo_and_weights(opt: msys.Optics, nd_at):
    """Aggregate albedo + normalized per-component scattering weights from
    the LOCAL densities at the interaction (nd_at: (B, H)) — the
    cell-gather-free form shared with the domain-decomposition engine,
    where nd_at arrives via a psum instead of a table gather
    (ref: MediumSystem::albedoForScattering + per-component weights,
    MediumSystem.cpp:678,734)."""
    ke = jnp.sum(nd_at * opt.sigma_ext, axis=-1)
    ks = jnp.sum(nd_at * opt.sigma_sca, axis=-1)
    albedo = jnp.where(ke > 0, ks / jnp.maximum(ke, 1e-30), 0.0)
    w = nd_at * opt.sigma_sca
    w = w / jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1e-30)
    return albedo, w


def select_component_from_weights(w, u):
    """Sample the scattering component from normalized weights (B, H)
    (ref: MediumSystem::simulateScattering h-selection cdf)."""
    cdf = jnp.cumsum(w, axis=-1)
    return jnp.argmax(cdf >= u[..., None], axis=-1).astype(jnp.int32)


def scatter_nonpolarized(opts: TransportOptions, keys, opt, w, h, dirn,
                         lam_cell=None, phase_tabs=None):
    """The non-polarized scattering event proper: HG by default, the
    tabulated MaterialPhaseFunction when phase_tabs is given — ONE
    implementation for the replicated and domain-decomposed engines
    (ref: MaterialMix::performScattering)."""
    if phase_tabs is not None:
        ct = phs.tabulated_phase_sample(phase_tabs, lam_cell,
                                        rng.uniform(keys, _TAG_SCATTER_CT))
        phi = 2.0 * jnp.pi * rng.uniform(keys, _TAG_SCATTER_PHI)
        return phs.rotate_direction(dirn, ct, phi)
    g_sel = jnp.take_along_axis(opt.g, h[..., None], axis=-1)[..., 0]
    return hg_scatter_direction(keys, g_sel, dirn)


def peel_phase_nonpolarized(opt, w, dirn, lam_cell=None, phase_tabs=None):
    """per-steradian phase value toward an observer direction builder for
    the non-polarized peel-off (shared with the DD engine)."""
    def per_sr_phase(kobs):
        ct = jnp.sum(dirn * kobs, axis=-1)
        if phase_tabs is not None:
            return phs.tabulated_phase_value(phase_tabs, lam_cell,
                                             ct) / (4.0 * jnp.pi)
        return jnp.sum(w * phs.hg_phase(opt.g, ct[..., None]), axis=-1)
    return per_sr_phase


# ------------------------------------------------------------------- peel-off

def _observer_groups(inst_cfgs) -> list[list[int]]:
    """Group instrument indices by identical observer geometry so the
    observer-direction tau march is shared (ref: consecutive same-observer
    optimization, SKIRT/core/Instrument.hpp:126)."""
    groups: list[list[int]] = []
    seen: dict[tuple, int] = {}
    for i, cfg in enumerate(inst_cfgs):
        key = (cfg.inclination, cfg.azimuth, cfg.distance)
        if key in seen:
            groups[seen[key]].append(i)
        else:
            seen[key] = len(groups)
            groups.append([i])
    return groups


def peel_off(grid, med, opt, inst_cfgs, inst_tabs, accs, lam, pos, cell,
             contrib_per_sr: Callable[[jax.Array], jax.Array],
             kind: int, max_steps: int, active: jax.Array,
             transparent_too: bool = False, lam_fn=None, lam_march=None,
             march_uses_lam_fn: bool = False, lya: bool = False,
             tracer=None, dist=None, stokes_fn=None, level=None):
    """Peel a batch of events off toward every instrument.

    contrib_per_sr(kobs) -> (B,) luminosity per steradian toward the observer
    (phase-function weighting included by the caller). With kinematics,
    lam_fn(kobs) supplies the observer-frame detection wavelengths and
    lam_march the model-frame wavelengths for Doppler-aware extinction.
    """
    accs = list(accs)
    for group in _observer_groups(inst_cfgs):
        kobs = inst_tabs[group[0]]["kobs"]
        B = lam.shape[0]
        kdir = jnp.broadcast_to(kobs, (B, 3))
        lam_for_march = lam_march
        if march_uses_lam_fn and lam_fn is not None:
            lam_for_march = lam_fn(kobs)
        if tracer is not None:
            tau_obs = tracer(opt, pos, kdir, cell, active, lam_for_march,
                             lya)
        else:
            tau_obs = trace_tau(grid, med, opt, pos, kdir, cell, max_steps,
                                active, lam=lam_for_march, lya=lya)
        att = jnp.exp(-tau_obs)
        for i in group:
            ko = inst_tabs[i]["kobs"]
            per_sr = contrib_per_sr(ko)
            lam_i = lam if lam_fn is None else lam_fn(ko)
            quv = stokes_fn(ko, inst_tabs[i]) if stokes_fn is not None \
                else None
            accs[i] = dinst.detect(inst_cfgs[i], inst_tabs[i], accs[i],
                                   lam_i, pos, per_sr * att, kind, active,
                                   dist=dist, stokes_quv=quv, level=level)
            if transparent_too:
                # Stokes accumulators record only arriving (attenuated)
                # luminosity — the reference's FluxRecorder keeps no Stokes
                # for the transparent bookkeeping component, so passing quv
                # here would double-count Q/U/V in thin media.
                accs[i] = dinst.detect(inst_cfgs[i], inst_tabs[i], accs[i],
                                       lam_i, pos, per_sr,
                                       dinst.KIND_TRANSPARENT, active,
                                       dist=dist, stokes_quv=None)
    return accs


def peel_off_local(grid, med, opt, cfgs, tabs, accs, lam, pos, cell,
                   contrib_per_sr: Callable[[jax.Array], jax.Array],
                   kind: int, max_steps: int, active: jax.Array,
                   lam_march=None):
    """Peel-off toward interior (all-sky) observers: per-packet observer
    directions and 1/d^2 local calibration (ref: AllSkyInstrument detection
    + FluxRecorder local-instrument distance factor)."""
    accs = list(accs)
    for i, (cfg, tab) in enumerate(zip(cfgs, tabs)):
        k, dist = asky.observer_directions(tab, pos)
        per_sr = contrib_per_sr(k)
        tau_obs = trace_tau(grid, med, opt, pos, k, cell, max_steps,
                            active, lam=lam_march)
        contrib = per_sr * jnp.exp(-tau_obs) / jnp.maximum(dist * dist, 1e-30)
        if getattr(cfg, "is_perspective", False):
            from ..instruments import perspective as persp
            accs[i] = persp.detect(cfg, tab, accs[i], lam, pos, dist,
                                   contrib, kind, active)
        else:
            accs[i] = asky.detect(cfg, tab, accs[i], lam, -k, contrib, kind,
                                  active)
    return accs


# ---------------------------------------------------------------- the life cycle

def life_cycle(grid, med: msys.MediumTables, opts: TransportOptions,
               inst_cfgs, inst_tabs, rf_borders: jax.Array | None,
               pkt: PacketBatch, rf: jax.Array | None, accs: list[dict],
               emission_phase: Callable[[jax.Array], jax.Array] | None = None,
               emission_polarization=None,
               mueller: "stk.MuellerTables | None" = None,
               emit_mask: jax.Array | None = None,
               return_state: bool = False, xray_tabs: dict | None = None,
               phase_tabs: dict | None = None):
    """Run the complete life cycle of one launched packet batch.

    Equivalent of performLifeCycle for the whole batch: emission peel-off,
    then up to max_events forced-scattering cycles. Returns (rf, accs), or
    (rf, accs, pkt) when return_state is set (lane-refill generations).

    emission_phase(kobs, pos) -> (B,) angular emission probability per sr
    toward the observer (pos enables surface sources whose phase depends on
    the packet's local normal); None means isotropic (1/4pi).

    emit_mask: lanes whose emission peel-off should be recorded this call
    (defaults to all alive lanes); under lane refill only the freshly
    launched lanes emit — surviving lanes already did in a prior call.
    """
    opt = msys.optics_at(med, pkt.lam)
    # wavelength-changing scattering (Compton/Lya/X-ray): per-event optics
    # must re-derive from the CURRENT packet wavelengths (round-3 fix: the
    # once-per-segment optics were stale after the first shift)
    lam_changing = opts.compton or opts.lya or opts.xray
    # split instruments into distant observers (shared-direction peel-off)
    # and local all-sky observers (per-packet directions)
    dist_ids = tuple(i for i, c_ in enumerate(inst_cfgs)
                     if not getattr(c_, "is_local", False))
    local_ids = tuple(i for i, c_ in enumerate(inst_cfgs)
                      if getattr(c_, "is_local", False))

    def _stitch(accs, ids, sub):
        accs = list(accs)
        for j, i in enumerate(ids):
            accs[i] = sub[j]
        return accs

    kind_direct = (dinst.KIND_PRIMARY_DIRECT if opts.primary
                   else dinst.KIND_SECONDARY_DIRECT)
    kind_scat = (dinst.KIND_PRIMARY_SCATTERED if opts.primary
                 else dinst.KIND_SECONDARY_SCATTERED)

    use_rf = opts.store_rf and rf is not None and rf_borders is not None
    if use_rf:
        nrf = rf_borders.shape[0] - 1
        from ..ops import sampling as _smp
        rf_bin = jnp.clip(_smp.searchsorted_right(rf_borders, pkt.lam) - 1,
                          0, nrf - 1)
        rf_in_range = (pkt.lam >= rf_borders[0]) & (pkt.lam < rf_borders[-1])
    else:
        rf_bin = jnp.zeros_like(pkt.cell)
        rf_in_range = jnp.zeros_like(pkt.alive)

    do_peel = bool(inst_cfgs) and opts.peel_off

    emit = pkt.alive if emit_mask is None else (emit_mask & pkt.alive)

    # ---- emission peel-off (ref: MonteCarloSimulation::peelOffEmission :617)
    if do_peel:
        iso = 1.0 / (4.0 * jnp.pi)
        def _marks(fn, name):
            return getattr(fn, name,
                           getattr(getattr(fn, "__self__", None), name,
                                   False))

        if emission_phase is None:
            per_sr = lambda kobs: pkt.lum * iso
        elif _marks(emission_phase, "wants_cell"):
            # per-cell angular tables (spheroidal aligned-grain emission:
            # the profile depends on the cell's magnetic field direction)
            per_sr = lambda kobs: pkt.lum * emission_phase(
                kobs, pkt.pos, pkt.lam, pkt.cell)
        elif _marks(emission_phase, "wants_lam"):
            # wavelength-dependent angular tables (FilePolarizedPointSource)
            per_sr = lambda kobs: pkt.lum * emission_phase(kobs, pkt.pos,
                                                           pkt.lam)
        else:
            per_sr = lambda kobs: pkt.lum * emission_phase(kobs, pkt.pos)
        # Lya: the emission peel-off march needs the resonant Voigt opacity
        # at the packet wavelength (round-5 fix: without lya the direct
        # component escaped unattenuated at line center)
        lam_march0 = pkt.lam if (opts.kinematics or opts.lya) else None
        # polarized emission: per-observer Stokes from the source's
        # polarization profile, rotated into the instrument frame
        # (ref: MonteCarloSimulation::peelOffEmission polarized branch)
        emis_stokes_fn = None
        if emission_polarization is not None:
            def emis_stokes_fn(kobs, tab):
                B = pkt.lam.shape[0]
                ko = jnp.broadcast_to(kobs, (B, 3))
                if getattr(emission_polarization, "wants_cell", False):
                    st, pn = emission_polarization.stokes_for(ko, pkt.lam,
                                                              pkt.cell)
                elif getattr(emission_polarization, "wants_lam", False):
                    st, pn = emission_polarization.stokes_for(ko, pkt.lam)
                else:
                    st, pn = emission_polarization.stokes_for(ko)
                north = tab["ey"] - jnp.sum(tab["ey"] * kobs) * kobs
                north = north / jnp.maximum(jnp.linalg.norm(north), 1e-30)
                n_det = jnp.cross(kobs, north)
                cosb = jnp.sum(pn * n_det, axis=-1)
                sinb = jnp.sum(jnp.cross(pn, jnp.broadcast_to(
                    n_det, pn.shape)) * ko, axis=-1)
                beta = jnp.arctan2(sinb, cosb)
                st_final = stk.rotate_stokes(st, beta)
                return st_final[..., 1:]
        emis_lam_fn = None
        if opts.emission_doppler:
            # rest wavelength from the launch-direction Doppler factor, then
            # re-shift toward each observer
            lam_rest = pkt.lam / (1.0 - jnp.sum(pkt.dir * pkt.v_emit,
                                                axis=-1) * _INV_C)

            def emis_lam_fn(ko):
                B = pkt.lam.shape[0]
                kb = jnp.broadcast_to(ko, (B, 3))
                return lam_rest * (1.0 - jnp.sum(kb * pkt.v_emit, axis=-1)
                                   * _INV_C)
        if dist_ids:
            sub = peel_off(grid, med, opt,
                           [inst_cfgs[i] for i in dist_ids],
                           [inst_tabs[i] for i in dist_ids],
                           [accs[i] for i in dist_ids],
                           pkt.lam, pkt.pos, pkt.cell, per_sr, kind_direct,
                           opts.max_steps, emit, transparent_too=True,
                           lam_march=lam_march0, lam_fn=emis_lam_fn,
                           lya=opts.lya, dist=pkt.dist,
                           stokes_fn=emis_stokes_fn)
            accs = _stitch(accs, dist_ids, sub)
        if local_ids:
            sub = peel_off_local(grid, med, opt,
                                 [inst_cfgs[i] for i in local_ids],
                                 [inst_tabs[i] for i in local_ids],
                                 [accs[i] for i in local_ids],
                                 pkt.lam, pkt.pos, pkt.cell, per_sr,
                                 kind_direct, opts.max_steps, emit,
                                 lam_march=lam_march0)
            accs = _stitch(accs, local_ids, sub)

    # ---- scattering-event loop
    def event(carry, ev):
        pkt, rf, accs = carry
        # per-lane event counter: nscat == #events survived for alive lanes
        # (identical streams to the scalar counter without refill; allows
        # mixed-age batches under lane refill)
        keys = rng.event_keys(pkt.hkey, pkt.nscat)
        active = pkt.alive
        # λ-changing processes re-derive optics each event; otherwise the
        # segment-level tables hold (wavelength never changes)
        opt_ev = msys.optics_at(med, pkt.lam) if lam_changing else opt
        # ... and likewise the RF bin: after a fluorescence/Compton/Lya
        # shift the stored radiation field must bin by the CURRENT
        # wavelength (ref: MediumSystem::storeRadiationField bins the
        # packet's perceived wavelength per segment; round-3 advisory)
        ev_rf_bin, ev_rf_in_range = rf_bin, rf_in_range
        if lam_changing and use_rf:
            from ..ops import sampling as _smp_rf
            ev_rf_bin = jnp.clip(
                _smp_rf.searchsorted_right(rf_borders, pkt.lam) - 1,
                0, nrf - 1)
            ev_rf_in_range = ((pkt.lam >= rf_borders[0])
                              & (pkt.lam < rf_borders[-1]))

        # ONE march records the whole path; optical depth, RF deposits and
        # the interaction point all derive from the step table
        rf_mask = (active & ev_rf_in_range if use_rf
                   else jnp.zeros_like(active))
        rec = march_record(grid, med, opt_ev, pkt.pos, pkt.dir,
                           pkt.cell, opts.max_steps, active | rf_mask,
                           record_sca=opts.explicit_absorption,
                           lam=pkt.lam if (opts.kinematics or opts.lya)
                           else None, lya=opts.lya)
        if opts.explicit_absorption:
            # interaction sampled on the SCATTERING optical depth;
            # absorption applied as an explicit weight e^-tau_abs at the
            # interaction (ref: Configuration explicitAbsorption +
            # simulateForced/NonForcedPropagation variants)
            cells, ds, dtau_ext, dtau_s = rec
        else:
            cells, ds, dtau_ext = rec
            dtau_s = dtau_ext
        tau_before_ext = jnp.cumsum(dtau_ext, axis=0) - dtau_ext
        tau_before = jnp.cumsum(dtau_s, axis=0) - dtau_s
        tau_path = tau_before[-1] + dtau_s[-1]

        tau_int, w_bias, tau_ok = sample_interaction_tau(opts, keys,
                                                         tau_path)
        active_int = active & tau_ok

        if use_rf:
            rf = deposit_rf(rf, cells, ds, dtau_ext, tau_before_ext,
                            pkt.lum, ev_rf_bin, rf_mask, opts.rf_scale)
        ipos, icell, found, idx, frac = interaction_point(
            pkt.pos, pkt.dir, cells, ds, dtau_s, tau_before, tau_int,
            active_int)

        active_int = active_int & found
        if opts.kinematics:
            # wavelength perceived in the interaction cell's rest frame
            # (ref: PhotonPacket::perceivedWavelength)
            v_int = med.bulk_v[jnp.maximum(icell, 0)]
            lam_cell = pkt.lam / (1.0 - jnp.sum(pkt.dir * v_int, axis=-1)
                                  * _INV_C)
            opt_int = msys.optics_at(med, lam_cell)
        else:
            v_int = None
            lam_cell = pkt.lam
            opt_int = opt_ev
        lum_at = pkt.lum * w_bias
        if opts.explicit_absorption:
            # absorption optical depth accumulated up to the interaction
            take = lambda a: jnp.take_along_axis(a, idx[None, :], axis=0)[0]
            dtau_abs = dtau_ext - dtau_s
            tau_abs_at = (take(tau_before_ext) - take(tau_before)
                          + frac * take(dtau_abs))
            lum_at = lum_at * jnp.exp(-jnp.maximum(tau_abs_at, 0.0))
            albedo = jnp.ones_like(lum_at)
        else:
            albedo = msys.albedo_for_scattering(med, opt_int, icell)
        if opts.lya:
            albedo = jnp.ones_like(lum_at)  # pure resonant scattering
        if opts.xray:
            # scattering = electron channel + fluorescence channel; the
            # remainder is true absorption (ref: XRayAtomicGasMix channel
            # cross sections)
            from ..ops import sampling as _smp
            xt = xray_tabs
            sig_e_x = _smp.interp_loglog(lam_cell, xt["lam"],
                                         xt["sigma_sca"])
            sig_fl_x = _smp.interp_loglog(lam_cell, xt["lam"],
                                          xt["sigma_fluor"])
            sig_ext_x = _smp.interp_loglog(lam_cell, xt["lam"],
                                           xt["sigma_ext"])
            sca_tot = sig_e_x + sig_fl_x
            albedo = jnp.where(sig_ext_x > 0,
                               sca_tot / jnp.maximum(sig_ext_x, 1e-37), 0.0)
            p_fl = jnp.where(sca_tot > 0,
                             sig_fl_x / jnp.maximum(sca_tot, 1e-37), 0.0)

        # move packet to interaction point (accumulating the traveled
        # path for time-lag instruments, ref: PhotonPacket::propagate)
        step_len = jnp.linalg.norm(ipos - pkt.pos, axis=-1)
        pkt = pkt._replace(
            pos=jnp.where(active_int[..., None], ipos, pkt.pos),
            cell=jnp.where(active_int, icell, pkt.cell),
            lum=jnp.where(active_int, lum_at, pkt.lum),
            dist=jnp.where(active_int, pkt.dist + step_len, pkt.dist),
        )

        # component selection (shared by both polarization modes)
        u_comp = rng.uniform(keys, _TAG_SCATTER_COMP)
        h = msys.select_component(med, opt_int, icell, u_comp)

        polarized = opts.polarization and mueller is not None
        if polarized:
            s11n = stk.s11_norm(mueller)[h]  # (B,)

        # ---- Lyman-alpha resonant scattering (own peel-off + direction +
        # wavelength redistribution; ref: LyaUtils + LyaNeutralHydrogenGasMix
        # performScattering)
        if opts.lya:
            T_lya = jnp.maximum(med.temperature[jnp.maximum(icell, 0)], 1.0)
            a_lya = lyo.damping_parameter(T_lya)
            x_in = lyo.dimensionless_x(lam_cell, T_lya)
            u_par = lyo.sample_parallel_velocity(keys, _TAG_SCATTER_COMP + 40,
                                                 a_lya, x_in)
            inv_sqrt2 = 0.7071067811865476
            up1 = rng.gauss(keys, _TAG_SCATTER_COMP + 41) * inv_sqrt2
            up2 = rng.gauss(keys, _TAG_SCATTER_COMP + 42) * inv_sqrt2
            if opts.lya_xcrit > 0 or opts.lya_variable:
                # core-skipping: boost the perpendicular velocity so the
                # photon leaves the interaction in the wing (Smith+ scheme;
                # ref: LyaUtils.cpp:47-66). Constant scheme: fixed xcrit;
                # Variable scheme: per-cell strength * (nH/T)^(1/6)
                if opts.lya_variable:
                    nH_here = jnp.sum(med.nd[jnp.maximum(icell, 0)],
                                      axis=-1)
                    xc = opts.lya_strength * (
                        jnp.maximum(nH_here, 1e-30) / T_lya) ** (1.0 / 6.0)
                else:
                    xc = jnp.full_like(x_in, opts.lya_xcrit)
                skip = jnp.abs(x_in) < xc
                u_r = rng.uniform(keys, _TAG_SCATTER_COMP + 43)
                u_a = rng.uniform(keys, _TAG_SCATTER_COMP + 44)
                mag = jnp.sqrt(xc * xc - jnp.log(u_r))
                up1 = jnp.where(skip, mag * jnp.cos(2 * jnp.pi * u_a), up1)
                up2 = jnp.where(skip, mag * jnp.sin(2 * jnp.pi * u_a), up2)

            # direction: all wing events and 1/3 of core events follow the
            # dipole phase function, the rest isotropic, with core/wing
            # judged on the ATOM-frame frequency x - u.k = x - u_par
            # (ref: LyaUtils.cpp:98-101)
            x_atom = x_in - u_par
            u_dip = rng.uniform(keys, _TAG_SCATTER_COMP + 45)
            core = (jnp.abs(x_atom) <= 0.2) & (u_dip >= 1.0 / 3.0)
            u_ct = rng.uniform(keys, _TAG_SCATTER_CT)
            ct = jnp.where(core, 2.0 * u_ct - 1.0,
                           phs.dipole_sample_costheta(u_ct))
            phi_s = 2.0 * jnp.pi * rng.uniform(keys, _TAG_SCATTER_PHI)
            newdir = phs.rotate_direction(pkt.dir, ct, phi_s)
            lam_new_lya = lyo.scatter_wavelength(lam_cell, pkt.dir, newdir,
                                                 u_par, up1, T_lya)

            if do_peel:
                iso = 1.0 / (4.0 * jnp.pi)

                def lya_per_sr(kobs):
                    ct_o = jnp.sum(pkt.dir * kobs, axis=-1)
                    ph = jnp.where(core, iso, phs.dipole_phase(ct_o))
                    return pkt.lum * ph

                def lya_lam_fn(kobs):
                    B = pkt.lam.shape[0]
                    ko = jnp.broadcast_to(kobs, (B, 3))
                    return lyo.scatter_wavelength(lam_cell, pkt.dir, ko,
                                                  u_par, up1, T_lya)

                if dist_ids:
                    sub = peel_off(grid, med, opt_int,
                                   [inst_cfgs[i] for i in dist_ids],
                                   [inst_tabs[i] for i in dist_ids],
                                   [accs[i] for i in dist_ids],
                                   pkt.lam, pkt.pos, pkt.cell, lya_per_sr,
                                   kind_scat, opts.max_steps, active_int,
                                   lam_fn=lya_lam_fn,
                                   march_uses_lam_fn=True, lya=True,
                                   dist=pkt.dist)
                    accs = _stitch(accs, dist_ids, sub)
            pkt = pkt._replace(
                lam=jnp.where(active_int, lam_new_lya, pkt.lam))

        # ---- Compton scattering (KN angle sampling + wavelength shift;
        # ref: ComptonPhaseFunction::performScattering/peeloffScattering)
        if opts.compton:
            x_c = co.x_of_lambda(lam_cell)
            if do_peel and dist_ids:
                def kn_per_sr(kobs):
                    mu_o = jnp.sum(pkt.dir * kobs, axis=-1)
                    return pkt.lum * albedo * co.phase_value(x_c, mu_o)

                def kn_lam_fn(kobs):
                    B = pkt.lam.shape[0]
                    ko = jnp.broadcast_to(kobs, (B, 3))
                    mu_o = jnp.sum(pkt.dir * ko, axis=-1)
                    return co.shifted_wavelength(lam_cell, x_c, mu_o)

                sub = peel_off(grid, med, opt_int,
                               [inst_cfgs[i] for i in dist_ids],
                               [inst_tabs[i] for i in dist_ids],
                               [accs[i] for i in dist_ids],
                               pkt.lam, pkt.pos, pkt.cell, kn_per_sr,
                               kind_scat, opts.max_steps, active_int,
                               lam_fn=kn_lam_fn, march_uses_lam_fn=True,
                               dist=pkt.dist)
                accs = _stitch(accs, dist_ids, sub)
            mu_s = co.sample_costheta(rng.uniform(keys, _TAG_SCATTER_CT), x_c)
            phi_c = 2.0 * jnp.pi * rng.uniform(keys, _TAG_SCATTER_PHI)
            newdir = phs.rotate_direction(pkt.dir, mu_s, phi_c)
            lam_new_c = co.shifted_wavelength(lam_cell, x_c, mu_s)
            pkt = pkt._replace(
                lam=jnp.where(active_int, lam_new_c, pkt.lam))

        # ---- X-ray gas: fluorescence + Compton as the two scattering
        # channels; peel-off records BOTH channels with their probabilities
        # (ref: XRayAtomicGasMix::peeloffScattering iterates the channels)
        if opts.xray:
            from ..ops import sampling as _smp
            xt = xray_tabs
            x_c = co.x_of_lambda(lam_cell)
            # sample the fluorescence line for this event from the
            # energy-bin channel cdf
            L_ln = int(xt["line_lam"].shape[0])
            if L_ln > 0:
                kbin = jnp.clip(_smp.searchsorted_right(xt["lam"],
                                                        lam_cell) - 1,
                                0, xt["lam"].shape[0] - 1)
                rows = jnp.stack([_smp.take_small(xt["line_cdf"][:, li],
                                                  kbin)
                                  for li in range(L_ln)], axis=-1)
                u_line = rng.uniform(keys, _TAG_SCATTER_COMP + 50)
                li = jnp.clip(jnp.sum((rows < u_line[:, None]).astype(
                    jnp.int32), axis=1), 0, L_ln - 1)
                lam_line = _smp.take_small(xt["line_lam"], li)
            else:
                lam_line = lam_cell
            if do_peel and dist_ids:
                def xr_kn_per_sr(kobs):
                    mu_o = jnp.sum(pkt.dir * kobs, axis=-1)
                    return pkt.lum * albedo * (1.0 - p_fl) \
                        * co.phase_value(x_c, mu_o)

                def xr_kn_lam_fn(kobs):
                    B = pkt.lam.shape[0]
                    ko = jnp.broadcast_to(kobs, (B, 3))
                    mu_o = jnp.sum(pkt.dir * ko, axis=-1)
                    return co.shifted_wavelength(lam_cell, x_c, mu_o)

                sub = peel_off(grid, med, opt_int,
                               [inst_cfgs[i] for i in dist_ids],
                               [inst_tabs[i] for i in dist_ids],
                               [accs[i] for i in dist_ids],
                               pkt.lam, pkt.pos, pkt.cell, xr_kn_per_sr,
                               kind_scat, opts.max_steps, active_int,
                               lam_fn=xr_kn_lam_fn, march_uses_lam_fn=True,
                               dist=pkt.dist)
                accs = _stitch(accs, dist_ids, sub)
                iso_sr = 1.0 / (4.0 * jnp.pi)

                def xr_fl_per_sr(kobs):
                    return pkt.lum * albedo * p_fl * iso_sr

                sub = peel_off(grid, med, opt_int,
                               [inst_cfgs[i] for i in dist_ids],
                               [inst_tabs[i] for i in dist_ids],
                               [accs[i] for i in dist_ids],
                               pkt.lam, pkt.pos, pkt.cell, xr_fl_per_sr,
                               kind_scat, opts.max_steps, active_int,
                               lam_fn=lambda ko: lam_line,
                               march_uses_lam_fn=True, dist=pkt.dist)
                accs = _stitch(accs, dist_ids, sub)
            # channel selection + the scattering event proper
            u_ch = rng.uniform(keys, _TAG_SCATTER_COMP + 51)
            is_fl = u_ch < p_fl
            mu_s = co.sample_costheta(rng.uniform(keys, _TAG_SCATTER_CT),
                                      x_c)
            u_iso = rng.uniform(keys, _TAG_SCATTER_COMP + 52)
            mu_mix = jnp.where(is_fl, 2.0 * u_iso - 1.0, mu_s)
            phi_x = 2.0 * jnp.pi * rng.uniform(keys, _TAG_SCATTER_PHI)
            newdir = phs.rotate_direction(pkt.dir, mu_mix, phi_x)
            lam_new_x = jnp.where(is_fl, lam_line,
                                  co.shifted_wavelength(lam_cell, x_c,
                                                        mu_s))
            pkt = pkt._replace(
                lam=jnp.where(active_int, lam_new_x, pkt.lam))

        # scattering peel-off (ref: MonteCarloSimulation::peelOffScattering)
        if do_peel and not opts.lya and not opts.compton and not opts.xray:
            w_comp = msys.scattering_weights(med, opt_int, icell)  # (B,H)

            if not polarized:
                if phase_tabs is not None:
                    # MaterialPhaseFunction mode: tabulated custom phase
                    # (ref: DustMix.hpp:319 ScatteringMode enum)
                    def per_sr(kobs):
                        ct = jnp.sum(pkt.dir * kobs, axis=-1)
                        ph = phs.tabulated_phase_value(
                            phase_tabs, lam_cell, ct) / (4.0 * jnp.pi)
                        return pkt.lum * albedo * ph
                else:
                    def per_sr(kobs):
                        ct = jnp.sum(pkt.dir * kobs, axis=-1)
                        ph = jnp.sum(w_comp * phs.hg_phase(opt_int.g,
                                                           ct[..., None]),
                                     axis=-1)
                        return pkt.lum * albedo * ph

                lam_fn = None
                lam_march1 = pkt.lam if opts.kinematics else None
                if opts.kinematics:
                    lam_fn = lambda ko: lam_cell * (
                        1.0 - jnp.sum(ko * v_int, axis=-1) * _INV_C)
                if dist_ids:
                    sub = peel_off(grid, med, opt_int,
                                   [inst_cfgs[i] for i in dist_ids],
                                   [inst_tabs[i] for i in dist_ids],
                                   [accs[i] for i in dist_ids],
                                   pkt.lam, pkt.pos, pkt.cell, per_sr,
                                   kind_scat, opts.max_steps, active_int,
                                   lam_fn=lam_fn, lam_march=lam_march1,
                                   dist=pkt.dist, level=pkt.nscat + 1)
                    accs = _stitch(accs, dist_ids, sub)
                if local_ids:
                    sub = peel_off_local(grid, med, opt_int,
                                         [inst_cfgs[i] for i in local_ids],
                                         [inst_tabs[i] for i in local_ids],
                                         [accs[i] for i in local_ids],
                                         pkt.lam, pkt.pos, pkt.cell, per_sr,
                                         kind_scat, opts.max_steps,
                                         active_int, lam_march=lam_march1)
                    accs = _stitch(accs, local_ids, sub)
            else:
                # polarized peel-off: rotate into the (k, k_obs) scattering
                # plane, apply the Mueller matrix, record Stokes in the
                # instrument frame (ref: peelOffScattering polarization
                # branch, MonteCarloSimulation.cpp:629 + Peest+2017)
                def stokes_per_sr(kobs, tab):
                    B = pkt.lam.shape[0]
                    ko = jnp.broadcast_to(kobs, (B, 3))
                    ct_o = jnp.sum(pkt.dir * ko, axis=-1)
                    phi_o, pn = stk.rotate_normal_into_plane(pkt.dir,
                                                             pkt.normal, ko)
                    S11, S12, S33, S34 = stk.mueller_at(mueller, h, ct_o)
                    st_rot = stk.rotate_stokes(pkt.stokes, phi_o)
                    st_obs = stk.apply_mueller(st_rot, S11, S12, S33, S34)
                    st_obs, I_obs = stk.normalize_stokes(st_obs)
                    phase = I_obs / jnp.maximum(
                        2 * jnp.pi * s11n * jnp.maximum(pkt.stokes[..., 0],
                                                        1e-30), 1e-30)
                    contrib = pkt.lum * albedo * phase
                    # rotate the Q/U reference from the scattering-plane
                    # normal into the instrument frame: the detection
                    # normal is cross(kobs, ky) with ky the instrument
                    # up direction (ref: StokesVector::rotateIntoPlane
                    # via MonteCarloSimulation.cpp:629 rotateIntoPlane
                    # (bfkobs, bfky) -> nNew = cross(k, knew))
                    north = tab["ey"] - jnp.sum(tab["ey"] * kobs) * kobs
                    north = north / jnp.maximum(jnp.linalg.norm(north), 1e-30)
                    n_det = jnp.cross(kobs, north)
                    cosb = jnp.sum(pn * n_det, axis=-1)
                    sinb = jnp.sum(jnp.cross(pn, jnp.broadcast_to(
                        n_det, pn.shape)) * ko, axis=-1)
                    beta = jnp.arctan2(sinb, cosb)
                    st_final = stk.rotate_stokes(st_obs, beta)
                    return contrib, st_final[..., 1:]

                accs2 = list(accs)
                for gidx in _observer_groups(inst_cfgs):
                    kobs = inst_tabs[gidx[0]]["kobs"]
                    B = pkt.lam.shape[0]
                    kdir = jnp.broadcast_to(kobs, (B, 3))
                    tau_obs = trace_tau(grid, med, opt_ev, pkt.pos, kdir,
                                        pkt.cell, opts.max_steps, active_int)
                    att = jnp.exp(-tau_obs)
                    for i in gidx:
                        contrib, quv = stokes_per_sr(inst_tabs[i]["kobs"],
                                                     inst_tabs[i])
                        accs2[i] = dinst.detect(
                            inst_cfgs[i], inst_tabs[i], accs2[i], pkt.lam,
                            pkt.pos, contrib * att, kind_scat, active_int,
                            stokes_quv=quv, dist=pkt.dist)
                accs = accs2

        # the scattering event proper (ref: MediumSystem::simulateScattering
        # / MaterialMix::performScattering)
        if opts.lya or opts.compton or opts.xray:
            pass  # direction and wavelength already updated above
        elif not polarized:
            if phase_tabs is not None:
                ct_t = phs.tabulated_phase_sample(
                    phase_tabs, lam_cell, rng.uniform(keys, _TAG_SCATTER_CT))
                phi_t = 2.0 * jnp.pi * rng.uniform(keys, _TAG_SCATTER_PHI)
                newdir = phs.rotate_direction(pkt.dir, ct_t, phi_t)
            else:
                g_sel = jnp.take_along_axis(opt_int.g, h[..., None],
                                            axis=-1)[..., 0]
                newdir = hg_scatter_direction(keys, g_sel, pkt.dir)
        else:
            # sample (theta, phi) from the polarized phase function and
            # update direction, reference normal and Stokes state
            ct = stk.sample_costheta(mueller, h, rng.uniform(keys, _TAG_SCATTER_CT))
            S11s, S12s, S33s, S34s = stk.mueller_at(mueller, h, ct)
            phi = stk.sample_azimuth(S11s, S12s, pkt.stokes,
                                     rng.uniform(keys, _TAG_SCATTER_PHI))
            n_rot = (jnp.cos(phi)[..., None] * pkt.normal
                     + jnp.sin(phi)[..., None] * jnp.cross(pkt.dir, pkt.normal))
            m = jnp.cross(n_rot, pkt.dir)
            st = jnp.sqrt(jnp.maximum(0.0, 1.0 - ct * ct))
            newdir = ct[..., None] * pkt.dir + st[..., None] * m
            newdir = newdir / jnp.linalg.norm(newdir, axis=-1, keepdims=True)
            st_new = stk.apply_mueller(stk.rotate_stokes(pkt.stokes, phi),
                                       S11s, S12s, S33s, S34s)
            st_new, _ = stk.normalize_stokes(st_new)
            pkt = pkt._replace(
                stokes=jnp.where(active_int[..., None], st_new, pkt.stokes),
                normal=jnp.where(active_int[..., None], n_rot, pkt.normal),
            )

        if opts.kinematics and not opts.lya:
            lam_new = lam_cell * (1.0 - jnp.sum(newdir * v_int, axis=-1)
                                  * _INV_C)
            pkt = pkt._replace(
                lam=jnp.where(active_int, lam_new, pkt.lam))

        lum_new = pkt.lum * albedo
        nscat_new = pkt.nscat + 1
        survive = survives_cutoff(opts, lum_new, nscat_new, pkt.lum0)
        alive_new = active_int & survive & (lum_new > 0)

        pkt = pkt._replace(
            dir=jnp.where(active_int[..., None], newdir, pkt.dir),
            lum=jnp.where(active_int, lum_new, pkt.lum),
            nscat=jnp.where(active_int, nscat_new, pkt.nscat),
            alive=alive_new,
        )
        return (pkt, rf, accs), None

    # while-loop with early exit: most packets terminate well before
    # max_events (weight cutoff), and pure-absorption runs finish after one
    # event — the reference's per-packet while loop achieves the same
    # adaptivity via MIMD threads (ref: performLifeCycle while(true) loop)
    def cond(state):
        ev, carry = state
        pkt_c = carry[0]
        return (ev < opts.max_events) & jnp.any(pkt_c.alive)

    def body(state):
        ev, carry = state
        carry, _ = event(carry, ev)
        return (ev + 1, carry)

    _, (pkt, rf, accs) = jax.lax.while_loop(
        cond, body, (jnp.int32(0), (pkt, rf, accs)))
    if return_state:
        return rf, accs, pkt
    return rf, accs
