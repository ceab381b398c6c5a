"""Trajectory analysis observables (on-device, jit-friendly).

The reference inherits analysis from the OpenMM ecosystem (MDTraj etc.);
a standalone engine ships the workhorse: the radial distribution function,
computed as a chunked min-image pair histogram under jit (a [chunk, N]
distance tile per scan step — no O(N^2) materialization).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..pairs import delta_periodic


def mean_squared_displacement(frames, max_lag: int = None):
    """MSD(lag) over a trajectory of UNWRAPPED [F, N, 3] coordinates
    (this engine never wraps positions, so trajectories are directly
    usable); returns [max_lag] with MSD[l] averaged over all start times
    and atoms.  Host-side NumPy — analysis of saved trajectories, not a
    jit path.  Diffusion coefficient: D = slope / (6 dt) in the linear
    regime."""
    frames = np.asarray(frames, np.float64)
    f = frames.shape[0]
    if max_lag is None:
        max_lag = f - 1
    max_lag = min(max_lag, f - 1)
    out = np.empty(max_lag, np.float64)
    for lag in range(1, max_lag + 1):
        d = frames[lag:] - frames[:-lag]
        out[lag - 1] = np.mean(np.sum(d * d, axis=-1))
    return out


def velocity_autocorrelation(vel_frames, max_lag: int = None):
    """Normalized VACF over [F, N, 3] velocity frames: C(lag) =
    <v(t).v(t+lag)> / <v.v>, averaged over start times and atoms
    (host-side NumPy, like :func:`mean_squared_displacement`).  The
    diffusion coefficient is D = (1/3) integral C(t) <v^2> dt; the first
    zero crossing locates the cage-rattling time in liquids."""
    v = np.asarray(vel_frames, np.float64)
    f = v.shape[0]
    if max_lag is None:
        max_lag = f - 1
    max_lag = min(max_lag, f - 1)
    c0 = np.mean(np.sum(v * v, axis=-1))
    out = np.empty(max_lag + 1, np.float64)
    out[0] = 1.0
    for lag in range(1, max_lag + 1):
        out[lag] = np.mean(np.sum(v[lag:] * v[:-lag], axis=-1)) / c0
    return out


def total_dipole(positions, system):
    """Total dipole moment M = sum_i q_i(x) x_i (e*nm) with the
    geometry-dependent *effective* charges — the observable charge-flux
    models exist for (IR intensities come from dM/dt correlations, which
    fixed-charge models get qualitatively wrong).  Because every flux term
    conserves total charge (reference: ReferenceCoulKernels.cpp:60-62,
    112-115, 188-193 scatter balanced +/-dq), sum q_i = sum q0_i; for a
    neutral system M is translation-invariant and well-defined on the
    engine's unwrapped coordinates.  jit-friendly; vmap over frames for a
    trajectory."""
    from ..charges import effective_charges

    q = effective_charges(positions, system)
    return jnp.sum(q[:, None] * positions, axis=0)


def dipole_autocorrelation(m_frames, max_lag: int = None):
    """Normalized total-dipole *fluctuation* ACF over [F, 3] dipole
    frames: C(lag) = <dM(t).dM(t+lag)> / <dM.dM> with dM = M - <M>
    (host-side NumPy).  The mean is subtracted — matching
    :func:`infrared_spectrum` — so C(t) decays to 0 and its Fourier
    transform is the IR absorption line shape; without it the <M>^2
    offset leaves a spurious DC spike.  A constant dipole has no
    fluctuations: C is defined as identically 1 in that degenerate case.
    Delegates to :func:`velocity_autocorrelation` (same estimator on the
    centered frames)."""
    m = np.asarray(m_frames, np.float64)
    dm = m - m.mean(axis=0, keepdims=True)
    f = m.shape[0]
    if max_lag is None:
        max_lag = f - 1
    max_lag = min(max_lag, f - 1)
    if not np.any(dm):
        return np.ones(max_lag + 1, np.float64)
    return velocity_autocorrelation(dm, max_lag)


def infrared_spectrum(m_frames, dt: float):
    """IR line shape from a total-dipole trajectory [F, 3] sampled every
    ``dt`` ps: returns (frequencies in THz, I(nu) ~ nu^2 |FT{M}|^2, the
    harmonic-approximation absorption profile up to constants).  Uses the
    derivative theorem (FT of dM/dt ACF = omega^2 |FT M|^2) so no finite
    differencing of M is needed.  Host-side NumPy."""
    m = np.asarray(m_frames, np.float64)
    m = m - m.mean(axis=0, keepdims=True)
    ft = np.fft.rfft(m, axis=0)
    power = np.sum(np.abs(ft) ** 2, axis=-1)
    freq = np.fft.rfftfreq(m.shape[0], d=dt)
    return freq, (2.0 * np.pi * freq) ** 2 * power


def radial_distribution(positions, box, idx_a, idx_b, r_max: float,
                        n_bins: int = 100, chunk: int = 512):
    """g(r) between selections ``idx_a`` and ``idx_b`` (atom index arrays)
    in an orthorhombic box; returns (r_centers [n_bins], g [n_bins]).

    Ordered pairs i != j are histogrammed in chunks of ``idx_a`` rows and
    normalized by the ideal-gas shell count  N_a * N_b(-1) * 4 pi r^2 dr
    / V — so a uniform fluid gives g = 1.  ``r_max`` should be <=
    min(box)/2 (min-image sphere).
    """
    positions = jnp.asarray(positions)
    box = jnp.asarray(box, positions.dtype)
    idx_a = np.asarray(idx_a, np.int64).reshape(-1)
    idx_b = np.asarray(idx_b, np.int64).reshape(-1)
    n_a, n_b = idx_a.shape[0], idx_b.shape[0]
    pa_all = positions[jnp.asarray(idx_a)]
    pb = positions[jnp.asarray(idx_b)]
    # the weight mask drops every i == j index pair, so the ideal-gas
    # normalizer must drop the same count — for ANY overlap, not just
    # identical selections
    overlap = len(np.intersect1d(idx_a, idx_b))

    pad = (-n_a) % chunk
    # pad rows sit far outside r_max (finite: inf would NaN the min-image)
    pa_pad = jnp.concatenate(
        [pa_all, jnp.full((pad, 3), 1e6, positions.dtype)]) \
        if pad else pa_all
    ia_all = jnp.asarray(idx_a.astype(np.int32))
    ib = jnp.asarray(idx_b.astype(np.int32))
    ia_pad = (jnp.concatenate([ia_all, jnp.full((pad,), -1, jnp.int32)])
              if pad else ia_all)
    n_chunks = pa_pad.shape[0] // chunk
    edges = jnp.linspace(0.0, r_max, n_bins + 1)

    def body(hist, c):
        pa = jax.lax.dynamic_slice_in_dim(pa_pad, c * chunk, chunk)
        ia = jax.lax.dynamic_slice_in_dim(ia_pad, c * chunk, chunk)
        d = delta_periodic(pa[:, None, :], pb[None, :, :], box)
        r = jnp.sqrt(jnp.sum(d * d, axis=-1))
        w = ((ia[:, None] >= 0)
             & (ia[:, None] != ib[None, :])).astype(positions.dtype)
        h, _ = jnp.histogram(r, bins=edges, weights=w)
        return hist + h, None

    hist0 = jnp.zeros((n_bins,), positions.dtype)
    hist, _ = jax.lax.scan(body, hist0,
                           jnp.arange(n_chunks, dtype=jnp.int32))
    vol = box[0] * box[1] * box[2]
    r_lo, r_hi = edges[:-1], edges[1:]
    shell = 4.0 / 3.0 * jnp.pi * (r_hi ** 3 - r_lo ** 3)
    n_pairs = n_a * n_b - overlap
    ideal = n_pairs * shell / vol
    g = jnp.where(ideal > 0, hist / ideal, 0.0)
    return 0.5 * (r_lo + r_hi), g
