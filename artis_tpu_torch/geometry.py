"""Vector / relativistic-frame math, batched over packet tensors.

Port of the JAX package's geometry module (reference: vectors.h:18-385),
the Stokes-vector frame machinery of polarised electron scattering
included: every function works on tensors whose last axis is the 3-vector
axis.
"""

from __future__ import annotations

import torch

from .constants import CLIGHT, CLIGHTSQUARED, CLIGHT_PROP, PI, SYN_DIR


def dot(a, b):
    """Batched 3-vector dot product (reference: vectors.h:36-40)."""
    return torch.sum(a * b, dim=-1)


def vec_len(v):
    return torch.sqrt(dot(v, v))


def vec_norm(v):
    return v / vec_len(v)[..., None]


def cross(a, b):
    """Batched cross product (reference: vectors.h:47-51)."""
    return torch.stack([
        a[..., 1] * b[..., 2] - b[..., 1] * a[..., 2],
        a[..., 2] * b[..., 0] - b[..., 2] * a[..., 0],
        a[..., 0] * b[..., 1] - b[..., 0] * a[..., 1],
    ], dim=-1)


def get_velocity(pos, t):
    """Homologous-flow velocity v = x/t (reference: vectors.h:43-45)."""
    if not torch.is_tensor(t):
        t = torch.as_tensor(t, dtype=pos.dtype, device=pos.device)
    return pos / t[..., None]


def angle_ab(dir1, vel):
    """Relativistic aberration of a direction unit vector
    (reference: vectors.h:61-74)."""
    vsqr = dot(vel, vel) / CLIGHTSQUARED
    gamma_rel = 1.0 / torch.sqrt(1.0 - vsqr)
    ndotv = dot(dir1, vel)
    fact1 = gamma_rel * (1.0 - ndotv / CLIGHT)
    fact2 = (gamma_rel - (gamma_rel * gamma_rel * ndotv / (gamma_rel + 1.0) / CLIGHT)) / CLIGHT
    dir2 = (dir1 - vel * fact2[..., None]) / fact1[..., None]
    return vec_norm(dir2)


def doppler_nucmf_on_nurf(pos_rf, dir_rf, prop_time, relativistic: bool):
    """Doppler factor nu_cmf/nu_rf (reference: vectors.h:108-131)."""
    vel_rf = get_velocity(pos_rf, prop_time)
    ndotv = dot(dir_rf, vel_rf)
    dopplerfactor = 1.0 - ndotv / CLIGHT
    if relativistic:
        betasq = dot(vel_rf, vel_rf) / CLIGHTSQUARED
        dopplerfactor = dopplerfactor / torch.sqrt(1.0 - betasq)
    return dopplerfactor


def doppler_squared_nucmf_on_nurf(pos_rf, dir_rf, prop_time, relativistic: bool):
    """(nu_cmf/nu_rf)^2 (reference: vectors.h:82-100)."""
    vel_rf = get_velocity(pos_rf, prop_time)
    ndotv_on_c = dot(dir_rf, vel_rf) / CLIGHT
    if relativistic:
        return (1.0 - ndotv_on_c) ** 2 / (1.0 - dot(vel_rf, vel_rf) / CLIGHTSQUARED)
    return 1.0 - 2.0 * ndotv_on_c


def move_pkt(pos, dir_rf, prop_time, nu_rf, nu_cmf, e_rf, distance, relativistic: bool):
    """Advance packets a rest-frame ``distance``; nu_cmf is clamped
    non-increasing (reference: vectors.h:134-158).
    Returns (pos', prop_time', nu_cmf', e_cmf', dopplerfactor)."""
    new_time = prop_time + distance / CLIGHT_PROP
    new_pos = pos + dir_rf * distance[..., None]
    dopplerfactor = doppler_nucmf_on_nurf(new_pos, dir_rf, new_time, relativistic)
    new_nu_cmf = torch.minimum(nu_rf * dopplerfactor, nu_cmf)
    new_e_cmf = e_rf * dopplerfactor
    return new_pos, new_time, new_nu_cmf, new_e_cmf, dopplerfactor


def get_arrive_time(pos, dir_rf, escape_time):
    """Observer arrival time t_esc - (pos.dir)/c (reference: vectors.h:168-170)."""
    return escape_time - dot(pos, dir_rf) / CLIGHT_PROP


def get_escapedirectionbin(dir_in, ncosthetabins: int, nphibins: int):
    """Escape-direction bin over a costheta x phi grid
    (reference: vectors.h:172-202)."""
    syn_dir = torch.as_tensor(SYN_DIR, dtype=dir_in.dtype, device=dir_in.device)
    xhat = torch.tensor((1.0, 0.0, 0.0), dtype=dir_in.dtype, device=dir_in.device)
    d = vec_norm(dir_in)
    costheta = dot(d, syn_dir)
    # NB: reference divides by NPHIBINS here (not NCOSTHETABINS) — preserved.
    costhetabin = torch.clamp(((costheta + 1.0) * nphibins / 2.0).long(), max=ncosthetabins - 1)
    vec1 = cross(d, syn_dir)
    vec2 = cross(xhat.expand_as(d), syn_dir)
    cosphi = torch.clamp(dot(vec1, vec2) / vec_len(vec1) / vec_len(vec2), -1.0, 1.0)
    vec3 = cross(vec2, syn_dir)
    testphi = dot(vec1, vec3)
    phi = torch.where(testphi >= 0, torch.arccos(cosphi), torch.arccos(cosphi) + PI)
    phibin = torch.clamp((phi / 2.0 / PI * nphibins).long(), max=nphibins - 1)
    return costhetabin * nphibins + phibin


# --- Stokes-vector frame machinery (polarisation) -------------------------
# Directions on the polar axis have no meridian frame (a 0/0 in ``meridian``)
# and a scattering by angle 0 has no scattering plane (a zero vector in
# ``get_rot_angle``): both give NaN, which the caller turns into an
# unpolarised packet (engine.electron_scatter_lanes), as the JAX package does.


def meridian(n):
    """Meridian-frame axes ref1, ref2 for direction n (reference: vectors.h:252-262)."""
    n_xylen = torch.sqrt(n[..., 0] ** 2 + n[..., 1] ** 2)
    ref1 = torch.stack([-n[..., 0] * n[..., 2] / n_xylen,
                        -n[..., 1] * n[..., 2] / n_xylen,
                        (1.0 - n[..., 2] ** 2) / n_xylen], dim=-1)
    return ref1, cross(ref1, n)


def get_rot_angle(n1, n2, ref1, ref2):
    """Rotation angle from the scattering plane (reference: vectors.h:216-249)."""
    ref1_sc = vec_norm(n1 * dot(n1, n2)[..., None] - n2)
    c1 = torch.clamp(dot(ref1_sc, ref1), -1.0, 1.0)
    c2 = dot(ref1_sc, ref2)
    base = torch.arccos(torch.abs(c1))
    i = torch.where((c1 > 0) & (c2 > 0), base,
                    torch.where((c1 < 0) & (c2 > 0), PI - base,
                                torch.where((c1 > 0) & (c2 < 0), 2.0 * PI - base, PI + base)))
    i = torch.where(c1 == 0, torch.full_like(i, PI / 2.0), i)
    return torch.where(c2 == 0, torch.zeros_like(i), i)


def lorentz(e_rf, n_rf, v):
    """Lorentz transform of the electric-field unit vector
    (reference: vectors.h:264-294)."""
    beta = v / CLIGHT
    vsqr = dot(beta, beta)
    gamma_rel = 1.0 / torch.sqrt(1.0 - vsqr)
    e_par = beta * (dot(e_rf, beta) / vsqr)[..., None]
    e_perp = e_rf - e_par
    v_cr_b = cross(beta, cross(n_rf, e_rf))
    return vec_norm(e_par + gamma_rel[..., None] * (e_perp + v_cr_b))


def frame_transform(n_rf, q, u, v):
    """Transform Stokes Q, U from the rest frame to the comoving frame of
    velocity v; returns (n_cmf, Q', U') (reference: vectors.h:297-385)."""
    ref1_rf, ref2_rf = meridian(n_rf)
    p = torch.sqrt(q * q + u * u)
    safe_p = torch.where(p > 0, p, torch.ones_like(p))
    cos2, sin2 = q / safe_p, u / safe_p
    half = torch.arccos(torch.clamp(torch.abs(cos2), 0.0, 1.0))
    rot2 = torch.where((cos2 > 0) & (sin2 > 0), half,
                       torch.where((cos2 < 0) & (sin2 > 0), PI - half,
                                   torch.where((cos2 < 0) & (sin2 < 0), PI + half,
                                               2.0 * PI - half)))
    rot2 = torch.where(cos2 == 0, torch.where(u < 0, 1.5 * PI, 0.5 * PI * torch.ones_like(u)),
                       rot2)
    rot2 = torch.where(sin2 == 0, torch.where(q < 0, PI, torch.zeros_like(q)), rot2)
    rot_angle = torch.where(p > 0, rot2 / 2.0, torch.zeros_like(rot2))
    ca, sa = torch.cos(rot_angle)[..., None], torch.sin(rot_angle)[..., None]
    elec_rf = ca * ref1_rf - sa * ref2_rf
    n_cmf = angle_ab(n_rf, v)
    elec_cmf = lorentz(elec_rf, n_rf, v)
    ref1_cmf, ref2_cmf = meridian(n_cmf)
    c1 = dot(elec_cmf, ref1_cmf)
    c2 = dot(elec_cmf, ref2_cmf)
    base = torch.arccos(torch.clamp(torch.abs(c1), 0.0, 1.0))
    theta = torch.where((c1 > 0) & (c2 < 0), base,
                        torch.where((c1 < 0) & (c2 > 0), PI + base,
                                    torch.where((c1 < 0) & (c2 < 0), PI - base,
                                                2.0 * PI - base)))
    theta = torch.where(c1 == 0, torch.full_like(theta, PI / 2.0), theta)
    theta = torch.where(c2 == 0, torch.zeros_like(theta), theta)
    theta = torch.where(c1 > 1, torch.zeros_like(theta), theta)
    theta = torch.where(c1 < -1, torch.full_like(theta, PI), theta)
    return n_cmf, torch.cos(2.0 * theta) * p, torch.sin(2.0 * theta) * p
