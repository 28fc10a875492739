"""Non-thermal electron degradation: the Spencer-Fano solver and the
work-function approximation (reference: nonthermal.cc:2391-2541
solve_spencerfano, 1785-1833 sfmatrix_add_excitation, 1835-1940
sfmatrix_add_ionization, 933-948 electron_loss_rate, 955-973
xs_impactionization (Younger 1981), 1355-1408 get_xs_excitation_vector,
1060-1095 calculate_frac_heating, 1157-1168 frac_ionization per shell,
1225-1330 calculate_eff_ionpot_auger_rates, 1340-1349
nt_ionization_ratecoeff_sf, 566-597 and 1136-1156 the work function).

The host half reads the data files (``collion.txt``, the binding energies,
the optional Kaastra & Mewe 1993 Auger table) and builds the shell and
excitation tables once per run (``build_nonthermal_data``); it is the JAX
package's numpy code, copied because that module imports jax.

The tensor half solves one upper-triangular SF_POINTS x SF_POINTS system
per cell, for all cells at once, in float64 whatever the transport dtype:

- the excitation term is banded, M[i, j] += sum_t A_t[j] 1[j - i <
  eps_t / dE], which contracts into one (nexc) x (energy, band) product
  with a fractional band indicator for the partial bin at the band's end;
- each ionisation shell adds a closed-form (S, S) update weighted by its
  ion's population: the (nshells, S, S) updates are built once and summed
  into the (ncells, S, S) matrix by one product over the shell axis;
- the solve is one batched triangular solve;
- the sums over the shells of an ion go through ``devutil.index_add``:
  several shells share an ion, and an indexed ``+=`` would keep only one
  of them.

frac_heating follows Kozma & Fransson equation 3 including the E < SF_EMIN
term (nonthermal.cc:1060-1095, on the reference's 10x-refined sub-grid),
with cross sections at shifted energies interpolated from the grid tables.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..constants import CLIGHT, EULERGAMMA, EV, H, ME, PI, QE
from ..devutil import index_add

A_NAUGHT_SQUARED = 2.800285203e-17  # Bohr radius squared [cm^2]
H_IONPOT = 13.5979996 * EV
MINIONFRACTION = 1.0e-8  # ions below this share are left out (nonthermal.cc:2496)


@dataclasses.dataclass(frozen=True)
class NonthermalData:
    """The impact-ionisation shells (collion.txt rows matched to the atom's
    ions, plus synthesised Lotz rows for ions without data) and the
    level-capped excitation transitions, as tensors on the run's device
    (floats in float64)."""

    shell_ion: torch.Tensor  # (nshells,) ion index
    shell_ionpot_ev: torch.Tensor  # (nshells,)
    shell_J_ev: torch.Tensor  # (nshells,) Opal+1971 secondary-spectrum J [eV]
    shell_xs: torch.Tensor  # (nshells, S) Younger / Lotz cross sections [cm^2]
    shell_prob_auger: torch.Tensor  # (nshells, nt_max_auger + 1)
    shell_en_auger_ev: torch.Tensor  # (nshells,)
    shell_valence_ionpot_ev: torch.Tensor  # (nshells,) first shell of the ion
    shell_is_top_ion: torch.Tensor  # (nshells,) bool: the ion has no higher stage
    exc_lower: torch.Tensor  # (nexc,) lower level
    exc_upper: torch.Tensor  # (nexc,) upper level
    exc_ion: torch.Tensor  # (nexc,)
    exc_eps_ev: torch.Tensor  # (nexc,) transition energy [eV]
    exc_collstr: torch.Tensor
    exc_osc: torch.Tensor
    exc_forbidden: torch.Tensor
    exc_glower: torch.Tensor
    exc_lineindex: torch.Tensor  # (nexc,) index into the line list
    ion_topion: torch.Tensor  # (nions,) the top ion of each ion's element
    sf_points: int
    sf_emin: float
    sf_emax: float
    nshells: int
    nexc: int
    nt_max_auger: int

    @property
    def delta_e(self) -> float:
        return (self.sf_emax - self.sf_emin) / (self.sf_points - 1)

    def engrid(self):
        """(S,) energy grid [eV], float64."""
        dev = self.shell_xs.device
        return self.sf_emin + torch.arange(self.sf_points, dtype=torch.float64,
                                           device=dev) * self.delta_e


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def ion_topion(ion_element) -> np.ndarray:
    """(nions,) index of the top ion of each ion's element (the ions of an
    element are consecutive; nonthermal.cc:2514 ion < nions - 1)."""
    elem = np.asarray(ion_element)
    n = len(elem)
    top = np.ones(n, bool)
    top[:-1] = elem[:-1] != elem[1:]
    out = np.zeros(n, np.int64)
    nxt = n - 1
    for i in range(n - 1, -1, -1):
        if top[i]:
            nxt = i
        out[i] = nxt
    return out


def read_collion(path: str):
    """Parse collion.txt (reference: nonthermal.cc:598-660 read_collion_data).

    Format: count line, then rows 'Z ionstage n l ionpot_ev A B C D'."""
    rows = []
    with open(path) as f:
        f.readline()
        for line in f:
            parts = line.split()
            if len(parts) < 9:
                continue
            z, ionstage, n, l = int(parts[0]), int(parts[1]), int(parts[2]), int(parts[3])
            ionpot, a, b, c, d = (float(x) for x in parts[4:9])
            rows.append((z, ionstage, n, l, ionpot, a, b, c, d))
    return rows


def approx_shell_occupancies(nbound: int, ioncharge: int) -> np.ndarray:
    """Aufbau-filling shell occupancies K L1 L2 L3 M1 M2 M3 M4 M5 N1
    (reference: nonthermal.cc:474-531 get_approx_shell_occupancies)."""
    caps = [2, 2, 2, 4, 2, 2, 4]
    q = np.zeros(10, np.int64)
    for _ in range(nbound):
        placed = False
        for s, cap in enumerate(caps):
            if q[s] < cap:
                q[s] += 1
                placed = True
                break
        if placed:
            continue
        # the 4s / 3d filling order depends on the ion charge
        # (reference: nonthermal.cc:496-527)
        cap_4s = 2 if ioncharge == 0 else (1 if ioncharge == 1 else 0)
        if q[9] < cap_4s:
            q[9] += 1  # N1 4s
        elif q[7] < 4:
            q[7] += 1  # M4 3d[3/2]
        elif q[8] < 6:
            q[8] += 1  # M5 3d[5/2]
        else:
            raise ValueError("beyond the 4s shell in NT occupancies")
    return q


def read_binding_energies(datadir: str) -> np.ndarray:
    """(n_z, nshells) electron binding energies [eV] from
    ``binding_energies_lotz_tab1and2.txt`` (rows led by Z) or else
    ``binding_energies.txt`` (reference: nonthermal.cc:240-285)."""
    newf = os.path.join(datadir, "binding_energies_lotz_tab1and2.txt")
    oldf = os.path.join(datadir, "binding_energies.txt")
    newformat = os.path.exists(newf)
    path = newf if newformat else oldf
    with open(path) as f:
        lines = [ln for ln in f if ln.strip() and not ln.lstrip().startswith("#")]
    nshells, n_z = (int(x) for x in lines[0].split()[:2])
    out = np.zeros((n_z, nshells))
    for zm1 in range(n_z):
        vals = lines[1 + zm1].split()
        if newformat:
            assert int(vals[0]) == zm1 + 1
            vals = vals[1:]
        out[zm1, :] = [float(v) for v in vals[:nshells]]
    return out


# x-ray-notation shells K L1 L2 L3 M1 M2 M3 -> (n, l, g=2j+1)
_XRAY_NLG = [(1, 0, 2), (2, 0, 2), (2, 1, 2), (2, 1, 4), (3, 0, 2), (3, 1, 2), (3, 1, 4)]


def read_auger_data(path: str, nt_max_auger: int):
    """Parse the fixed-width Kaastra & Mewe 1993 table 2
    (reference: nonthermal.cc:345-470 read_auger_data).

    Returns a list of (Z, ionstage, n, l, g, en_auger_ev,
    prob[nt_max_auger + 1], mean number of Auger electrons)."""
    out = []
    with open(path) as f:
        for line in f:
            if len(line) < 70:
                continue
            try:
                z = int(line[0:2])
                ionstage = int(line[2:5])
                shellnum = int(line[5:8])
                ionpot_ev = float(line[8:15])
                en_auger_total = float(line[15:22])
                epsilon_e3 = int(line[22:25])
            except ValueError:
                continue
            prob = np.zeros(nt_max_auger + 1)
            n_avg = 0.0
            ok = True
            for a in range(9):
                s = line[26 + a * 5: 31 + a * 5]
                try:
                    p = int(s) / 10000.0
                except ValueError:
                    ok = False
                    break
                n_avg += a * p
                prob[min(a, nt_max_auger)] += p
            if not ok or shellnum < 1 or shellnum > len(_XRAY_NLG):
                continue
            en_auger_ev = en_auger_total - (epsilon_e3 / 1000.0 * ionpot_ev)
            if not np.isfinite(en_auger_ev) or en_auger_ev < 0:
                en_auger_ev = 0.0
            n, l, g = _XRAY_NLG[shellnum - 1]
            out.append((z, ionstage, n, l, g, en_auger_ev, prob, n_avg))
    return out


def xs_ionization_lotz(engrid_ev: np.ndarray, ionpot_ev: float, qshell: int) -> np.ndarray:
    """Lotz 1967 ionisation cross section [cm^2], the reference's expression
    with its log10 term (reference: nonthermal.cc:788-822)."""
    en_erg = engrid_ev * EV
    p = ionpot_ev * EV
    beta2 = np.maximum(2.0 * en_erg / ME, 0.0) / CLIGHT**2
    mec2 = ME * CLIGHT**2
    with np.errstate(divide="ignore", invalid="ignore"):
        part = qshell / p * (
            np.log(np.maximum(beta2 * mec2 / 2.0 / p, 1e-300))
            - np.log10(np.maximum(1.0 - beta2, 1e-300))
            - beta2
        )
        aconst = 1.33e-14 * EV * EV
        sigma = 2.0 * aconst / np.maximum(beta2, 1e-300) / mec2 * part
    return np.where((en_erg > p) & (part > 0), sigma, 0.0)


def build_nonthermal_data(ad, dad, datadir: str, sf_points: int = 256, sf_emin: float = 0.1,
                          sf_emax: float = 16000.0, nt_max_auger: int = 2,
                          maxnlevels_lower: int = 5, maxnlevels_upper: int = 250,
                          device=None) -> NonthermalData:
    """The impact-ionisation shell table (collion.txt rows, synthesised
    Lotz rows, Auger probabilities) and the level-capped excitation table,
    on the host, once per run; ``ad`` the host atomic data (its float
    columns in float64), ``dad`` the device one (its index arrays). The
    tensors go to ``device`` (``dad``'s when None)."""
    rows = read_collion(os.path.join(datadir, "collion.txt"))
    ion_elem = _np(dad.ion_element)
    elem_z = np.asarray(ad.elem_z)
    ion_stage = _np(dad.ion_stage)
    ion_ionpot = np.asarray(ad.ion_ionpot, np.float64)  # [erg]
    nions = int(dad.nions_total)
    ion_by_zstage = {(int(elem_z[ion_elem[i]]), int(ion_stage[i])): i for i in range(nions)}

    # shell rows: [ion, n, l, ionpot_ev, A, B, C, D, lotz_q]
    shells = []
    for z, stage, n, l, ionpot, a, b, c, d in rows:
        if (z, stage) not in ion_by_zstage or ionpot < sf_emin:
            continue
        shells.append([ion_by_zstage[(z, stage)], n, l, ionpot, a, b, c, d, 0])

    # Lotz rows for ions without any collion data (nonthermal.cc:640-700)
    binding_ev = read_binding_energies(datadir)
    ions_with_data = {int(s[0]) for s in shells}
    for i in range(nions):
        if i in ions_with_data:
            continue
        z = int(elem_z[ion_elem[i]])
        stage = int(ion_stage[i])
        ioncharge = stage - 1
        nbound = z - ioncharge
        if nbound <= 0 or z > binding_ev.shape[0]:
            continue
        q = approx_shell_occupancies(nbound, ioncharge)
        electron_count = 0
        for shellindex in range(len(q)):
            qs = int(q[shellindex])
            electron_count += qs
            if qs <= 0:
                continue
            enb = binding_ev[z - 1, shellindex] if shellindex < binding_ev.shape[1] else 0.0
            if enb <= 0 and shellindex > 0:
                enb = binding_ev[z - 1, shellindex - 1]
            p_ev = max(ion_ionpot[i] / EV, enb)
            shells.append([i, -1, -shellindex, p_ev, -1.0, -1.0, -1.0, -1.0, qs])
            if electron_count >= nbound:
                break

    # stable sort by (Z, ionstage, ionpot, n, l): the valence shell first
    # in each ion (nonthermal.cc:698-700)
    shells.sort(key=lambda s: (int(elem_z[ion_elem[int(s[0])]]), int(ion_stage[int(s[0])]),
                               s[3], s[1], s[2]))
    nshells = len(shells)
    shell_ion = np.array([int(s[0]) for s in shells], np.int64)
    shell_ionpot_ev = np.array([s[3] for s in shells], np.float64)

    # secondary-electron spectrum parameter J per shell: Opal et al. 1971
    # for neutral He / Ne / Ar, else 0.6 ionpot (nonthermal.cc:882-905)
    opal_j = {2: 15.8, 10: 24.2, 18: 10.0}
    shell_J_ev = np.empty(nshells)
    for k in range(nshells):
        z = int(elem_z[ion_elem[shell_ion[k]]])
        stage = int(ion_stage[shell_ion[k]])
        shell_J_ev[k] = opal_j[z] if stage == 1 and z in opal_j else 0.6 * shell_ionpot_ev[k]

    # valence (lowest) ionpot per ion: the first row of each ion
    valence = shell_ionpot_ev.copy()
    for k in range(1, nshells):
        if shell_ion[k] == shell_ion[k - 1]:
            valence[k] = valence[k - 1]

    # Auger probabilities per shell, g-weighted over the matching x-ray
    # shells (nonthermal.cc:345-470)
    prob_auger = np.zeros((max(nshells, 1), nt_max_auger + 1))
    prob_auger[:, 0] = 1.0
    en_auger_ev = np.zeros(max(nshells, 1))
    auger_g_acc = np.zeros(max(nshells, 1))
    auger_path = os.path.join(datadir, "auger-km1993-table2.txt")
    if nt_max_auger > 0 and os.path.exists(auger_path):
        for z, stage, n, l, g, en_a, prob, _n_avg in read_auger_data(auger_path, nt_max_auger):
            if (z, stage) not in ion_by_zstage:
                continue
            for k in range(nshells):
                s = shells[k]
                if (int(elem_z[ion_elem[shell_ion[k]]]) == z
                        and int(ion_stage[shell_ion[k]]) == stage and s[1] == n and s[2] == l):
                    oldw = auger_g_acc[k] / (g + auger_g_acc[k])
                    neww = g / (g + auger_g_acc[k])
                    auger_g_acc[k] += g
                    en_auger_ev[k] = oldw * en_auger_ev[k] + neww * en_a
                    prob_auger[k] = oldw * prob_auger[k] + neww * prob
    if nshells == 0:
        prob_auger = np.zeros((0, nt_max_auger + 1))
        en_auger_ev = np.zeros(0)

    # (nshells, S) cross sections: the Younger 1981 fit for A >= 0 rows,
    # Lotz for A < 0 rows (nonthermal.cc:955-973)
    de = (sf_emax - sf_emin) / (sf_points - 1)
    engrid_ev = sf_emin + np.arange(sf_points) * de
    shell_xs = np.zeros((nshells, sf_points))
    for k, s in enumerate(shells):
        _, n, l, ionpot, a, b, c, d, qs = s
        if a < 0:
            shell_xs[k] = xs_ionization_lotz(engrid_ev, ionpot, int(qs))
        else:
            u = engrid_ev / ionpot
            with np.errstate(divide="ignore", invalid="ignore"):
                xs = 1e-14 * (a * (1 - 1 / u) + b * (1 - 1 / u) ** 2
                              + c * np.log(u) + d * np.log(u) / u) / (u * ionpot**2)
            shell_xs[k] = np.where(u > 1.0, np.maximum(xs, 0.0), 0.0)

    # the top ion of each element is not ionised further (nonthermal.cc:2514)
    topion = ion_topion(ion_elem)
    is_top_ion = topion == np.arange(nions)
    shell_is_top = is_top_ion[shell_ion] if nshells else np.zeros(0, bool)

    # excitation transitions: the up entries of the transition list, capped
    # at NTEXCITATION_MAXNLEVELS_LOWER / _UPPER levels within the ion
    # (nonthermal.cc:1785-1806)
    is_up = ~_np(dad.trans_is_down).astype(bool)
    owner = _np(dad.trans_owner)[is_up]
    target_inion = _np(dad.trans_target)[is_up]
    lineindex = _np(dad.trans_lineindex)[is_up]
    level_ion = _np(dad.level_ion)
    ion_level_start = _np(dad.ion_level_start)
    level_energy = np.asarray(ad.level_energy, np.float64)
    target = ion_level_start[level_ion[owner]] + target_inion
    lower_inion = owner - ion_level_start[level_ion[owner]]
    eps_ev = (level_energy[target] - level_energy[owner]) / EV
    coll_str = np.asarray(ad.trans_coll_str, np.float64)[is_up]
    forbidden = np.asarray(ad.trans_forbidden)[is_up].astype(bool)
    osc = np.asarray(ad.trans_osc_strength, np.float64)[is_up]
    keep = ((eps_ev >= sf_emin) & (lower_inion < maxnlevels_lower)
            & (target_inion < maxnlevels_upper))
    lower = owner[keep]
    dev = dad.ion_element.device if device is None else torch.device(device)

    def t(x, dtype=torch.float64):
        return torch.as_tensor(np.asarray(x)).to(device=dev, dtype=dtype)

    return NonthermalData(
        shell_ion=t(shell_ion, torch.int64), shell_ionpot_ev=t(shell_ionpot_ev),
        shell_J_ev=t(shell_J_ev), shell_xs=t(shell_xs), shell_prob_auger=t(prob_auger),
        shell_en_auger_ev=t(en_auger_ev), shell_valence_ionpot_ev=t(valence),
        shell_is_top_ion=t(shell_is_top, torch.bool),
        exc_lower=t(lower, torch.int64), exc_upper=t(target[keep], torch.int64),
        exc_ion=t(level_ion[lower], torch.int64), exc_eps_ev=t(eps_ev[keep]),
        exc_collstr=t(coll_str[keep]), exc_osc=t(osc[keep]),
        exc_forbidden=t(forbidden[keep], torch.bool),
        exc_glower=t(np.asarray(ad.level_g, np.float64)[lower]),
        exc_lineindex=t(lineindex[keep], torch.int64), ion_topion=t(topion, torch.int64),
        sf_points=sf_points, sf_emin=sf_emin, sf_emax=sf_emax, nshells=nshells,
        nexc=int(keep.sum()), nt_max_auger=nt_max_auger)


def wf_oneoverw_factor(ad, dad, datadir: str) -> np.ndarray:
    """(nions,) work-function 1/W prefactor [1/erg]; divide by the cell's
    mass-weighted mean atomic number Zbar for the reference's 1/W
    (nonthermal.cc:566-597 get_sum_q_over_binding_energy, 1136-1156
    get_oneoverw). The rate of the work-function approximation (NT_ON
    without NT_SOLVE_SPENCERFANO) and the per-ion fallback when the
    Spencer-Fano rate is not positive (nonthermal.cc:2246-2269)."""
    binding_ev = read_binding_energies(datadir)
    elem_z = np.asarray(ad.elem_z)
    ion_elem = _np(dad.ion_element)
    ion_stage = _np(dad.ion_stage)
    ion_ionpot = np.asarray(ad.ion_ionpot, np.float64)  # [erg]
    nions = int(dad.nions_total)
    sum_q_over_binding = np.zeros(nions)  # [1/erg]
    for i in range(nions):
        z = int(elem_z[ion_elem[i]])
        ioncharge = int(ion_stage[i]) - 1
        nbound = z - ioncharge
        if nbound <= 0 or z > binding_ev.shape[0]:
            continue
        q = approx_shell_occupancies(nbound, ioncharge)
        total = 0.0
        for shellindex in range(len(q)):
            qs = int(q[shellindex])
            if qs <= 0:
                continue
            enb_ev = binding_ev[z - 1, shellindex] if shellindex < binding_ev.shape[1] else 0.0
            if enb_ev <= 0 and shellindex > 0:
                enb_ev = binding_ev[z - 1, shellindex - 1]
            total += qs / max(float(ion_ionpot[i]), enb_ev * EV)
        sum_q_over_binding[i] = total
    aconst = 1.33e-14 * EV * EV
    return aconst * sum_q_over_binding / (2.0 * PI * QE**4)


def electron_loss_rate_ev(energy_ev, nne):
    """Electron energy-loss rate / EV (reference: nonthermal.cc:933-948)."""
    energy = energy_ev * EV
    omegap = torch.sqrt(4 * PI * nne * QE**2 / ME)
    zetae = H * omegap / 2 / PI
    highe = 2 * PI * QE**4 / energy * torch.log(2 * energy / zetae)
    v = torch.sqrt(2 * energy / ME)
    lowe = 2 * PI * QE**4 / energy * torch.log(ME * v**3 / (EULERGAMMA * QE**2 * omegap))
    return nne * torch.where(energy > 14 * EV, highe, lowe) / EV


def xs_impactionization(engrid_ev, ionpot_ev, a, b, c, d):
    """Younger 1981 fit (reference: nonthermal.cc:955-973)."""
    u = engrid_ev / ionpot_ev
    safe_u = torch.clamp(u, min=1.0 + 1e-10)
    xs = 1e-14 * (a * (1 - 1 / safe_u) + b * (1 - 1 / safe_u) ** 2
                  + c * torch.log(safe_u) + d * torch.log(safe_u) / safe_u) / (
        safe_u * ionpot_ev**2)
    return torch.where(u > 1.0, torch.clamp(xs, min=0.0), torch.zeros_like(xs))


def _psecondary(e_p_ev, eps_ev, ionpot_ev, j_ev):
    """Secondary-electron energy distribution (nonthermal.cc:867-879)."""
    e_s = eps_ev - ionpot_ev
    val = 1.0 / (j_ev * torch.arctan(torch.clamp(e_p_ev - ionpot_ev, min=0.0) / 2.0 / j_ev)
                 * (1.0 + (e_s / j_ev) ** 2))
    return torch.where((e_p_ev > ionpot_ev) & (e_s >= 0.0), val, torch.zeros_like(val))


def _get_y(y, emin, de, q):
    """Per-cell degradation spectra at energies ``q`` [eV] (reference
    get_y, nonthermal.cc:761-780): y[:, 0] below the grid, 0 at and above
    its last point. y (ncells, S), q any shape -> (ncells,) + q.shape."""
    S = y.shape[1]
    idxf = (q - emin) / de
    i0 = torch.clamp(torch.floor(idxf).long(), 0, S - 2)
    frac = (idxf - i0).to(y.dtype)
    val = y[:, i0] * (1.0 - frac) + y[:, i0 + 1] * frac
    y0 = y[:, 0].reshape((y.shape[0],) + (1,) * q.dim())
    zero = torch.zeros((), dtype=y.dtype, device=y.device)
    val = torch.where(idxf < 0, y0, val)
    val = torch.where(idxf >= S - 1, zero, val)
    return torch.where(q <= 0, zero, val)


def _interp_rows(tab, emin, de, q):
    """Row r of ``tab`` (R, S) linearly interpolated at q[..., r] [eV],
    flat beyond the grid (the shifts involved are below SF_EMIN)."""
    R, S = tab.shape
    idxf = (q - emin) / de
    i0 = torch.clamp(torch.floor(idxf).long(), 0, S - 2)
    frac = torch.clamp(idxf - i0, 0.0, 1.0).to(tab.dtype)
    r = torch.arange(R, device=tab.device)
    return tab[r, i0] * (1.0 - frac) + tab[r, i0 + 1] * frac


def xs_excitation_batch(ntd: NonthermalData):
    """(nexc, S) excitation cross sections (reference: nonthermal.cc:1355-1408):
    coll_str >= 0, Li+2012 eq. 11; permitted dipole, Mewe 1972 van
    Regemorter with g_bar = 0.28 ln U + 0.15; forbidden without coll_str,
    zero."""
    en = ntd.engrid()[None, :]
    eps = ntd.exc_eps_ev[:, None]
    above = en >= eps
    cs = (H_IONPOT / (en * EV)) ** 2 / ntd.exc_glower[:, None] \
        * ntd.exc_collstr[:, None] * PI * A_NAUGHT_SQUARED
    prefactor = 45.585750051  # 8 pi^2 / sqrt(3)
    constantfactor = eps * prefactor * A_NAUGHT_SQUARED \
        * (H_IONPOT / (eps * EV)) ** 2 * ntd.exc_osc[:, None]
    g_bar = 0.28 * torch.log(torch.clamp(en / eps, min=1.0)) + 0.15
    mewe = constantfactor * g_bar / en
    zero = torch.zeros((), dtype=en.dtype, device=en.device)
    xs = torch.where(ntd.exc_collstr[:, None] >= 0, cs,
                     torch.where(~ntd.exc_forbidden[:, None], torch.clamp(mewe, min=0.0), zero))
    return torch.where(above, xs, zero)


def _source_rhs(ntd: NonthermalData):
    """The injection source spread over the top ~3.3 % of the grid
    (nonthermal.cc:108-139): (its mean energy E_init [eV], the right-hand
    side of the SF system, the integral of the source above each point)."""
    S, de = ntd.sf_points, float(ntd.delta_e)
    spread_pts = int(S * 0.03333) + 1
    src = np.zeros(S)
    src[S - spread_pts:] = 1.0 / (spread_pts * de)
    e_init_ev = float(np.sum(src * de * np.asarray(ntd.sf_emin + np.arange(S) * ntd.delta_e)))
    rhs = np.zeros(S)
    acc = 0.0
    for i in range(S - 1, -1, -1):
        rhs[i] = acc * de
        acc += src[i]
    return e_init_ev, rhs


def _shell_terms(ntd: NonthermalData, en, sf_auger_contribution_on: bool):
    """(nshells, S, S) ionisation term of each shell per unit ion
    population (nonthermal.cc:1835-1940): row i (energy E), column j
    (primary energy E'); upper-triangular."""
    de = ntd.delta_e
    ionpot = ntd.shell_ionpot_ev[:, None, None]
    jconst = ntd.shell_J_ev[:, None, None]
    xs = ntd.shell_xs[:, None, :]  # (k, 1, S) at E' = en[j]
    e_i = en[None, :, None]
    e_j = en[None, None, :]
    eps_upper = torch.minimum((e_j + ionpot) / 2, e_j)
    upper_j = torch.arctan((eps_upper - ionpot) / jconst)
    pref = xs / torch.clamp(torch.arctan((e_j - ionpot) / 2 / jconst), min=1e-300)
    zero = torch.zeros((), dtype=en.dtype, device=en.device)
    # first integral: epsilon_lower = max(E' - E, I)
    int_low1 = torch.arctan((torch.maximum(e_j - e_i, ionpot) - ionpot) / jconst)
    t1 = torch.where((e_j >= e_i) & (int_low1 <= upper_j) & (xs > 0),
                     pref * (upper_j - int_low1) * de, zero)
    # second integral: epsilon_lower = E + I -> atan(E / J), for E' >= 2E + I
    int_low2 = torch.arctan(e_i / jconst)
    t2 = torch.where((e_j >= 2 * e_i + ionpot) & (int_low2 <= upper_j) & (xs > 0),
                     pref * (upper_j - int_low2) * de, zero)
    terms = t1 - t2
    if sf_auger_contribution_on and ntd.nt_max_auger > 0:
        # Auger energy sink: rows below the mean Auger-electron energy lose
        # the electrons that Auger emission promotes (nonthermal.cc:1905-1940,
        # SF_AUGER_CONTRIBUTION_ON without DISTRIBUTE_EN)
        en_aug = ntd.shell_en_auger_ev[:, None, None]
        terms = terms - torch.where((e_i < en_aug) & (e_j >= e_i) & (xs > 0), xs, zero)
    return terms


def solve_spencerfano_cells(ntd: NonthermalData, dad, levelpops, nnion_cells, nne,
                            sf_auger_contribution_on: bool = True,
                            nt_use_valence_ionpotential: bool = False):
    """Solve the Spencer-Fano equation in every cell, in float64.

    levelpops (ncells, nlevels), nnion_cells (ncells, nions), nne (ncells,).
    Returns a dict: y (ncells, S) the degradation spectrum; frac_heating,
    frac_ionization, frac_excitation (ncells,); frac_ion_by_ion and
    eff_ionpot [erg] (ncells, nions); prob_num_auger and
    ionenfrac_num_auger (ncells, nions, nt_max_auger + 1); and
    exc_ratecoeff_perdep (ncells, nexc) [excitations per deposited erg per
    lower-level ion]."""
    f64 = torch.float64
    levelpops, nnion_cells, nne = levelpops.to(f64), nnion_cells.to(f64), nne.to(f64)
    dev = nne.device
    S = ntd.sf_points
    de = ntd.delta_e
    en = ntd.engrid()
    ncells = nne.shape[0]
    nions = int(dad.nions_total)
    zero = torch.zeros((), dtype=f64, device=dev)
    nniontot = torch.clamp(nnion_cells.sum(dim=1), min=1e-300)
    e_init_ev, rhs_np = _source_rhs(ntd)
    rhs = torch.as_tensor(rhs_np, dtype=f64, device=dev)

    # loss term (the diagonal)
    loss = electron_loss_rate_ev(en[None, :], nne[:, None])  # (ncells, S)
    ion_included = nnion_cells >= MINIONFRACTION * nniontot[:, None]

    # excitation: the banded contraction; m_exc[c, i, j] = cmat[c, j, j - i]
    # for j >= i
    xs_exc = xs_excitation_batch(ntd)  # (nexc, S)
    nnlower = torch.where(ion_included[:, ntd.exc_ion], levelpops[:, ntd.exc_lower], zero)
    widths = ntd.exc_eps_ev / de
    dgrid = torch.arange(S, dtype=f64, device=dev)
    wmat = torch.clamp(widths[:, None] - dgrid[None, :], 0.0, 1.0)  # (nexc, S)
    bmat = nnlower[:, :, None] * xs_exc[None, :, :] * de  # (ncells, nexc, S)
    cmat = torch.einsum("ctj,td->cjd", bmat, wmat)  # (ncells, S, S)
    del bmat
    ii = torch.arange(S, device=dev)
    upper = ii[None, :] >= ii[:, None]  # (i, j): j >= i
    dmap = torch.clamp(ii[None, :] - ii[:, None], 0, S - 1)
    jidx = ii[None, :].expand(S, S)
    sfmat = torch.where(upper[None], cmat[:, jidx, dmap], zero)
    del cmat

    # ionisation shells, weighted by their ion's population where the ion
    # is included and not its element's top ion
    if ntd.nshells > 0:
        include = ion_included[:, ntd.shell_ion] & ~ntd.shell_is_top_ion[None, :]
        nnion_s = torch.where(include, nnion_cells[:, ntd.shell_ion], zero)  # (ncells, nsh)
        terms = _shell_terms(ntd, en, sf_auger_contribution_on)
        sfmat = sfmat + (nnion_s @ terms.reshape(ntd.nshells, S * S)).reshape(ncells, S, S)
        del terms
    sfmat = sfmat + torch.diag_embed(loss)
    y = torch.linalg.solve_triangular(sfmat, rhs[None, :, None].expand(ncells, S, 1),
                                      upper=True)[:, :, 0]
    del sfmat

    # analysis (nonthermal.cc:1060-1330)
    naug = ntd.nt_max_auger + 1
    topion = ntd.ion_topion
    ion_idx = torch.arange(nions, device=dev)
    top_mask = topion == ion_idx
    base = torch.zeros(naug, dtype=f64, device=dev)
    base[0] = 1.0
    if ntd.nshells > 0:
        ydotxs = (y @ ntd.shell_xs.T) * de  # (ncells, nshells)
        nnion_sh = nnion_cells[:, ntd.shell_ion]
        frac_sh = nnion_sh * ntd.shell_ionpot_ev[None, :] * ydotxs / e_init_ev
        # eta / ionpot with the valence potential under
        # NT_USE_VALENCE_IONPOTENTIAL (nonthermal.cc:1265-1270)
        pot = ntd.shell_valence_ionpot_ev if nt_use_valence_ionpotential else ntd.shell_ionpot_ev
        eta_over_pot_sh = frac_sh / (pot[None, :] * EV)
        zc = torch.zeros((ncells, nions), dtype=f64, device=dev)
        eta_sum = index_add(zc, 1, ntd.shell_ion, frac_sh)
        eta_over_pot = index_add(zc, 1, ntd.shell_ion, eta_over_pot_sh)
        x_ion = nnion_cells / nniontot[:, None]
        eff_ionpot = torch.where(eta_over_pot > 0,
                                 x_ion / torch.clamp(eta_over_pot, min=1e-300), zero)
        frac_ion_by_ion = torch.where(top_mask[None, :], zero, eta_sum)
        frac_ionization = frac_ion_by_ion.sum(dim=1)

        # per-ion Auger upper-ion probabilities, eta-over-ionpot weighted
        # over the shells (nonthermal.cc:1245-1315); the energy-weighted
        # variant uses the eta weights
        pa = ntd.shell_prob_auger
        za = torch.zeros((ncells, nions, naug), dtype=f64, device=dev)
        num_prob = index_add(za, 1, ntd.shell_ion, eta_over_pot_sh[:, :, None] * pa[None])
        num_enfrac = index_add(za, 1, ntd.shell_ion, frac_sh[:, :, None] * pa[None])
        prob_num_auger = num_prob / torch.clamp(eta_over_pot, min=1e-300)[:, :, None]
        ionenfrac_num_auger = num_enfrac / torch.clamp(eta_sum, min=1e-300)[:, :, None]

        # fold the probabilities beyond the element's top ion into the
        # highest reachable stage (nonthermal.cc:1288-1307)
        amax = topion - ion_idx - 1  # (nions,) most Auger electrons
        a_arange = torch.arange(naug, device=dev)
        overflow = (a_arange[None, :] > amax[:, None])[None]  # (1, nions, naug)
        onehot = (a_arange[None, :] == torch.clamp(amax, 0, naug - 1)[:, None]).to(f64)[None]
        over_prob = torch.where(overflow, prob_num_auger, zero).sum(dim=2, keepdim=True)
        over_enfrac = torch.where(overflow, ionenfrac_num_auger, zero).sum(dim=2, keepdim=True)
        prob_num_auger = torch.where(overflow, zero, prob_num_auger) + onehot * over_prob
        ionenfrac_num_auger = (torch.where(overflow, zero, ionenfrac_num_auger)
                               + onehot * over_enfrac)
        # ions without shell data: single ionisation only
        no_shells = (eta_over_pot <= 0)[:, :, None]
        prob_num_auger = torch.where(no_shells, base, prob_num_auger)
        ionenfrac_num_auger = torch.where(no_shells, base, ionenfrac_num_auger)
    else:
        frac_ion_by_ion = torch.zeros((ncells, nions), dtype=f64, device=dev)
        eff_ionpot = torch.zeros_like(frac_ion_by_ion)
        frac_ionization = torch.zeros(ncells, dtype=f64, device=dev)
        prob_num_auger = base.expand(ncells, nions, naug).clone()
        ionenfrac_num_auger = prob_num_auger.clone()

    # excitation fraction: sum_t n_t eps_t integral(xs_t y) / E_init, and
    # the per-transition rate coefficient per deposited energy
    # [excitations cm^3 / erg] (nonthermal.cc:1412-1428, 2272-2297)
    ydotxs_exc = (y @ xs_exc.T) * de  # (ncells, nexc)
    frac_excitation = (nnlower * ntd.exc_eps_ev[None, :] * ydotxs_exc).sum(dim=1) / e_init_ev
    exc_ratecoeff_perdep = ydotxs_exc / e_init_ev / EV

    # frac_heating: Kozma & Fransson eq 3 (nonthermal.cc:1060-1095): the
    # integral of y L over the grid, the SF_EMIN y L term, and the energy
    # of the electrons degrading below SF_EMIN (K&F eq 6,
    # nonthermal.cc:978-1056) on the 10x-refined sub-grid
    emin, emax = float(ntd.sf_emin), float(ntd.sf_emax)
    fh = (y * loss).sum(dim=1) * de + emin * y[:, 0] * loss[:, 0]
    nsteps = (int(emin / de) + 1) * 10
    delta_sub = emin / nsteps
    jgrid = torch.arange(S, device=dev)
    nnion_ne = torch.where(ion_included, nnion_cells, zero)
    fh3 = torch.zeros(ncells, dtype=f64, device=dev)
    for e_sub in np.arange(1, nsteps) * delta_sub:
        e_sub = float(e_sub)
        # excitation: sum_t nnlevel_t y(E + eps_t) xs_t(E + eps_t)
        q_exc = e_sub + ntd.exc_eps_ev
        y_exc = _get_y(y, emin, de, q_exc)
        xs_at = _interp_rows(xs_exc, emin, de, q_exc)
        ne_c = (nnlower * y_exc * xs_at[None, :]).sum(dim=1)
        if ntd.nshells > 0:
            ipot, jc = ntd.shell_ionpot_ev, ntd.shell_J_ev
            # secondaries of energy E' in [I, lambda]: y(E + E') xs(E + E') P
            q1 = e_sub + en
            y1 = _get_y(y, emin, de, q1)
            xs1 = _interp_rows(ntd.shell_xs, emin, de, q1[:, None].expand(S, ntd.nshells))
            p1 = _psecondary(q1[:, None], en[:, None], ipot[None, :], jc[None, :])
            lam = torch.clamp(e_sub + ipot, max=emax - e_sub)
            istart = torch.clamp(((ipot - emin) / de).to(torch.int32), 0, S - 1)
            istop = torch.clamp(((lam - emin) / de).to(torch.int32), 0, S - 1)
            mask1 = (jgrid[:, None] >= istart[None, :]) & (jgrid[:, None] <= istop[None, :])
            c1 = y1 @ (torch.where(mask1, xs1 * p1, zero) * de)
            # primaries E' in [2E + I, Emax]: y(E') xs(E') P(E', E + I)
            p2 = _psecondary(en[:, None], e_sub + ipot[None, :], ipot[None, :], jc[None, :])
            istart2 = torch.clamp(((2 * e_sub + ipot - emin) / de).to(torch.int32), 0, S - 1)
            mask2 = jgrid[:, None] >= istart2[None, :]
            c2 = y @ (torch.where(mask2, ntd.shell_xs.T * p2, zero) * de)
            ne_c = ne_c + (nnion_ne[:, ntd.shell_ion] * (c1 + c2)).sum(dim=1)
        fh3 = fh3 + ne_c * e_sub * delta_sub
    frac_heating = (fh + fh3) / e_init_ev
    # invalid results fall back to 1.0, as the reference does
    frac_heating = torch.where(torch.isfinite(frac_heating) & (frac_heating >= 0.0)
                               & (frac_heating <= 1.0), frac_heating, zero + 1.0)
    return dict(y=y, frac_heating=frac_heating,
                frac_ionization=torch.clamp(frac_ionization, 0.0, 1.0),
                frac_excitation=torch.clamp(frac_excitation, 0.0, 1.0),
                frac_ion_by_ion=frac_ion_by_ion, eff_ionpot=eff_ionpot,
                prob_num_auger=prob_num_auger, ionenfrac_num_auger=ionenfrac_num_auger,
                exc_ratecoeff_perdep=exc_ratecoeff_perdep)


def nt_ionization_ratecoeff(dep_rate_density, nniontot, eff_ionpot):
    """Gamma_NT per ion [1/s] (reference: nonthermal.cc:1340-1349)."""
    return torch.where(
        (eff_ionpot > 0) & (dep_rate_density[:, None] > 0),
        dep_rate_density[:, None] / torch.clamp(nniontot, min=1e-300)[:, None]
        / torch.clamp(eff_ionpot, min=1e-300),
        torch.zeros((), dtype=eff_ionpot.dtype, device=eff_ionpot.device))
