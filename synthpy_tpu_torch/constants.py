"""Physical constants and plasma-physics helper functions (PyTorch).

Port of ``synthpy_tpu.constants``: the same coefficients and formulas, with
``torch`` in place of ``jax.numpy``. Array functions take tensors; the
frequency helpers take and return Python floats. Every function is safe
under ``torch.autograd`` at vacuum (ne = 0) and at and beyond the critical
density, as the JAX package's double-``where`` makes them.
"""

from __future__ import annotations

import math

import torch

# Speed of light in vacuum [m/s] (scipy.constants.c).
C = 2.99792458e8
# Elementary charge [C] (scipy.constants.e).
E_CHARGE = 1.602176634e-19

# n_c = N_C_COEFF * omega^2  [m^-3]; N_C_COEFF = epsilon_0 m_e / e^2.
N_C_COEFF = 3.14207787e-4
# omega_pe = OMEGA_PE_COEFF * sqrt(n_e [cm^-3])  [rad/s].
OMEGA_PE_COEFF = 5.64e4
# v_the = V_THE_COEFF * sqrt(Te [eV])  [m/s].
V_THE_COEFF = 4.19e5
# L_quantum = L_QUANTUM_COEFF / sqrt(Te)  (= hbar / sqrt(m_e e Te)).
L_QUANTUM_COEFF = 2.760428269727312e-10
# kappa = KAPPA_COEFF * Z * c * (ne_cc/omega)^2 * CL * Te^-1.5  [1/s].
KAPPA_COEFF = 3.1e-5
# VerdetConst = VERDET_COEFF * lwl^2  [rad/T/m^2].
VERDET_COEFF = 2.62e-13

# Default probe wavelength [m] used across the reference examples.
DEFAULT_LWL = 1064e-9

# Proton rest mass [kg] and rest energy [MeV] (CODATA 2018): the charged-
# particle radiography of tracer.particles.
M_PROTON = 1.67262192369e-27
PROTON_REST_MEV = 938.27208816


def omega_from_lwl(lwl: float) -> float:
    """Angular laser frequency [rad/s] from vacuum wavelength [m]."""
    return 2.0 * math.pi * C / lwl


def critical_density(omega):
    """Critical electron density n_c [m^-3] for angular frequency omega."""
    return N_C_COEFF * omega**2


def omega_pe(ne_cc: torch.Tensor) -> torch.Tensor:
    """Electron plasma frequency [rad/s]; ``ne_cc`` in cm^-3 (NRL pp. 28)."""
    return OMEGA_PE_COEFF * torch.sqrt(ne_cc)


def v_the(Te: torch.Tensor) -> torch.Tensor:
    """Electron thermal speed [m/s]; ``Te`` in eV."""
    return V_THE_COEFF * torch.sqrt(Te)


def n_refrac(ne: torch.Tensor, omega: float) -> torch.Tensor:
    """Plasma refractive index; ``ne`` in m^-3.

    Clamped to 0 beyond the critical density. The double ``where`` makes
    the overdense branch a true constant, so the gradient there is 0
    and not ``inf * 0``; the ratio is computed linearly in ne, so the
    gradient at ne = 0 is finite too.
    """
    arg = 1.0 - (OMEGA_PE_COEFF**2 * 1e-6 / omega**2) * ne
    pos = arg > 0.0
    safe = torch.where(pos, arg, torch.ones_like(arg))
    return torch.where(pos, torch.sqrt(safe), torch.zeros_like(arg))


def coulomb_log(ne_cc, Te, Z, omega: float) -> torch.Tensor:
    """Coulomb logarithm, floored at 2.0 (reference propagator.py:49-50)."""
    o_max = torch.clamp_min(omega_pe(ne_cc), omega)
    L_classical = Z * E_CHARGE / Te
    L_quantum = L_QUANTUM_COEFF / torch.sqrt(Te)
    L_max = torch.maximum(L_classical, L_quantum)
    return torch.clamp_min(torch.log(v_the(Te) / (o_max * L_max)), 2.0)


def kappa(ne, Te, Z, omega: float) -> torch.Tensor:
    """NRL inverse-bremsstrahlung rate coefficient [1/s].

    ``ne`` in m^-3, ``Te`` in eV, ``Z`` ionisation, ``omega`` rad/s.
    """
    ne_cc = ne * 1e-6
    CL = coulomb_log(ne_cc, Te, Z, omega)
    return KAPPA_COEFF * Z * C * (ne_cc / omega) ** 2 * CL * Te ** (-1.5)


def verdet_constant(lwl: float) -> float:
    """Faraday-rotation Verdet constant [rad/T/m^2] for wavelength ``lwl``."""
    return VERDET_COEFF * lwl**2
