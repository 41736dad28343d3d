"""PROPACEOS EoS/opacity table reader (a copy of the JAX package's
``io/eos.py``, which is numpy only: the port imports nothing of the JAX
package).

Functional rebuild of the reference's parser (src/utils/eos_opacity.py:3-187)
for the fixed-layout PROPACEOS ASCII format: a 38-line header, then
10-values-per-line blocks for the temperature grid [eV], density grid
[cm^-3], radiation energy-group boundaries, and the optional
(T x rho) tables: average ionisation Zbar, Rosseland/emission/absorption
opacities [cm^2/g], internal energies [J/g] and pressures [dyn/cm^2].
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

EV_TO_K = 11604.5221
JOULE_TO_ERG = 1.0e7

_TABLE_KEYS = (
    ("need_zf_table", "zf_table"),
    ("need_ross_opacity", "ross_opacity"),
    ("need_emiss_opacity", "emiss_opacity"),
    ("need_abs_opacity", "abs_opacity"),
    ("need_en_table", "en_table"),
    ("need_eion", "eion_table"),
    ("need_eele", "eele_table"),
    ("need_pion", "pion_table"),
    ("need_pele", "pele_table"),
)


def _read_block(f, count: int) -> np.ndarray:
    """Read ``count // 10`` lines of 10 whitespace-separated floats."""
    vals = []
    for _ in range(count // 10):
        vals.extend(float(x) for x in f.readline().split())
    return np.array(vals)


def read_propaceos(
    file_name: str,
    need_zf_table: bool = False,
    need_en_table: bool = False,
    need_eion: bool = False,
    need_eele: bool = False,
    need_pion: bool = False,
    need_pele: bool = False,
    need_ross_opacity: bool = False,
    need_emiss_opacity: bool = False,
    need_abs_opacity: bool = False,
) -> Dict[str, Optional[np.ndarray]]:
    """Read a PROPACEOS file; table ordering and skip counts follow the
    format as parsed by the reference (eos_opacity.py:49-187)."""
    flags = dict(
        need_zf_table=need_zf_table,
        need_ross_opacity=need_ross_opacity,
        need_emiss_opacity=need_emiss_opacity,
        need_abs_opacity=need_abs_opacity,
        need_en_table=need_en_table,
        need_eion=need_eion,
        need_eele=need_eele,
        need_pion=need_pion,
        need_pele=need_pele,
    )
    data: Dict[str, Optional[np.ndarray]] = {
        "temperatures": None, "densities": None, "rad_groups": None,
        **{key: None for _, key in _TABLE_KEYS},
    }

    with open(file_name, "r") as f:
        for _ in range(38):
            next(f)

        n_temp = int(f.readline().strip())
        if n_temp <= 0:
            raise ValueError("no temperature grid in PROPACEOS file")
        data["temperatures"] = _read_block(f, n_temp)

        n_dens = int(f.readline().strip())
        if n_dens <= 0:
            raise ValueError("no density grid in PROPACEOS file")
        data["densities"] = _read_block(f, n_dens)

        # skip the duplicated opacity grid section
        for _ in range(n_temp // 10 + n_dens // 10 + 2 + 5):
            next(f)

        n_groups = int(f.readline().strip())
        next(f)
        groups = []
        for _ in range(n_groups // 10 + 1):
            groups.extend(float(x) for x in f.readline().split())
        data["rad_groups"] = np.array(groups)

        for flag_name, key in _TABLE_KEYS:
            if not flags[flag_name]:
                continue
            next(f)  # separator line
            table = np.zeros((n_temp, n_dens))
            for t in range(n_temp):
                table[t, :] = _read_block(f, n_dens)
            data[key] = table

    return data
