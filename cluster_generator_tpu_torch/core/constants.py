"""Physical constants in galactic units (kpc, Msun, Myr, K).

The same SI anchors and derived values as
``cluster_generator_tpu.core.constants``: every field tensor of the port is
a plain float64 in galactic units, so both packages must agree on these
numbers to the last bit.
"""

from __future__ import annotations

import math

# ---------------------------------------------------------------- SI anchors
G_SI = 6.67430e-11  # m^3 kg^-1 s^-2
MP_SI = 1.67262192369e-27  # kg (proton mass)
KBOLTZ_SI = 1.380649e-23  # J / K (exact)
KEV_SI = 1.602176634e-16  # J   (exact; 1 keV)
C_SI = 2.99792458e8  # m / s (exact)

AU_M = 1.495978707e11  # m, exact
PC_M = 648000.0 / math.pi * AU_M  # parsec in meters
KPC_M = 1.0e3 * PC_M
CM_PER_KPC = KPC_M * 100.0
YR_S = 365.25 * 86400.0  # Julian year in seconds
MYR_S = 1.0e6 * YR_S
MSUN_KG = 1.98892e30  # kg — the historical yt/unyt solar mass

# ------------------------------------------------------------ galactic units
#: Newton's constant in kpc^3 / (Msun Myr^2)
G = G_SI * MSUN_KG * MYR_S**2 / KPC_M**3

#: proton mass in Msun
mp = MP_SI / MSUN_KG

#: Boltzmann constant in Msun kpc^2 / (Myr^2 K)
kboltz = KBOLTZ_SI * MYR_S**2 / (MSUN_KG * KPC_M**2)

#: 1 kpc in cm
kpc_to_cm = CM_PER_KPC

#: 1 keV in galactic energy units (Msun kpc^2 / Myr^2)
keV = KEV_SI * MYR_S**2 / (MSUN_KG * KPC_M**2)

#: 1 km/s in kpc/Myr
km_s = 1.0e3 * MYR_S / KPC_M

# ------------------------------------------------------- plasma composition
#: primordial hydrogen abundance
X_H = 0.76

#: mean molecular weight
mu = 1.0 / (2.0 * X_H + 0.75 * (1.0 - X_H))

#: mean molecular weight per electron
mue = 1.0 / (X_H + 0.5 * (1.0 - X_H))
