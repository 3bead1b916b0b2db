"""Cluster models from (M200, c), a whole batch of halos at once."""

from __future__ import annotations

import torch

from ..core.grid import log_radius_grid
from ..model.builders import build_from_dens_and_tden
from ..profiles.library import (snfw_density_profile, snfw_mass_profile,
                                snfw_total_mass, vikhlinin_density_profile)
from ..profiles.relations import f_gas
from ..profiles.solvers import (find_overdensity_radius, find_radius_mass,
                                mass_within)
from ..virial import compute_df

__all__ = ["build_one_cluster"]


def build_one_cluster(M200, conc, z=0.1, f_g=None, rmin=0.1, rmax=10000.0,
                      num_points=1000, with_df: bool = True,
                      gravity: str = "newtonian"):
    """The canonical cluster from (M200, c): sNFW total profile,
    Vikhlinin gas rescaled to f_gas(M500) M500, 2% stars.

    ``M200``/``conc``: float64 tensors of one batch shape (H,) — every halo
    is built at once and every field comes back as (H, num_points).
    ``with_df`` adds the dark-matter DF ``dm_df`` (radial ordering).
    """
    r200 = find_overdensity_radius(M200, 200.0, z=z)
    a = r200 / conc
    M = snfw_total_mass(M200, r200, a)
    rhot = snfw_density_profile(M, a)
    Mt = snfw_mass_profile(M, a)
    r500, M500 = find_radius_mass(Mt, z=z, delta=500.0, like=M200)
    if f_g is None:
        f_g = f_gas(M500)
    rhog = vikhlinin_density_profile(1.0, 100.0, r200, 1.0, 0.67, 3)
    rhog = (f_g * M500 / mass_within(rhog, r500)) * rhog
    rhos = 0.02 * rhot

    rr = log_radius_grid(rmin, rmax, num_points, device=M200.device)
    rr = rr.expand(M200.shape + rr.shape).contiguous()
    fields = build_from_dens_and_tden(rr, rhog, rhot, stellar_density=rhos,
                                      gravity=gravity)
    if with_df:
        ee = -torch.flip(fields["gravitational_potential"], (-1,))
        pden = torch.flip(fields["dark_matter_density"], (-1,))
        fields["dm_df"] = torch.flip(compute_df(ee, pden), (-1,))
    return fields
