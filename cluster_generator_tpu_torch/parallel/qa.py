"""Tolerances of the physics QA on drawn particles.

The same table as ``cluster_generator_tpu.parallel.qa``:

* ``speed_tol``: collisionless speeds against the LOCAL escape speed
  sqrt(2 psi(r)).  The draws use float32 node-lerped joint tables with a
  Bernoulli row pick, which can exceed the local v_esc by the inter-node
  difference; 5e-3 covers that with margin.
* ``zero_row_tol``: the share of a species' radii allowed to be exactly 0
  (a float32 uniform hits 0.0 with p ~ 6e-8) before a block counts as
  never written.
* per product: ``energy_rtol`` (gas thermal energy against 1.5 P / rho at
  the particle radius), ``radius_tol`` (overflow past r_max) and
  ``mass_rtol`` (n_part * pmass against the species' grid mass).
"""

from __future__ import annotations

QA_TOLERANCES = {
    # shared (one draw scheme, one rationale)
    "speed_tol": 5e-3,
    "zero_row_tol": 1e-4,
    # per-product method floors
    "cluster": {"energy_rtol": 5e-3, "radius_tol": 1e-6,
                "mass_rtol": 1e-5},
    "merger": {"energy_rtol": 1e-3, "radius_tol": 1e-5,
               "mass_rtol": 1e-4},
}

__all__ = ["QA_TOLERANCES"]
