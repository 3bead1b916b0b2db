"""Package configuration: logging, the numerical knobs that size the
tables, and the MOND acceleration scale.

The same defaults and the same ``CLUSTER_GENERATOR_TPU_CONFIG`` override
file as ``cluster_generator_tpu.core.config``, so both packages build tables
of the same size, under the same gravity constants, from one configuration.
"""

from __future__ import annotations

import copy
import os

__all__ = ["cgparams", "load_config", "defaults"]

defaults: dict = {
    "system": {
        "logging": {
            "main": {
                "enabled": True,
                "format": "%(name)-3s : [%(levelname)-9s] %(asctime)s %(message)s",
                "level": "INFO",
                "stream": "STDERR",
            },
            "developer": {"enabled": False, "output_directory": None},
        },
    },
    "numerical": {
        # inverse speed-CDF tables: speed-grid resolution, quantile
        # resolution, and whether the cumulative/inversion runs in float32
        "velocity_table_speeds": 512,
        "velocity_table_quantiles": 512,
        "velocity_table_float32": True,
        # f(E) node grid of the float32 table build: "body" nodes cover
        # [0, 0.9 e_max), "top" nodes the steep last decade [0.9 e_max, e_max]
        "df_node_grid_body": 4096,
        "df_node_grid_top": 4096,
    },
    # acceleration scale of the MOND laws (model/gravity.py), in m/s^2
    "gravity": {"mond": {"a0_m_s2": 1.2e-10}},
}


def _deep_update(dst: dict, src: dict) -> dict:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_update(dst[k], v)
        else:
            dst[k] = v
    return dst


def load_config(path: str | None = None) -> dict:
    """Config defaults, deep-merged with a safe-YAML override file given
    by ``path`` or ``CLUSTER_GENERATOR_TPU_CONFIG``."""
    cfg = copy.deepcopy(defaults)
    path = path or os.environ.get("CLUSTER_GENERATOR_TPU_CONFIG")
    if path and os.path.exists(path):
        import yaml

        with open(path, "r") as f:
            user = yaml.safe_load(f) or {}
        _deep_update(cfg, user)
    return cfg


cgparams = load_config()
