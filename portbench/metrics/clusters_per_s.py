"""Clusters whose arrays reached host memory, over the whole window."""

from portbench.yardstick.stats import units_per_s


def read(ctx):
    return units_per_s(ctx, "clusters")
