from splatapult_jax.ops.binning import instance_demand
from splatapult_jax.ops.tiled import composite_tiled

__all__ = ["composite_tiled", "instance_demand"]
