from splatapult_jax.reference.raster import reference_render

__all__ = ["reference_render"]
