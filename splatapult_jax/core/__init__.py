from splatapult_jax.core import transforms, sh, project

__all__ = ["transforms", "sh", "project"]
