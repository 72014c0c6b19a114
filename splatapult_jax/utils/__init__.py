from splatapult_jax.utils.image import save_png, load_png, composite_to_rgb
from splatapult_jax.utils.overlay import camera_overlay_lines, draw_lines

__all__ = ["save_png", "load_png", "composite_to_rgb", "camera_overlay_lines", "draw_lines"]
