"""Image decode and synthetic pairs for the port's serving path."""
from .synthetic import synthetic_pair_batch
from .uieb import decode_image

__all__ = ["decode_image", "synthetic_pair_batch"]
