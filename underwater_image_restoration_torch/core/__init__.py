"""Typed configuration of the port's trainer and CLI."""
from .config import Config, compute_dtype_of, from_namespace, validate

__all__ = ["Config", "compute_dtype_of", "from_namespace", "validate"]
