"""Assigned architecture config: musicgen-large (see registry.py)."""
from .registry import get_config

CONFIG = get_config("musicgen-large")
SMOKE = get_config("musicgen-large-smoke")
