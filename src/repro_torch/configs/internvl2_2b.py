"""Assigned architecture config: internvl2-2b (see registry.py)."""
from .registry import get_config

CONFIG = get_config("internvl2-2b")
SMOKE = get_config("internvl2-2b-smoke")
