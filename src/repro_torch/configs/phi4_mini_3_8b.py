"""Assigned architecture config: phi4-mini-3.8b (see registry.py)."""
from .registry import get_config

CONFIG = get_config("phi4-mini-3.8b")
SMOKE = get_config("phi4-mini-3.8b-smoke")
