"""Assigned architecture config: granite-8b (see registry.py)."""
from .registry import get_config

CONFIG = get_config("granite-8b")
SMOKE = get_config("granite-8b-smoke")
