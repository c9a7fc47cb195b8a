"""Assigned architecture config: recurrentgemma-9b (see registry.py)."""
from .registry import get_config

CONFIG = get_config("recurrentgemma-9b")
SMOKE = get_config("recurrentgemma-9b-smoke")
