"""Assigned architecture config: gemma3-1b (see registry.py)."""
from .registry import get_config

CONFIG = get_config("gemma3-1b")
SMOKE = get_config("gemma3-1b-smoke")
