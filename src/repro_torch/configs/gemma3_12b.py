"""Assigned architecture config: gemma3-12b (see registry.py)."""
from .registry import get_config

CONFIG = get_config("gemma3-12b")
SMOKE = get_config("gemma3-12b-smoke")
