"""Assigned architecture config: deepseek-v2-236b (see registry.py)."""
from .registry import get_config

CONFIG = get_config("deepseek-v2-236b")
SMOKE = get_config("deepseek-v2-236b-smoke")
