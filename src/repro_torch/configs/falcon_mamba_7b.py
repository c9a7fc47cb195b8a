"""Assigned architecture config: falcon-mamba-7b (see registry.py)."""
from .registry import get_config

CONFIG = get_config("falcon-mamba-7b")
SMOKE = get_config("falcon-mamba-7b-smoke")
