"""Assigned architecture config: llama4-scout-17b-a16e (see registry.py)."""
from .registry import get_config

CONFIG = get_config("llama4-scout-17b-a16e")
SMOKE = get_config("llama4-scout-17b-a16e-smoke")
