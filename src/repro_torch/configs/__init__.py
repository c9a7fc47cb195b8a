from .registry import ALL_ARCHS, get_config, list_configs, register
