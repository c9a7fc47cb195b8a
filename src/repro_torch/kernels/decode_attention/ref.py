"""Plain torch version of flash-decode: re-exports the decode reference."""
from ..flash_attention.ref import decode_ref  # noqa: F401
