from .css_decode_sim import css_decode_sim

__all__ = ["css_decode_sim"]
