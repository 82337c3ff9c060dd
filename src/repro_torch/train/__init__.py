"""Serving steps (training comes with ROADMAP queue 1, item 14)."""
from .serve_step import make_decode_step, make_prefill_step

__all__ = ["make_decode_step", "make_prefill_step"]
