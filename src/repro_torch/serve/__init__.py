"""Serving (port of ``repro.serve``)."""

from .engine import ServeEngine, ServeStats
