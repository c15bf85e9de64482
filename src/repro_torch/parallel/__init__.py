"""Logical-axis rules and parameter creation (port of ``repro.parallel``)."""
