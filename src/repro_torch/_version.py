"""Repro package version (the port's own copy of ``repro._version``).

Bumped whenever the INIT-artifact layout changes in a way the planstore
schema_version does not capture (e.g. a bake algorithm change that keeps
shapes but alters table contents).  The plan store keys every entry on this
value, so stale artifacts from an older build are never warm-loaded.
"""

__version__ = "0.3.0"
