"""Roofline model of the port (port of ``repro.roofline``): the card's
constants (``hw``), the terms of a step (``analyze``) and the counter that
reads a step's work while it is traced (``trace``)."""
