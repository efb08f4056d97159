"""Probability densities: the stacked-parameter functional core.  The
host-side density classes are not ported yet."""

from . import core
