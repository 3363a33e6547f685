"""Bit-serial medians, the clustering engine and the serving memory
manager built on them (port of ``repro.core``)."""
