"""Serving runtime (port of ``repro.runtime``): the dense continuous
engine and its metrics registry."""
