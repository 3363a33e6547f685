"""Checkpoints (port of ``repro.checkpoint``)."""
