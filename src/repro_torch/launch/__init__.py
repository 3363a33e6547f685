"""Entry points and step builders (port of ``repro.launch``)."""
