"""Model code for the decoder-only, all-'G' GQA serving path (port of
``repro.models``)."""
