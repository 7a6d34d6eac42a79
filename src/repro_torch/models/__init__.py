"""The LM half's models (port of ``repro/models``): the dense decoder-only
transformer on one device."""
