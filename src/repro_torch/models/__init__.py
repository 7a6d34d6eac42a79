"""The LM half's models (port of ``repro/models``) on one device: the
dense decoder-only transformer, and Mamba2 with the Zamba2 hybrid."""
