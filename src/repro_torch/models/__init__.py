"""The LM half's models (port of ``repro/models``): the dense decoder-only
transformer (with the VLM's image prefix and the MoE FFN), Mamba2 with the
Zamba2 hybrid and the Whisper-style encoder-decoder, each on one device or
sharded over an LM mesh, training and decode."""
