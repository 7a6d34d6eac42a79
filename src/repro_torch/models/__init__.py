"""The LM half's models (port of ``repro/models``): the dense decoder-only
transformer (with the VLM's image prefix and the MoE FFN), on one device or
sharded over an LM mesh, and Mamba2 with the Zamba2 hybrid and the
Whisper-style encoder-decoder on one device (their sharded layout's specs
are in; their sharded execution is ROADMAP.md queue 1 item 13 part 5b)."""
