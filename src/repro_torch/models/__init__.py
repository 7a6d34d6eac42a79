"""The LM half's models (port of ``repro/models``) on one device: the
dense decoder-only transformer (with the VLM's image prefix and the MoE
FFN), Mamba2 with the Zamba2 hybrid, and the Whisper-style
encoder-decoder."""
