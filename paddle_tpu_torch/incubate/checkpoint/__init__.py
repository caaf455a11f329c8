"""Epoch-loop auto-checkpoint (mirrors ``paddle_tpu/incubate/checkpoint``)."""
