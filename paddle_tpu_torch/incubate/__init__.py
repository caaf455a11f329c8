"""Incubating APIs of the port (mirrors ``paddle_tpu/incubate``)."""
