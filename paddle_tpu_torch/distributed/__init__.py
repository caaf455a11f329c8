"""Distributed training (mirrors ``paddle_tpu/distributed``).

Only ``fleet.RecomputeOptimizer`` is ported: activation recompute runs on
one card. The collectives, the comms layer, the parameter server, the
launcher and the rest of fleet come with the multi-device slice (ROADMAP
A10).
"""
