"""Operators of the port: the hand-written CUDA kernels' wrappers and the
build that compiles them (``_build.py``)."""
