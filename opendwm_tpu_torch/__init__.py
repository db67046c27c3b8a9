"""PyTorch + CUDA port of opendwm_tpu for NVIDIA Hopper GPUs.

Mirrors the JAX package's module names (``ops/``, ``models/``,
``schedulers/``, ``pipelines/``); ``config`` resolves the same JSON
configs to the port's classes. Imports ``torch``, never JAX.
"""
