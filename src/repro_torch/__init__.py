"""PyTorch/CUDA port of the columnar ADV feature pipeline.

Mirrors the module layout of the JAX package ``repro`` (the reference, which
this package never imports): the columnar host layer (``columnar``), ADVs and
the feature plan/executor (``core``), the hand-written CUDA gather kernels
(``kernels``) and the serving pump (``serve``). Entry points run on
``cuda`` unless the caller passes another device.
"""
