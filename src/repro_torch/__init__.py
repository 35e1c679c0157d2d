"""PyTorch/CUDA port of the columnar ADV feature pipeline.

Mirrors the module layout of the JAX package ``repro`` (the reference, which
this package never imports): the columnar host layer (``columnar``), ADVs and
the feature plan/executor and the analytics cycle (``core``), the
hand-written CUDA kernels (``kernels``), the serving pump (``serve``) and
the Wide&Deep model the features train (``models``). Entry points run on
``cuda`` unless the caller passes another device.
"""
