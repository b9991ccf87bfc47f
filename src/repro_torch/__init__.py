"""PyTorch/CUDA port of the parallel stochastic VQ engine in ``repro``.

The layout follows ``src/repro/`` module for module, so each file here names
its reference counterpart.  The port imports ``torch`` and never JAX or the
``repro`` package; its tests hold it against ``repro`` through numpy.

This slice covers the synchronous schemes (paper eq. 3 averaging and eq. 8
delta merging) on M workers stacked as a leading ``(M, ...)`` dimension of
one card, with the window and delta kernels written in CUDA C++ for
Hopper (``kernels/csrc``).
"""
