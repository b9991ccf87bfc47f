"""Optimizers and delta compression, counterpart of ``repro/optim``."""
