"""Kernels of the port: hand-written for Hopper, plain versions in ``ref``."""
