"""Measurement scripts and helpers for the port's CUDA kernels."""
