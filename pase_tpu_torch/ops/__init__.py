"""Tensor ops of the port: padding, sinc filters, QRNN pooling (plain and
the CUDA kernel's wrapper)."""
