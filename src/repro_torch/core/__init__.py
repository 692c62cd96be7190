"""Quantization scheme, integer ops, quantized-execution context."""
