"""Decoders (counterpart of brotli_tpu.dec): the device decoder."""
