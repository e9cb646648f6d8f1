"""RFC 7932 format tables (copies of brotli_tpu.format modules)."""
