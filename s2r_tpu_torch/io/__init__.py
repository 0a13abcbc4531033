"""Weight conversion, decoder-int8 quantization and serving."""
