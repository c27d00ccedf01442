"""Dense decoder model: config mirror, layers, transformer, registry."""
