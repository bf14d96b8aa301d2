"""Model code of the port: layers, attention, the decoder stack, the registry."""
