"""Model code of the port: layers, the encoder and the backend registry."""
