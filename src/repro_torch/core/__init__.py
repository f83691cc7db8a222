"""PreTTR core of the port: the split encoder/join and the compressor."""
