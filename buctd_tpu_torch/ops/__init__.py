"""Device ops of the port: crop/resize, condition renders, decode, and the
flash-attention kernel wrapper."""
