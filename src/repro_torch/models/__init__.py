"""Foundation backbone: the encoder family of ``repro/models``."""
