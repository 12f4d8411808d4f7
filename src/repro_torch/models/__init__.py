"""Foundation backbones: the encoder, ssm (RWKV6) and hybrid (Mamba2 +
shared attention) families of ``repro/models``."""
