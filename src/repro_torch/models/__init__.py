"""Language-model substrate (port of ``repro.models``): every family of the
JAX registry (transformer, RWKV6, Zamba2 hybrid), on the card unless told
otherwise."""
