"""Language-model substrate (port of ``repro.models``): the dense decoder
family's prefill and KV-cache decode, on the card unless told otherwise."""
