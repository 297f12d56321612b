"""PyTorch + CUDA port of the ``repro`` community-detection package.

Mirrors ``src/repro/`` module for module (``graph``, ``kernels``, ``core``,
``config``, ``utils``; ``models``, ``configs`` and ``launch`` for the LM
substrate) and imports neither JAX nor ``repro``.  Entry points run on the
CUDA device unless the caller passes ``device="cpu"``.  Every Pallas kernel
of the JAX package has a hand-written CUDA counterpart for Hopper in
``kernels/csrc``, each with a plain PyTorch version that CPU tensors use:
``local_move_plp``, ``local_move_louvain`` and their streamed twins,
``bin_rank`` (the community main path), ``label_argmax``, ``delta_q``,
``block_segment_sums`` (the scored tiles), and flash attention as two
kernels, ``flash_attention_fwd_wgmma`` for bf16 (tensor cores) and
``flash_attention_fwd`` for float32.
"""
