"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

- ``fused_film_resblock.fused_ln_film_swish_dense`` (csrc/fused_film_resblock.cu)
- ``fused_attention.fused_ln_attention`` (csrc/fused_attention.cu)
- ``quant_matmul.w8a8_dense`` (csrc/quant_matmul.cu)
- ``flash_attention.flash_attention`` (csrc/flash_attention.cu), also
  behind ``flash_attention.packed_short_seq_attention``

``quant`` holds the int8 helpers around ``w8a8_dense``
(``quantize_weight``, and ``int8_dense``, plain PyTorch as the JAX
package's XLA path is).

Each wrapper launches its kernel on a CUDA tensor (or raises), takes its
plain version on a CPU tensor, and counts its launches in ``.launches``.
"""
