"""Channels-last tensor ops and the six hand-written CUDA kernels
(``swin_block``, ``swin_pair``, ``attn_ln``, ``ln_mlp``, ``cva``, ``vit3``) of
the serving path."""
