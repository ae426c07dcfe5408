"""Channels-last tensor ops and the hand-written CUDA kernels: the six of
the serving path (``swin_block``, ``swin_pair``, ``attn_ln``, ``ln_mlp``,
``cva``, ``vit3``), the three of the training path (``swin_block_train``,
``attn_ln_train``, ``ln_mlp_train``) and ``window_attention``, the per-op
attention set's kernel, forward and backward."""
