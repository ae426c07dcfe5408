"""The benchmark's plain reference: the Mumpy flagship and the single-view Swin
baseline, their losses and the training recipe's SGD, in plain PyTorch.

It imports nothing of the measured program and takes nothing the program
made: the weights are drawn again from the seed (``weights.py``), the
drop-path keeps again from the seed's generator in the order the model
draws them, and the inputs are the benchmark's own.  It runs in float32 with
TF32 off (``context.f32_only``).  ``Ctx.rnd`` rounds the operands of every
matrix product: None is the reference itself, ``precision.fp8`` the control
that a lower precision must fail.
"""
