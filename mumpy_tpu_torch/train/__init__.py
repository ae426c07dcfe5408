"""Training path of the port: losses, optimizer, checkpoints, trainer and
the ``python -m mumpy_tpu_torch.train`` entry point (counterparts of
``mumpy_tpu/train/`` and ``train.py``)."""
