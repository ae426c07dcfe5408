"""Training entry point of the port, counterpart of ``train.py``; run as
``python -m mumpy_tpu_torch.train``.

DVI recipe (``scripts/train_davis.sh``; 6 clips x 2 inpainting streams = 12
per step, SGD):

    python -m mumpy_tpu_torch.train -model_name mumpy_davis -dataset davis \
        -batch_size 6 -max_epoch 50 -seq_dir .../vi -seq_dir2 .../cp -annot_dir ...

It trains on the first CUDA device, through the training kernels, unless
``-device cpu`` asks for the CPU (the kernels' plain versions); with
``-device cuda`` and no visible card it exits with an error.  The weights
start from the JAX package's initialisation drawn from ``-seed``
(``utils.weight_port.jax_init_state_dict``), which ``-pretrained`` (a
reference checkpoint) overlays by name, ``-resume`` (this run's latest or
``-epoch_resume`` checkpoint) or ``-transfer`` (another run's latest
weights, fresh optimizer) replaces.  Each best
checkpoint also writes ``<results_dir>/<model_name>/weights_torch.pt``, which
``python -m mumpy_tpu_torch.serve`` loads.
"""

from __future__ import annotations

import os
import sys

import torch

from ..configs import multiswin_config, tiny_config
from ..data import DataLoader, TrainClips
from ..models.mumpy import Mumpy
from ..utils.weight_port import jax_init_state_dict, load_pretrained
from . import checkpoint as ckpt_lib
from .args import build_configs, get_parser
from .optim import Optimizer
from .trainer import TrainState, train_loop


def main(argv=None) -> None:
    args = get_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("train: -device cuda needs a CUDA device and none is visible; "
                 "pass -device cpu to train on the CPU")
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    data_cfg, opt_cfg, loop_cfg = build_configs(args)
    model_cfg = tiny_config(args.imsize) if args.tiny else multiswin_config(args.imsize)

    datasets = {split: TrainClips(data_cfg, split) for split in ("train", "val")}
    loader_objs = {
        split: DataLoader(datasets[split], data_cfg.batch_size, shuffle=True, drop_last=True,
                          seed=data_cfg.seed + (split == "val"), normalize_on_host=False)
        for split in datasets}
    loaders = {split: (lambda s=split: iter(loader_objs[s])) for split in loader_objs}
    steps_per_epoch = max(1, len(datasets["train"]) // data_cfg.batch_size)
    iter_max = int(steps_per_epoch * loop_cfg.max_epoch / opt_cfg.accumulation_steps)

    model = Mumpy(model_cfg)
    model.load_state_dict(jax_init_state_dict(model, seed=loop_cfg.seed % 2**32))
    if args.pretrained:
        print(f"Warm start: {load_pretrained(model, args.pretrained)} tensors from "
              f"{args.pretrained}")
    model.to(device).train()
    state = TrainState(model, Optimizer(model.named_parameters(), opt_cfg, iter_max))
    if args.resume:
        model_dir = os.path.join(loop_cfg.results_dir, loop_cfg.model_name)
        restored = (ckpt_lib.load_epoch(model_dir, args.epoch_resume)
                    if args.epoch_resume >= 0 else ckpt_lib.load_latest(model_dir))
        if restored is not None:
            state.load_state_dict(restored)
            print(f"Resumed from {model_dir} (step {state.step})")
    elif args.transfer:
        src_dir = os.path.join(loop_cfg.results_dir, args.transfer_from)
        restored = ckpt_lib.load_latest(src_dir)
        if restored is None:
            raise FileNotFoundError(f"no checkpoint to transfer from in {src_dir}")
        model.load_state_dict(restored["model"])
        print(f"Transferred weights from {src_dir}")
    print(f"Training on {device} in {loop_cfg.compute_dtype}, "
          f"{data_cfg.batch_size} clips x {len(datasets['train'].stream_roots)} streams "
          "per step")
    train_loop(state, loaders, loop_cfg, max_steps_per_epoch=args.max_steps_per_epoch)


if __name__ == "__main__":
    main()
