"""Training entry point of the port, counterpart of ``train.py``; run as
``python -m mumpy_tpu_torch.train``.

DVI recipe (``scripts/train_davis.sh``; 6 clips x 2 inpainting streams = 12
per step, SGD):

    python -m mumpy_tpu_torch.train -model_name mumpy_davis -dataset davis \
        -batch_size 6 -max_epoch 50 -seq_dir .../vi -seq_dir2 .../cp -annot_dir ...

One process trains on the first CUDA device, through the training kernels, unless
``-device cpu`` asks for the CPU (the kernels' plain versions); with
``-device cuda`` and no visible card it exits with an error.  ``-kernel_set``
picks the kernels, ``blocks`` (default) or ``attention`` (see
``utils/serving.py``), for the training steps and the val passes.  The weights
start from the JAX package's initialisation drawn from ``-seed``
(``utils.weight_port.jax_init_state_dict``), which ``-pretrained`` (a
reference checkpoint) overlays by name, ``-resume`` (this run's latest or
``-epoch_resume`` checkpoint) or ``-transfer`` (another run's latest
weights, fresh optimizer) replaces.  ``python -m mumpy_tpu_torch.serve``
serves the checkpoints it writes, ``<results_dir>/<model_name>/ckpt_<e>.pt``:
the latest, or one by ``-test_epoch``.  ``-num_workers`` (default 4, as the
JAX package's) worker processes assemble the batches; the batches do not
depend on it.

Data parallel under ``torchrun`` (``WORLD_SIZE`` set), as the JAX package
shards its step over a data mesh:

    torchrun --nproc_per_node=N -m mumpy_tpu_torch.train ...

Each rank takes ``cuda:LOCAL_RANK`` with NCCL (``-device cpu``: the CPU with
gloo), builds the same seeded initialisation, receives rank 0's state after
``-pretrained``, ``-resume`` or ``-transfer``, and steps on its rows of each
global batch of ``-batch_size`` clips x the streams (N must divide that row
count), its loader assembling only those rows; see ``trainer.py``.
Without ``torchrun`` it is a one-process run.
"""

from __future__ import annotations

import os
import sys

import torch

from ..configs import multiswin_config, tiny_config
from ..data import DataLoader, TrainClips
from ..models.mumpy import Mumpy
from ..parallel.dist import init_from_env
from ..utils.serving import set_kernel_path
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
    dist = init_from_env(args.device)
    device = dist.device
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    data_cfg, opt_cfg, loop_cfg = build_configs(args)
    model_cfg = tiny_config(args.imsize) if args.tiny else multiswin_config(args.imsize)

    datasets = {split: TrainClips(data_cfg, split) for split in ("train", "val")}
    loader_objs = {
        split: DataLoader(datasets[split], data_cfg.batch_size, shuffle=True, drop_last=True,
                          seed=data_cfg.seed + (split == "val"), normalize_on_host=False,
                          num_workers=args.num_workers, rank=dist.rank, world=dist.world)
        for split in datasets}
    loaders = {split: (lambda s=split: iter(loader_objs[s])) for split in loader_objs}
    steps_per_epoch = max(1, len(datasets["train"]) // data_cfg.batch_size)
    iter_max = int(steps_per_epoch * loop_cfg.max_epoch / opt_cfg.accumulation_steps)

    say = print if dist.is_main else (lambda *a, **kw: None)
    model = Mumpy(model_cfg)
    model.load_state_dict(jax_init_state_dict(model, seed=loop_cfg.seed % 2**32))
    if args.pretrained:
        say(f"Warm start: {load_pretrained(model, args.pretrained)} tensors from "
            f"{args.pretrained}")
    set_kernel_path(model, True, args.kernel_set)
    model.to(device).train()
    state = TrainState(model, Optimizer(model.named_parameters(), opt_cfg, iter_max),
                       dist=dist)
    if args.resume:
        model_dir = os.path.join(loop_cfg.results_dir, loop_cfg.model_name)
        restored = (ckpt_lib.load_epoch(model_dir, args.epoch_resume)
                    if args.epoch_resume >= 0 else ckpt_lib.load_latest(model_dir))
        if restored is not None:
            state.load_state_dict(restored)
            say(f"Resumed from {model_dir} (step {state.step})")
    elif args.transfer:
        src_dir = os.path.join(loop_cfg.results_dir, args.transfer_from)
        restored = ckpt_lib.load_latest(src_dir)
        if restored is None:
            raise FileNotFoundError(f"no checkpoint to transfer from in {src_dir}")
        model.load_state_dict(restored["model"])
        say(f"Transferred weights from {src_dir}")
    if args.pretrained or args.resume or args.transfer:
        state.broadcast()  # every rank starts from rank 0's state
    ranks = f" on each of {dist.world} ranks" if dist.grouped else ""
    say(f"Training on {device}{ranks} in {loop_cfg.compute_dtype}, "
        f"{data_cfg.batch_size} clips x {len(datasets['train'].stream_roots)} streams "
        f"per step, kernel set {args.kernel_set}")
    try:
        train_loop(state, loaders, loop_cfg, max_steps_per_epoch=args.max_steps_per_epoch)
    finally:
        for loader in loader_objs.values():
            loader.close()


if __name__ == "__main__":
    try:
        main()
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
