"""The train CLI's flags and configurations, counterpart of
``mumpy_tpu/configs/args.py`` (which imports JAX through the JAX package's
optimizer and trainer, so the port keeps its own).  Flags keep the
reference's single-dash spelling; defaults follow the published DVI recipe
(``scripts/train_davis.sh``)."""

from __future__ import annotations

import argparse

from ..data import davis_config, youtubevos_config
from .optim import OptimConfig
from .trainer import TrainLoopConfig

__all__ = ["get_parser", "build_configs"]


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Mumpy training (PyTorch port)")
    # data
    p.add_argument("-dataset", default="davis", choices=["davis", "youtubevos"])
    p.add_argument("-length_clip", default=3, type=int)
    p.add_argument("-batch_size", default=6, type=int)
    p.add_argument("-year", default="2016", help="DAVIS: leave out sequences newer than this")
    p.add_argument("-db_info", default=None,
                   help="yaml of the sequences of each split (default: every sub-directory "
                        "of -seq_dir, for every split)")
    p.add_argument("-imsize", default=224, type=int)
    p.add_argument("--augment", dest="augment", action="store_true", default=True)
    p.add_argument("--no-augment", dest="augment", action="store_false")
    p.add_argument("--singleAugment", dest="single_augment", action="store_true", default=True)
    p.add_argument("-seq_dir", default=None, help="primary inpainting-stream root")
    p.add_argument("-seq_dir2", default=None)
    p.add_argument("-seq_dir3", default=None)
    p.add_argument("-annot_dir", default=None)
    # optimization
    p.add_argument("-lr", default=1e-2, type=float)
    p.add_argument("-lr_cnn", default=1e-3, type=float)
    p.add_argument("-lr_cva", default=1e-2, type=float)
    p.add_argument("-optim", default="sgd", choices=["adam", "sgd", "rmsprop"])
    p.add_argument("-optim_cnn", default="sgd", choices=["adam", "sgd", "rmsprop"])
    p.add_argument("-weight_decay", default=1e-4, type=float)
    p.add_argument("-weight_decay_cnn", default=1e-4, type=float)
    p.add_argument("-momentum", default=0.9, type=float)
    p.add_argument("-accumulation_steps", default=1, type=int)
    p.add_argument("-max_epoch", default=100, type=int)
    p.add_argument("-patience", default=15, type=int)
    p.add_argument("-min_delta", default=0.0, type=float)
    p.add_argument("-best_val_loss", default=1000.0, type=float)
    p.add_argument("-seed", default=282845927, type=int)
    p.add_argument("-print_every", default=10, type=int)
    # run management
    p.add_argument("-model_name", default="mumpy")
    p.add_argument("-results_dir", default="results")
    p.add_argument("--resume", "-resume", dest="resume", action="store_true")
    p.add_argument("-epoch_resume", default=-1, type=int)
    p.add_argument("--transfer", "-transfer", dest="transfer", action="store_true",
                   help="warm-start the weights from another run, fresh optimizer")
    p.add_argument("-transfer_from", default="model")
    p.add_argument("--smooth_curves", dest="smooth_curves", action="store_true", default=True)
    p.add_argument("-finetune_after", default=0, type=int,
                   help="-1 disables the patience-triggered best-checkpoint reload")
    p.add_argument("-max_steps_per_epoch", default=None, type=int)
    p.add_argument("--tiny", action="store_true", help="the tiny debug architecture")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 forward and backward, f32 master parameters")
    p.add_argument("-pretrained", default=None,
                   help="torch checkpoint of the reference to warm-start from (by name)")
    p.add_argument("-device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda: the first GPU, through the kernels (default); "
                        "cpu: the kernels' plain versions")
    return p


def build_configs(args: argparse.Namespace):
    base = davis_config if args.dataset == "davis" else youtubevos_config
    overrides = dict(length_clip=args.length_clip, batch_size=args.batch_size,
                     augment=args.augment, single_augment=args.single_augment,
                     year=args.year, input_res=(args.imsize, args.imsize), seed=args.seed,
                     sequences2=args.seq_dir2, sequences3=args.seq_dir3, db_info=args.db_info)
    if args.seq_dir:
        overrides["sequences"] = args.seq_dir
    if args.annot_dir:
        overrides["annotations"] = args.annot_dir
    data_cfg = base(**overrides)
    opt_cfg = OptimConfig(
        optim=args.optim, optim_cnn=args.optim_cnn, lr=args.lr, lr_cnn=args.lr_cnn,
        lr_cva=args.lr_cva, weight_decay=args.weight_decay,
        weight_decay_cnn=args.weight_decay_cnn, momentum=args.momentum,
        accumulation_steps=args.accumulation_steps)
    loop_cfg = TrainLoopConfig(
        model_name=args.model_name, results_dir=args.results_dir, max_epoch=args.max_epoch,
        accumulation_steps=args.accumulation_steps, patience=args.patience,
        min_delta=args.min_delta, best_val_loss=args.best_val_loss,
        print_every=args.print_every, smooth_curves=args.smooth_curves,
        patience_reload=args.finetune_after != -1,
        compute_dtype="bf16" if args.bf16 else "f32", seed=args.seed)
    return data_cfg, opt_cfg, loop_cfg
