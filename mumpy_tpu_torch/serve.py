"""Inference entry point of the port: localisation masks for a test split.

Counterpart of ``test.py``; run as ``python -m mumpy_tpu_torch.serve``.  Loads
``<results_dir>/<model_name>/weights_torch.pt`` (a state_dict of
:class:`.models.mumpy.Mumpy`) when present, else warns and serves seeded
random weights; thresholds sigmoid at 0.5 and writes
``{frame:04d}_instance_00.png`` (0/255) under
``<results_dir>/<model_name>/masks_<dataset>/<seq>/``, which ``measure.py``
scores unchanged.  Batches are padded to ``-batch_size`` at the tail.  The
clips are read by the port's own :mod:`.data`, in this process.

It serves on the first CUDA device, through the hand-written kernels, unless
``-device cpu`` asks for the CPU (the kernels' plain versions); with
``-device cuda`` and no visible card it exits with an error.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from .configs import multiswin_config, tiny_config
from .data import EvalClips, davis_config, youtubevos_config
from .models.mumpy import Mumpy
from .utils.serving import make_serving_forward
from .utils.weight_port import random_state_dict

CHECKPOINT = "weights_torch.pt"


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Mumpy serving (PyTorch port)")
    p.add_argument("-model_name", default="mumpy")
    p.add_argument("-dataset", default="davis", choices=["davis", "youtubevos"])
    p.add_argument("-seq_dir", default=None, help="inpainted-frame root (one stream)")
    p.add_argument("-db_info", default=None,
                   help="yaml of the sequences of each split; the test split reads its "
                        "val set (default: every sub-directory of -seq_dir)")
    p.add_argument("-year", default="2016", help="DAVIS: leave out sequences newer than this")
    p.add_argument("-results_dir", default="results")
    p.add_argument("-batch_size", default=6, type=int)
    p.add_argument("-imsize", default=224, type=int)
    p.add_argument("-device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda: the first GPU, through the kernels (default); "
                        "cpu: the kernels' plain versions")
    p.add_argument("--tiny", action="store_true", help="the tiny debug architecture")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 parameters and activations (f32 accumulation)")
    return p


def load_model(cfg, model_dir: str) -> Mumpy:
    model = Mumpy(cfg)
    path = os.path.join(model_dir, CHECKPOINT)
    if os.path.exists(path):
        model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
        print(f"Loaded checkpoint from {path}")
    else:
        print("WARNING: no checkpoint found; using random init")
        model.load_state_dict(random_state_dict(model, seed=0))
    return model


def main(argv=None) -> None:
    args = get_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("serve: -device cuda needs a CUDA device and none is visible; "
                 "pass -device cpu to serve on the CPU")

    model_cfg = tiny_config(args.imsize) if args.tiny else multiswin_config(args.imsize)
    base = davis_config if args.dataset == "davis" else youtubevos_config
    overrides = dict(input_res=(args.imsize, args.imsize), db_info=args.db_info,
                     year=args.year)
    if args.seq_dir:
        overrides["sequences"] = args.seq_dir
    data_cfg = base(**overrides)

    model_dir = os.path.join(args.results_dir, args.model_name)
    model = load_model(model_cfg, model_dir)
    device = torch.device(args.device)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    forward = make_serving_forward(model, device, dtype)
    print(f"Serving on {device} in {dtype}")

    bs = max(1, args.batch_size)
    out_root = os.path.join(model_dir, f"masks_{args.dataset}")
    from PIL import Image

    for batch in EvalClips(data_cfg).batches(bs):
        imgs = batch["image"]
        n = imgs.shape[0]
        if n < bs:  # pad the tail batch: every call sees the serving batch shape
            imgs = np.concatenate([imgs, np.repeat(imgs[-1:], bs - n, axis=0)], axis=0)
        probs = forward(torch.from_numpy(imgs)).cpu().numpy()  # (bs, H, W, 1)
        for i in range(n):
            mask = (probs[i, :, :, 0] > 0.5).astype(np.uint8) * 255
            seq_dir = os.path.join(out_root, batch["seq_name"][i])
            os.makedirs(seq_dir, exist_ok=True)
            Image.fromarray(mask).save(
                os.path.join(seq_dir, f"{batch['starting_frame'][i]:04d}_instance_00.png"))
    print(f"Masks written to {out_root}")


if __name__ == "__main__":
    main()
