"""Inference entry point of the port: localisation masks for a test split.

Counterpart of ``test.py``; run as ``python -m mumpy_tpu_torch.serve``.  Serves
the model weights (``["model"]``) of the train CLI's checkpoint
``<results_dir>/<model_name>/ckpt_<e>.pt`` of epoch ``-test_epoch``, or with
the default -1 of the latest epoch, as ``test.py`` restores its checkpoints;
with no checkpoint it warns and serves the JAX package's initialisation drawn
from seed 0 (``utils.weight_port.jax_init_state_dict``), as ``test.py`` serves
``PRNGKey(0)``'s.  It reads the clips of split ``-eval_split`` (default
``test``) with the port's own :mod:`.data`, in this process, thresholds
sigmoid at 0.5 and writes ``{frame:04d}_instance_00.png`` (0/255) under
``<results_dir>/<model_name>/masks_<dataset>/<seq>/``, which ``measure.py``
scores unchanged.  Batches are padded to ``-batch_size`` at the tail.

It serves on the CUDA devices, through the hand-written kernels, unless
``-device cpu`` asks for the CPU (the kernels' plain versions, one device);
with ``-device cuda`` and no visible card it exits with an error.  As
``test.py`` does, it splits each batch over the largest count of the visible
cards that divides ``-batch_size`` (``parallel.serving_devices``; one replica
and one host thread per card, ``utils.serving.SplitForward``);
``CUDA_VISIBLE_DEVICES`` limits the cards.  ``-kernel_set``
picks the kernels: ``blocks`` (default, the JAX package's default set) or
``attention`` (its ``MUMPY_FUSED_BLOCK=off MUMPY_PALLAS=on``: op by op, only
the window-attention core through a kernel).
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
from .models.swin import KERNEL_SETS
from .parallel.dist import serving_devices
from .utils.serving import SplitForward, make_serving_forward
from .train import checkpoint as ckpt_lib
from .utils.weight_port import jax_init_state_dict


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
    p.add_argument("-test_epoch", default=-1, type=int,
                   help="the checkpoint epoch to serve (default: the latest)")
    p.add_argument("-eval_split", default="test",
                   help="the split whose clips are served (test, val, train, train-val)")
    p.add_argument("-batch_size", default=6, type=int)
    p.add_argument("-imsize", default=224, type=int)
    p.add_argument("-device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda: the visible GPUs, through the kernels (default); "
                        "cpu: the kernels' plain versions")
    p.add_argument("-kernel_set", default="blocks", choices=KERNEL_SETS,
                   help="blocks: the whole-block kernels (default); attention: op by op, "
                        "only the window-attention core through a kernel")
    p.add_argument("--tiny", action="store_true", help="the tiny debug architecture")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 parameters and activations (f32 accumulation)")
    return p


def load_model(cfg, model_dir: str, test_epoch: int = -1) -> Mumpy:
    """The model with the weights of checkpoint ``test_epoch`` of
    ``model_dir`` (-1: the latest), or with none there the JAX package's
    initialisation from seed 0."""
    model = Mumpy(cfg)
    state = (ckpt_lib.load_epoch(model_dir, test_epoch) if test_epoch >= 0
             else ckpt_lib.load_latest(model_dir))
    if state is not None:
        model.load_state_dict(state["model"])
        print(f"Loaded checkpoint of epoch {state['epoch']} from {model_dir}")
    else:
        print("WARNING: no checkpoint found; using random init")
        model.load_state_dict(jax_init_state_dict(model, seed=0))
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
    model = load_model(model_cfg, model_dir, args.test_epoch)
    bs = max(1, args.batch_size)
    if args.device == "cuda":  # as test.py:79-94 shards over its devices
        cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        devices = serving_devices(bs, cards)
        if len(devices) > 1:
            print(f"Serving data-parallel over {len(devices)} devices")
        elif len(cards) > 1:
            print(f"Serving on 1 of {len(cards)} devices "
                  f"(batch {bs} has no multi-device divisor)")
    else:
        devices = [torch.device("cpu")]
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    forward = make_serving_forward(model, devices, dtype, kernel_set=args.kernel_set)
    print(f"Serving on {', '.join(map(str, devices))} in {dtype}, kernel set {args.kernel_set}")

    out_root = os.path.join(model_dir, f"masks_{args.dataset}")
    from PIL import Image

    try:
        for batch in EvalClips(data_cfg, args.eval_split).batches(bs):
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
    finally:
        if isinstance(forward, SplitForward):
            forward.close()
    print(f"Masks written to {out_root}")


if __name__ == "__main__":
    main()
