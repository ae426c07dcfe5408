"""The measured program's side of a run: the port's model built from a
configuration file, the benchmark's weights loaded into it, and the entries
the window drives.  Nothing of the reference is imported here."""

from __future__ import annotations

import torch


def port_config(cfg: dict):
    """The port's configuration dataclass for a file of ``configs/``."""
    if cfg["model"] == "mumpy":
        from mumpy_tpu_torch.configs import GlobalEncoderConfig, MumpyConfig, ViewConfig

        views = tuple(ViewConfig(hidden_size=tuple(v["hidden_size"]),
                                 patch_size=tuple(v["patch_size"]), depths=tuple(v["depths"]),
                                 num_heads=tuple(v["num_heads"]), mlp_dim=v["mlp_dim"],
                                 num_frames=v["num_frames"],
                                 input_resolution=tuple(tuple(r) for r in v["input_resolution"]),
                                 temporal_dim=v["temporal_dim"], window_size=v["window_size"])
                      for v in cfg["views"])
        rest = {k: (tuple(v) if isinstance(v, list) else v) for k, v in cfg.items()
                if k not in ("model", "source", "defined_at", "views", "global_encoder")}
        return MumpyConfig(views=views, global_encoder=GlobalEncoderConfig(**cfg["global_encoder"]),
                           **rest)
    if cfg["model"] == "swin_baseline":
        from mumpy_tpu_torch.models.baseline import BaselineConfig

        return BaselineConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                                 for k, v in cfg.items()
                                 if k not in ("model", "source", "defined_at")})
    raise ValueError(f"unknown model {cfg['model']!r}")


def build_model(cfg: dict, weights: dict, device) -> torch.nn.Module:
    """The port's model of ``cfg`` on ``device``, its parameters set to
    ``weights`` ({name: tensor}, every parameter; its dtype is kept).  The
    modules' own initialisation runs on the device and is overwritten."""
    pcfg = port_config(cfg)
    with torch.device(device):
        if cfg["model"] == "mumpy":
            from mumpy_tpu_torch.models.mumpy import Mumpy

            model = Mumpy(pcfg)
        else:
            from mumpy_tpu_torch.models.baseline import BaselineModel

            model = BaselineModel(pcfg)
    model.to(device)
    params = dict(model.named_parameters())
    missing = set(params) ^ set(weights)
    if missing:
        raise ValueError(f"weights and model differ in {sorted(missing)[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            w = weights[name]
            if tuple(w.shape) != tuple(p.shape):
                raise ValueError(f"{name}: weight {tuple(w.shape)} for parameter {tuple(p.shape)}")
            p.data = w.detach() if w.dtype == p.dtype else w.detach().to(p.dtype)
    return model


def serving_forward(model, device, dtype, kernel_set: str):
    """The serving entry the window drives: clip -> probabilities, on the
    hand-written kernels of ``kernel_set``."""
    from mumpy_tpu_torch.utils.serving import make_serving_forward

    return make_serving_forward(model, device, dtype, use_kernels=True, kernel_set=kernel_set)


def train_state(model, recipe: dict, kernel_set: str):
    """The port's training state (the model in train mode on the kernels of
    ``kernel_set``, f32 master parameters, the recipe's optimizer)."""
    from mumpy_tpu_torch.train.optim import OptimConfig, Optimizer
    from mumpy_tpu_torch.train.trainer import TrainState
    from mumpy_tpu_torch.utils.serving import set_kernel_path

    set_kernel_path(model, True, kernel_set)
    model.train()
    fields = {f: recipe[f] for f in ("lr", "lr_cnn", "lr_cva", "weight_decay",
                                     "weight_decay_cnn", "momentum", "min_lr", "poly_power")}
    cfg = OptimConfig(optim=recipe["optim"], optim_cnn=recipe["optim"], **fields)
    return TrainState(model, Optimizer(model.named_parameters(), cfg, iter_max=recipe["iter_max"]))


def train_step(state, batch: dict, generator, dtype) -> dict:
    """The training entry the window drives: one step of ``state`` on
    ``batch``; returns the loss (``total``, a device scalar) and the step's
    predictions (``preds``, sigmoid of the logits, (B, H, W))."""
    from mumpy_tpu_torch.train.trainer import train_step as step

    return step(state, batch, generator, compute_dtype=dtype)


def optimizer_gradients(state) -> dict:
    """{name: the decayed gradient as the optimizer took it}, read from its
    momentum trace after its first update."""
    return {n: b["trace"] for n, b in state.optimizer.buffers.items() if "trace" in b}


def parameters(state) -> dict:
    return dict(state.model.named_parameters())
