"""The port's configurations and state_dict names against the JAX package.

* ``mumpy_tpu_torch/configs.py`` holds ``configs/model_config.py``'s values,
  field by field.
* The port's encoder / decoder state_dicts have exactly the reference's keys
  and shapes (``build_reference_state_dicts``), so
  ``mumpy_tpu/utils/weight_port.py:port_state_dicts`` maps the port's weights
  onto the JAX model with nothing missing or left over.  The stage-2 pairs and
  the time-major ViT change how blocks execute, not how they are named.
"""

import dataclasses

import pytest

import mumpy_tpu.configs.model_config as jcfg
import mumpy_tpu_torch.configs as pcfg
from mumpy_tpu_torch.models.mumpy import Mumpy
from tests.test_weight_port import build_reference_state_dicts
from torch_cases import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("name", ["multiswin_config", "tiny_config"])
def test_port_config_matches_jax_config(name):
    """The port's configuration holds the JAX package's values, field by field,
    for every field the port has; the derived shapes agree too."""
    ours, ref = getattr(pcfg, name)(), getattr(jcfg, name)()
    for f in dataclasses.fields(ours):
        if f.name == "views":
            for v_ours, v_ref in zip(ours.views, ref.views, strict=True):
                for vf in dataclasses.fields(v_ours):
                    assert getattr(v_ours, vf.name) == getattr(v_ref, vf.name), vf.name
        elif f.name == "global_encoder":
            assert dataclasses.asdict(ours.global_encoder) == \
                dataclasses.asdict(ref.global_encoder)
        else:
            assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    for prop in ("stage_shapes", "merged_channels", "encoder_out_channels"):
        assert getattr(ours, prop) == getattr(ref, prop), prop


@pytest.mark.parametrize("size", [32, 128])  # 32: stage 3 clamps the window to 1
def test_state_dict_keys_match_reference(size):
    enc, dec = build_reference_state_dicts(jcfg.tiny_config(size))
    model = Mumpy(pcfg.tiny_config(size))
    for ours, ref in ((model.encoder.state_dict(), enc), (model.decoder.state_dict(), dec)):
        assert {k: tuple(v.shape) for k, v in ours.items()} == \
               {k: tuple(v.shape) for k, v in ref.items()}
