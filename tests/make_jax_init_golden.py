"""Write ``tests/golden/jax_init_tiny32.json``: per-tensor statistics of the
JAX package's initialisation of ``tiny_config(32)``, keyed by the port's
state_dict names, for ``tests/test_torch_init.py``.

``mumpy_tpu``'s ``Mumpy.init`` (as ``create_train_state`` runs it) is
drawn with keys 0, 1, ...; each tensor is mapped to the port's layout by
``from_jax_params``.  For each parameter the file records whether key 0
gives exact zeros or ones, and otherwise the mean square and the largest
magnitude pooled over enough keys that every tensor has at least
``SAMPLES`` values, so that a small tensor's spread is known to ~2%.  The
reference does not change, so the file is written once and read by the test
with no JAX compile:

    JAX_PLATFORMS=cpu python tests/make_jax_init_golden.py
"""

import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

import mumpy_tpu.configs.model_config as jcfg
import mumpy_tpu_torch.configs as pcfg
from mumpy_tpu.models.mumpy import Mumpy
from mumpy_tpu_torch.utils.weight_port import from_jax_params

SIZE, SAMPLES = 32, 2000
OUT = Path(__file__).resolve().parent / "golden" / "jax_init_tiny32.json"


def main():
    init = jax.jit(Mumpy(jcfg.tiny_config(SIZE)).init)
    clip = jnp.zeros((1, 3, SIZE, SIZE, 3), jnp.float32)

    def draw(key):
        params = jax.device_get(init(jax.random.PRNGKey(key), clip)["params"])
        return {k: v.numpy().astype(np.float64)
                for k, v in from_jax_params(params, pcfg.tiny_config(SIZE)).items()
                if not k.endswith("relative_position_index")}

    first = draw(0)
    keys = {k: math.ceil(SAMPLES / v.size) if v.any() and not (v == 1).all() else 1
            for k, v in first.items()}
    sums = {k: [0.0, 0.0, 0] for k in first}
    for key in range(max(keys.values())):
        tensors = first if key == 0 else draw(key)
        for k, v in tensors.items():
            if key < keys[k]:
                s = sums[k]
                s[0] += float((v * v).sum())
                s[1] = max(s[1], float(np.abs(v).max()))
                s[2] += v.size
    out = {}
    for k, v in first.items():
        kind = "zeros" if not v.any() else "ones" if (v == 1).all() else "random"
        entry = {"shape": list(v.shape), "kind": kind}
        if kind == "random":
            sq, mx, n = sums[k]
            entry.update(rms=math.sqrt(sq / n), max_abs=mx, samples=n)
        out[k] = entry
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(out, indent=0, sort_keys=True) + "\n")
    print(f"{len(out)} tensors, {max(keys.values())} keys -> {OUT}")


if __name__ == "__main__":
    main()
