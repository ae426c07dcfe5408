"""The frozen operation and byte formulas reproduce the bound of each site
kind that the port's bring-up recorded for the flagship and the baseline at
batch 32 (max(flops / 989 TFLOP/s, bytes / 3.35 TB/s) per instance, summed),
from the configuration's shapes alone."""

from __future__ import annotations

import json

import pytest

import tiny
import work

FLAGSHIP_MS = {"swin_pair": 2.404, "swin_block": 0.680, "vit3": 0.808, "ln_mlp": 0.439,
               "attn_ln": 0.279, "cva": 0.122}
FLAGSHIP_COUNTS = {"swin_pair": 18, "swin_block": 12, "vit3": 12, "ln_mlp": 12, "attn_ln": 12,
                   "cva": 8}


def _cfg(name):
    return json.loads((tiny.BENCH / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("kind", sorted(FLAGSHIP_MS))
def test_flagship_bound_per_site_kind(kind):
    bound = work.bound_by_kind("mumpy", _cfg("mumpy-flagship"), 32)
    assert round(bound[kind] * 1e3, 3) == FLAGSHIP_MS[kind]


def test_flagship_site_counts():
    assert work.count_by_kind("mumpy", _cfg("mumpy-flagship"), 32) == FLAGSHIP_COUNTS


def test_baseline_bound_and_count():
    cfg = _cfg("swin-baseline")
    assert round(work.bound_by_kind("swin_baseline", cfg, 32)["swin_block"] * 1e3, 3) == 0.977
    assert work.count_by_kind("swin_baseline", cfg, 32) == {"swin_block": 24}


def test_sites_scale_with_the_batch():
    cfg = _cfg("mumpy-flagship")
    one = sum(f for _, f, _ in work.sites("mumpy", cfg, 1))
    assert sum(f for _, f, _ in work.sites("mumpy", cfg, 32)) == 32 * one
