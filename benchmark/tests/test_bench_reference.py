"""The plain reference (benchmark/reference/) against the port's golden
ops (``Pipeline.apply``) byte for byte, on small seeded frames, for every
configuration's pipeline; and the control (the reference in bfloat16)
away from it."""

import glob
import json
import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path.insert(0, BENCH)
sys.path.insert(0, os.path.dirname(BENCH))

import check  # noqa: E402
from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline  # noqa: E402

CONFIGS = sorted(glob.glob(os.path.join(BENCH, "configs", "*.json")))
SHAPES = [(1, 1), (2, 3), (3, 3), (4, 5), (5, 7), (8, 8), (16, 33), (37, 53), (64, 31)]


def load(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def frame(cfg, h, w, seed):
    g = torch.Generator().manual_seed(seed)
    shape = (h, w) + ((cfg["channels"],) if cfg["channels"] > 1 else ())
    return torch.randint(0, 256, shape, generator=g, dtype=torch.uint8)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
@pytest.mark.parametrize("hw", SHAPES, ids=str)
def test_reference_equals_golden(path, hw):
    cfg = load(path)
    golden = Pipeline.parse(cfg["pipeline"]).apply
    ref = check.reference_fn(cfg["pipeline"])
    for seed in (0, 1, 2**33 + 7):
        x = frame(cfg, *hw, seed)
        want = golden(x)
        got = ref(x)
        assert got.shape == want.shape and got.dtype == want.dtype
        assert torch.equal(got, want), f"{cfg['name']} {hw} seed {seed}"


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_reference_extremes(path):
    """Saturated, flat and ramp frames: the clamps and the guard."""
    cfg = load(path)
    golden = Pipeline.parse(cfg["pipeline"]).apply
    ref = check.reference_fn(cfg["pipeline"])
    base = frame(cfg, 24, 40, 5)
    ramp = (torch.arange(base.numel()) % 256).to(torch.uint8).reshape(base.shape)
    for x in (torch.zeros_like(base), torch.full_like(base, 255), ramp, 255 - ramp):
        assert torch.equal(ref(x), golden(x))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_control_differs(path):
    """The control, the reference in bfloat16, gets many bytes wrong."""
    cfg = load(path)
    x = frame(cfg, 48, 64, 11)
    want = check.reference_fn(cfg["pipeline"])(x)
    low = check.reference_fn(cfg["pipeline"], torch.bfloat16)(x)
    assert low.shape == want.shape
    assert int((low != want).sum()) > want.numel() // 100


@pytest.mark.parametrize("name", ["emboss:5", "gaussian:3", "gaussian:7", "contrast:2.2"])
def test_other_sizes_of_the_ops(name):
    """The reference's ops at their other sizes and factors, for cells that
    later add them."""
    x = torch.randint(0, 256, (21, 34), generator=torch.Generator().manual_seed(3),
                      dtype=torch.uint8)
    assert torch.equal(check.reference_fn(name)(x), Pipeline.parse(name).apply(x))
